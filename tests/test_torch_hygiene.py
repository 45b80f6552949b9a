"""Import and fallback hygiene of the PyTorch/CUDA port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import nothing of JAX
or of the JAX package, call no library attention (``chip_smoke.py`` times
one call as its yardstick, in ``library_ms`` only) and no
``torch.compile``, open a profiler range only through
``obs.profiler_range`` (so an untraced run opens none), and never fall
back: on a host with no CUDA the entry
points raise unless asked for the CPU, the kernel wrappers (flash,
chunked, SSD, the fused pointwise ops) raise on any tensor they cannot
launch on instead of running the plain version, and the serving engine's captured step raises instead
of running eagerly."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.pointwise import kernel as pw  # noqa: E402
from repro_torch.kernels.ssd_scan import decode as sd  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
FILES = sorted(PORT.rglob("*.py")) + [SMOKE]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, name)


def test_no_library_attention_or_compile():
    for path in FILES:
        tree = ast.parse(path.read_text(), str(path))
        attrs = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)]
        assert not any(n.attr == "compile" and isinstance(n.value, ast.Name)
                       and n.value.id == "torch" for n in attrs), path
        if path != SMOKE:
            assert "scaled_dot_product_attention" not in path.read_text(), path
    # the smoke's one yardstick call, inside library_ms and nowhere else
    tree = ast.parse(SMOKE.read_text())
    uses = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
            for n in ast.walk(fn) if isinstance(n, ast.Attribute)
            and n.attr == "scaled_dot_product_attention"]
    assert uses == ["library_ms"]
    assert SMOKE.read_text().count("scaled_dot_product_attention") == 2


def test_profiler_ranges_only_through_the_helper():
    """Outside ``obs/ranges.py`` no file of the port calls
    ``record_function``."""
    helper = PORT / "obs" / "ranges.py"
    for path in sorted(PORT.rglob("*.py")):
        if path == helper:
            continue
        tree = ast.parse(path.read_text(), str(path))
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and "record_function" in (getattr(n.func, "attr", None),
                                           getattr(n.func, "id", None))]
        assert not calls, path
    assert "record_function(" in helper.read_text()


def test_prefill_opens_attention_ranges_only_under_a_profiler(monkeypatch):
    """A prefill opens one ``attention`` range per layer while a profiler
    records, and none otherwise: ``record_function`` is never called."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_smoke_config("stablelm-3b")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = {"tokens": torch.zeros(1, 8, dtype=torch.int32)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.forward(params, tokens)
    names = [e.name for e in prof.events()]
    assert names.count("attention") == cfg.n_layers

    def refuse(name):
        raise AssertionError(f"range {name!r} opened outside a trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model.forward(params, tokens)


def test_moe_parts_open_ranges_only_under_a_profiler(monkeypatch):
    """``moe_local``'s three parts are ranges while a profiler records
    (``chip_smoke.py``'s ``moe_parts_ms`` times them), and none otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig

    cfg = MoEConfig(8, 2, 16, capacity_factor=1.25)
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(*shape, generator=gen) for k, shape in (
        ("router", (32, 8)), ("w_gate", (8, 32, 16)),
        ("w_up", (8, 32, 16)), ("w_down", (8, 16, 32)))}
    x = torch.randn(12, 32, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.moe_local(x, p, cfg)
    names = [e.name for e in prof.events() if e.name.startswith("moe/")]
    assert sorted(names) == ["moe/combine", "moe/experts",
                             "moe/route_dispatch"]

    def refuse(name):
        raise AssertionError(f"range {name!r} opened outside a trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    moe.moe_local(x, p, cfg)


def test_profiler_flag_is_process_wide():
    """``profiler_range`` reads torch's private, process-wide
    ``torch.autograd.profiler._is_profiler_enabled``: it has to exist, be
    False outside a profiler and True inside one, in the thread that
    started the profiler and in any other."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    import torch.autograd.profiler as tap

    assert tap._is_profiler_enabled is False
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        seen.append(tap._is_profiler_enabled)
        worker = threading.Thread(
            target=lambda: seen.append(tap._is_profiler_enabled))
        worker.start()
        worker.join()
    assert seen == [True, True]
    assert tap._is_profiler_enabled is False


def test_kernel_path_has_no_try_fallback():
    """No ``try`` in the kernel wrappers, nor in the serving engine, whose
    CUDA graph capture and replay raise on failure instead of dropping back
    to the eager step."""
    paths = sorted((PORT / "kernels").rglob("*.py")) + sorted(
        (PORT / "serve").rglob("*.py"))
    assert PORT / "serve" / "graph.py" in paths
    # the autograd Functions every wrapper goes through under autograd
    assert PORT / "kernels" / "autograd.py" in paths
    for path in paths:
        tree = ast.parse(path.read_text(), str(path))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")


def test_entry_points_raise_without_cuda():
    _needs_no_cuda()
    cfg = get_smoke_config("stablelm-3b")
    model = Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build.extension()
    assert model.init(0, device="cpu")["embed"].device.type == "cpu"
    # training: the state, the step and the driver
    from repro_torch.launch import train as launch_train
    from repro_torch.train import (
        TrainConfig, init_train_state, make_train_step)
    tcfg = TrainConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(model, 0, tcfg)
    state = init_train_state(model, 0, tcfg, device="cpu")
    step = make_train_step(model, tcfg)
    meta = {"tokens": torch.zeros(1, 4, dtype=torch.int32, device="meta"),
            "labels": torch.zeros(1, 4, dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="move the batch"):
        step(state, meta)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])


# each wrapper with its arguments' shapes and its key in ``build.launches``:
# the flash wrapper at head dim 32, both attention wrappers at zamba2's
# head dim, the SSD scan and the decode update at the smoke widths, the
# fused pointwise wrappers at phi3's widths
WRAPPER_CASES = {
    "flash_d32": (fa.flash_attention_cuda, [(1, 2, 8, 32)] * 3,
                  "flash_attention"),
    "flash": (fa.flash_attention_cuda, [(1, 2, 8, 112)] * 3,
              "flash_attention"),
    "chunked": (chunked.chunked_attention_cuda, [(1, 2, 8, 112)] * 3,
                "chunked_attention"),
    "ssd_scan": (sk.ssd_cuda, [(1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 8),
                               (1, 8, 8)], "ssd_scan"),
    "ssd_decode": (sd.ssd_decode_update, [(1, 2, 16, 16), (1, 2, 16),
                                          (1, 2), (2,), (1, 16), (1, 16)],
                   "ssd_decode"),
    "rms_norm": (pw.rms_norm_cuda, [(1, 8, 5120), (5120,)], "rms_norm"),
    "add_rms_norm": (pw.add_rms_norm_cuda,
                     [(1, 8, 5120), (1, 8, 5120), (5120,)], "add_rms_norm"),
    "rope_qk": (pw.rope_qk_cuda, [(1, 8, 40, 128), (1, 8, 10, 128),
                                  (8, 64), (8, 64)], "rope_qk"),
    "swiglu_gate": (pw.swiglu_gate_cuda, [(1, 8, 17920)] * 2,
                    "swiglu_gate"),
}


@pytest.mark.parametrize("name", list(WRAPPER_CASES))
def test_attention_wrappers_raise_instead_of_falling_back(name):
    """Every kernel wrapper, on meta tensors and on a CPU/meta mix:
    tensors that are not all on the CPU never reach the plain version; the
    wrapper raises and counts no launch."""
    _needs_no_cuda()
    wrapper, shapes, key = WRAPPER_CASES[name]
    before = build.launches[key]
    meta = [torch.empty(*s, device="meta") for s in shapes]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(torch.zeros(shapes[0]), *meta[1:])
    assert build.launches[key] == before


def test_process_executor_raises_once_cuda_is_initialised(monkeypatch):
    """The pipeline runtime's process executor forks its workers, and a
    child forked after CUDA was initialised cannot use it: the runtime
    raises instead of quietly running its stages on threads."""
    from repro_torch.pipeline import StageSpec, StreamingPipelineRuntime

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="executor='thread'"):
        StreamingPipelineRuntime([StageSpec("s", lambda x: x)],
                                 executor="process")
    rt = StreamingPipelineRuntime([StageSpec("s", lambda x: x + 1)])
    assert rt.executor == "thread"
    rt.start()
    assert rt.run([1, 2])["outputs"] == [2, 3] and rt._threads
    rt.stop()
