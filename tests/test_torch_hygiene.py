"""Import and fallback hygiene of the PyTorch/CUDA port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import nothing of JAX
or of the JAX package, call no library attention (``chip_smoke.py`` times
one call as its yardstick, in ``library_ms`` only) and no
``torch.compile``, and never fall back: on a host with no CUDA the entry
points raise unless asked for the CPU, the kernel wrappers (flash,
chunked, SSD) raise on any tensor they cannot launch on instead of running
the plain version, and the serving engine's captured step raises instead
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


def test_kernel_path_has_no_try_fallback():
    """No ``try`` in the kernel wrappers, nor in the serving engine, whose
    CUDA graph capture and replay raise on failure instead of dropping back
    to the eager step."""
    paths = sorted((PORT / "kernels").rglob("*.py")) + sorted(
        (PORT / "serve").rglob("*.py"))
    assert PORT / "serve" / "graph.py" in paths
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


def test_kernel_wrapper_raises_instead_of_falling_back():
    """Tensors that are not all on the CPU never reach the plain version:
    the wrapper launches the kernel or raises, and counts no launch."""
    _needs_no_cuda()
    before = fa.launches
    q = torch.empty(1, 2, 8, 32, device="meta")
    k = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, k)
    cpu = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(cpu, k, k)
    assert fa.launches == before


@pytest.mark.parametrize("wrapper", [fa.flash_attention_cuda,
                                     chunked.chunked_attention_cuda],
                         ids=["flash", "chunked"])
def test_attention_wrappers_raise_instead_of_falling_back(wrapper):
    """Both attention wrappers, on meta tensors and on a CPU/meta mix, at
    zamba2's head dim: a raise, no launch, no plain version."""
    _needs_no_cuda()
    module = fa if wrapper is fa.flash_attention_cuda else chunked
    before = module.launches
    k = torch.empty(1, 2, 8, 112, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(k, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(torch.zeros(1, 2, 8, 112), k, k)
    assert module.launches == before


def test_ssd_wrapper_raises_instead_of_falling_back():
    _needs_no_cuda()
    before = sk.launches
    b, l, h, p, n = 1, 8, 2, 16, 8
    meta = dict(device="meta")
    args = [torch.empty(b, l, h, p, **meta), torch.empty(b, l, h, **meta),
            torch.empty(h, **meta), torch.empty(b, l, n, **meta),
            torch.empty(b, l, n, **meta)]
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_cuda(*args)
    args[2] = torch.zeros(h)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_cuda(*args)
    assert sk.launches == before


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
