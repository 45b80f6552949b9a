"""The port's sharding rules against ``repro``'s, with no devices and no
process group: every spec of every param, train-state (fsdp on / off,
adamw / adamw8), grad-accumulator, cache and batch leaf of all ten configs
on both production meshes, the decode cells' rule overrides, and the
dry-run's shape table. The reference computes its specs on a
``jax.sharding.AbstractMesh``, the port from the mesh's shape alone."""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import config as j_config  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.sharding import use_ctx as j_use_ctx  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.models.transformer import Model as TModel  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding import use_ctx as t_use_ctx  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402
from repro_torch.train.optimizer import OptConfig as TOpt  # noqa: E402

ARCHS = j_config.list_archs()
MESHES = {"pod16x16": False, "pod2x16x16": True}


def _meshes(multi_pod):
    shape = t_mesh.production_shape(multi_pod)
    return (AbstractMesh(tuple(shape.values()), tuple(shape)),
            types.SimpleNamespace(shape=shape))


def _specs(ctx, shapes, axes, path=""):
    """{path: spec} over a tree of shaped leaves and its axes tree, walked
    by key (the reference's abstract trees come back key-sorted)."""
    if isinstance(axes, dict):
        out = {}
        for k in axes:
            out.update(_specs(ctx, shapes[k], axes[k], f"{path}/{k}"))
        return out
    return {path: tuple(ctx.spec(axes, tuple(shapes.shape)))}


def _ref_specs(shapes, axes):
    """The reference's spec of each leaf, under its current context."""
    from repro.sharding import current_ctx
    return _specs(current_ctx(), shapes, axes)


def _port_specs(shapes, axes):
    return _specs(rules.current_ctx(), shapes, axes)


def test_mesh_shapes_and_rules_match_reference():
    from repro.sharding.rules import DEFAULT_RULES
    assert rules.DEFAULT_RULES == DEFAULT_RULES
    for multi_pod in (False, True):
        jm, tm = _meshes(multi_pod)
        assert dict(jm.shape) == tm.shape


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_specs_match_reference(arch, mesh_name):
    jm, tm = _meshes(MESHES[mesh_name])
    jmodel, tmodel = JModel(j_config.get_config(arch)), TModel(
        t_config.get_config(arch))
    with j_use_ctx(jm):
        want = {"params": _ref_specs(jmodel.abstract_params(),
                                     jmodel.param_axes()),
                "accum": _ref_specs(jmodel.abstract_params(),
                                    j_step.grad_accum_axes(jmodel))}
        for fsdp in (False, True):
            for opt in ("adamw", "adamw8"):
                tc = j_step.TrainConfig(opt=JOpt(name=opt), fsdp_params=fsdp)
                want[fsdp, opt] = _ref_specs(
                    j_step.abstract_train_state(jmodel, tc),
                    j_step.train_state_axes(jmodel, tc))
    with t_use_ctx(tm):
        got = {"params": _port_specs(tmodel.abstract_params(),
                                     tmodel.param_axes()),
               "accum": _port_specs(tmodel.abstract_params(),
                                    t_step.grad_accum_axes(tmodel))}
        for fsdp in (False, True):
            for opt in ("adamw", "adamw8"):
                tc = t_step.TrainConfig(opt=TOpt(name=opt), fsdp_params=fsdp)
                got[fsdp, opt] = _port_specs(
                    t_step.abstract_train_state(tmodel, tc),
                    t_step.train_state_axes(tmodel, tc))
    assert got == want
    # the ZeRO axis lands somewhere on every sizeable moment
    assert any("data" in str(s) for s in got[True, "adamw8"].values())


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_decode_rule_specs_match_reference(arch, mesh_name):
    jm, tm = _meshes(MESHES[mesh_name])
    jcfg, tcfg = j_config.get_config(arch), t_config.get_config(arch)
    jmodel, tmodel = JModel(jcfg), TModel(tcfg)
    for shape_name in j_config.shape_cells(arch):
        jshape, tshape = j_config.SHAPES[shape_name], \
            t_config.SHAPES[shape_name]
        rules_over = j_dryrun._decode_rules(jcfg) \
            if jshape.mode == "decode" else None
        with j_use_ctx(jm, rules=rules_over):
            want_b = {k: tuple(v.sharding.spec) for k, v in
                      j_specs.batch_specs(jcfg, jshape).items()}
            want_c = {k: tuple(v.sharding.spec) for k, v in
                      j_specs.cache_specs(jmodel, jshape).items()}
            want_p = _ref_specs(jmodel.abstract_params(),
                                jmodel.param_axes())
        with t_use_ctx(tm, rules=rules_over):
            got_b = {k: rules.current_ctx().spec(ax, shp) for k, (shp, _, ax)
                     in t_specs.batch_axes(tcfg, tshape).items()}
            cache = tmodel.init_cache(tshape.global_batch, tshape.seq_len,
                                      abstract=True)
            axes = tmodel.cache_axes()
            got_c = {k: rules.current_ctx().spec(axes[k], tuple(v.shape))
                     for k, v in cache.items()}
            got_p = _port_specs(tmodel.abstract_params(),
                                tmodel.param_axes())
        assert got_b == want_b, shape_name
        assert got_c == want_c, shape_name
        assert got_p == want_p, shape_name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_reference(arch):
    jmodel = JModel(j_config.get_config(arch))
    tmodel = TModel(t_config.get_config(arch))
    for shape_name in j_config.shape_cells(arch):
        sh = j_config.SHAPES[shape_name]
        want = jmodel.init_cache(sh.global_batch, sh.seq_len, abstract=True)
        got = tmodel.init_cache(sh.global_batch, sh.seq_len, abstract=True)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype), k


def test_shape_table_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_config.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_config.SHAPES.items()}
    assert t_config.LONG_CONTEXT_ARCHS == j_config.LONG_CONTEXT_ARCHS
    for arch in ARCHS:
        assert t_config.shape_cells(arch) == j_config.shape_cells(arch)
    for n in (0, 7, 999.9, 1234, 5.5e6, 2.66e9, 1.03e12, 4e15, -3e4):
        assert t_config.human(n) == j_config.human(n)


def test_divisibility_falls_back_prefix_by_prefix():
    """phi3's 10 KV heads fall back to replication on a 16-way model
    axis; a batch of 16 keeps 'pod' of ('pod', 'data') on the multi-pod
    mesh; a used axis is not reused."""
    _, tm = _meshes(True)
    with t_use_ctx(tm) as ctx:
        assert ctx.spec(("batch", "seq", "kv_heads"), (256, 4096, 10)) == \
            (("pod", "data"), "model", None)
        assert ctx.spec(("batch", None), (16, 3)) == ("pod", None)
        assert ctx.spec(("batch", None), (3, 3)) == (None, None)
        assert ctx.spec(("ff", "q_heads"), (64, 64)) == ("model", None)
        assert ctx.spec(("embed", "vocab"), None) == (None, "model")
        assert ctx.axes_size("batch") == 32 and rules.axis_size("zero") == 32
    assert rules.current_ctx().mesh is None
    assert rules.axis_size("batch") == 1


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    shape = {"pod": 2, "data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=shape)
    assert rules.placements(mesh, (("pod", "data"), "model", None)) == (
        Shard(0), Shard(0), Shard(1))
    assert rules.placements(mesh, (None, None)) == (Replicate(),) * 3
    assert rules.local_shape(mesh, (("pod", "data"), "model"),
                             (64, 32)) == (2, 2)
    with pytest.raises(ValueError):
        rules.placements(mesh, (("data", "pod"),))
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    assert rules.placements(one, ("data", "model")) == (Replicate(),) * 2


def test_bound_context_reaches_another_thread():
    """A layer recomputed in the backward runs in autograd's device
    thread: ``bind_ctx`` carries the context there (the thread's own is
    the default, no mesh)."""
    import threading
    seen = {}
    with t_use_ctx(types.SimpleNamespace(shape={"data": 2, "model": 4})):
        fn = rules.bind_ctx(lambda: rules.axis_size("seq"))
        plain = lambda: rules.axis_size("seq")  # noqa: E731
    for name, f in (("bound", fn), ("plain", plain)):
        th = threading.Thread(target=lambda: seen.__setitem__(name, f()))
        th.start()
        th.join()
    assert seen == {"bound": 4, "plain": 1}
    assert rules.bind_ctx(plain) is plain


def test_shard_is_identity_without_a_mesh_or_on_plain_tensors():
    x = torch.ones(4, 4)
    assert rules.shard(x, "batch", None) is x
    with t_use_ctx(types.SimpleNamespace(shape={"data": 2, "model": 2})):
        assert rules.shard(x, "batch", "ff") is x


DRYRUN_CELLS = [("gemma3-1b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k")]
DRYRUN_TIMEOUT_S = 120


@pytest.mark.parametrize("arch,shape_name", DRYRUN_CELLS)
def test_dryrun_cell_on_fake_backend(arch, shape_name, tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the (16, 16) mesh over
    the fake backend, in a subprocess bounded at 120 s: the cell's JSON is
    written, with FLOPs, collectives and a wall time, and its per-device
    parameter bytes are the sum of the local shards the specs give."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "out"
    code = ("import sys; from pathlib import Path; "
            "from repro_torch.launch import dryrun; "
            f"dryrun.OUT_DIR = Path({str(out)!r}); "
            f"sys.exit(dryrun.main(['--arch', {arch!r}, '--shape', "
            f"{shape_name!r}]))")
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=DRYRUN_TIMEOUT_S)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rec = json.loads((out / f"{arch}__{shape_name}__pod16x16.json")
                     .read_text())["true"]
    assert rec["flops"] > 0 and rec["collectives"]["count"] > 0
    assert rec["wall_s"] < DRYRUN_TIMEOUT_S
    cfg = t_config.get_config(arch)
    model = TModel(cfg)
    shape = {"data": 16, "model": 16}
    over = {"batch": ("data",), "experts": ("model",),
            "expert_ff": ("pod", "data")} if cfg.kind == "moe" and \
        shape_name.startswith("decode") else None
    with t_use_ctx(types.SimpleNamespace(shape=shape), rules=over) as ctx:
        if shape_name == "train_4k":
            from repro_torch.launch.dryrun import train_config
            axes = t_step.train_state_axes(model, train_config(cfg))["params"]
        else:
            axes = model.param_axes()
        want = sum(
            math.prod(rules.local_shape(ctx.mesh, ctx.spec(ax, t.shape),
                                        t.shape)) * t.element_size()
            for t, ax in _pairs(model.abstract_params(), axes))
    assert rec["param_bytes"] == want


def _pairs(tree, axes):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], axes[k])
    else:
        yield tree, axes
