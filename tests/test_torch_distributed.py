"""The port's sharded branches on gloo, against the reference's no-mesh
outputs: context-parallel attention (the kernels' and the plain paths,
causal and windowed), flash-decoding, the expert-parallel MoE variants
(a2a, psum, experts over both axes, the decode cells' 2-D layout), the
vocab-parallel loss and its gradients, embed_in and greedy, a Mamba2
block with its scan on each rank's heads, the whole-model loss of seven
smoke configs, a prefill and greedy decode with the cache sharded, and one
train step with FSDP parameters and a ZeRO accumulator.

Each rank is this file run as a script in a spawned subprocess bounded
by its own timeout (``worker_main``: one rank of a gloo group, which
runs the branches on the seeded inputs and the reference's outputs the
test wrote to an .npz; rank 0 writes the errors as JSON): 8 ranks on the
reference test's (2, 4) mesh, and 1 rank on a (1, 1) mesh, where every
branch must also equal the port's no-mesh path. The pytest worker itself
initialises no process group, and the ranks import no JAX. The
tolerances are the reference test's (``tests/test_distributed.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if __name__ != "__main__":
    pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    context_attention, decode_attention)
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.moe import moe_apply, moe_local  # noqa: E402
from repro_torch.models.ssm import mamba_block  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.sharding import rules, use_ctx  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.optimizer import OptConfig, tree_map  # noqa: E402

WORKER = Path(__file__).resolve()
ARCHS = ("stablelm-3b", "gemma3-1b", "kimi-k2-1t-a32b", "mamba2-1.3b",
         "zamba2-7b", "whisper-small", "internvl2-26b")
TIMEOUT_S = 240

TOL = {"context_attention": 1e-5, "decode_attention": 1e-5, "moe": 1e-4,
       "lm_loss": 1e-5, "embed_in": 0.0, "greedy": 0.0,
       "mamba_block": 1e-5, "model_loss": 2e-3, "prefill_decode": 1e-5,
       "train_step": 1e-5, "init_cache": 0.0, "apply_updates": 0.0}
CHECKS = ([f"context_attention/{i}/{w}" for i in ("kernel", "chunked",
                                                   "xla_flash")
           for w in ("causal", "window8")]
          + ["decode_attention/pos19", "decode_attention/lanes",
             "moe/a2a", "moe/psum", "moe/psum_multi", "moe/decode_2d",
             "lm_loss", "embed_in", "greedy", "mamba_block"]
          + [f"model_loss/{a}" for a in ARCHS]
          + ["prefill_decode/hidden", "prefill_decode/k_cache",
             "prefill_decode/tokens", "train_step"]
          + [f"init_cache/{a}" for a in ("stablelm-3b", "gemma3-1b",
                                         "zamba2-7b")]
          + ["apply_updates/adamw", "apply_updates/adamw8",
             "apply_updates/gathers"])


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v)


def _ref_smoke(arch):
    """The reference's smoke config, MoE without drops."""
    from repro.models.config import get_smoke_config as j_smoke
    cfg = j_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def _inputs() -> dict:
    """Seeded inputs and the reference's no-mesh outputs on them."""
    import jax
    import jax.numpy as jnp
    from repro.models import embedloss as j_embedloss
    from repro.models.attention import (
        decode_attention_local, naive_attention)
    from repro.models.config import MoEConfig as JMoEConfig
    from repro.models.config import get_smoke_config as j_smoke
    from repro.models.moe import moe_dense_oracle
    from repro.models.transformer import Model as JModel
    rng = np.random.default_rng(0)
    f32 = np.float32
    d = {}
    b, s, hq, hkv, hd = 2, 32, 6, 2, 16
    d["q"] = rng.normal(size=(b, s, hq, hd)).astype(f32)
    d["k"] = rng.normal(size=(b, s, hkv, hd)).astype(f32)
    d["v"] = rng.normal(size=(b, s, hkv, hd)).astype(f32)
    for name, window in (("causal", 0), ("window8", 8)):
        d[f"attn_{name}"] = np.asarray(naive_attention(
            d["q"], d["k"], d["v"], causal=True, window=window))
    d["kc"] = rng.normal(size=(b, 32, hkv, hd)).astype(f32)
    d["vc"] = rng.normal(size=(b, 32, hkv, hd)).astype(f32)
    d["qd"] = rng.normal(size=(b, hq, hd)).astype(f32)
    d["lanes"] = np.array([19, 7], np.int64)
    for name, pos in (("pos19", 19), ("lanes", d["lanes"])):
        o, _, _ = decode_attention_local(d["qd"], d["kc"], d["vc"],
                                         pos=jnp.asarray(pos))
        d[f"dec_{name}"] = np.asarray(o).reshape(b, hq, hd)
    cfg = JMoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                     capacity_factor=8.0)
    dm = 16
    mp = {"router": rng.normal(size=(dm, 8)).astype(f32),
          "w_gate": (rng.normal(size=(8, dm, 32)) * 0.1).astype(f32),
          "w_up": (rng.normal(size=(8, dm, 32)) * 0.1).astype(f32),
          "w_down": (rng.normal(size=(8, 32, dm)) * 0.1).astype(f32)}
    for k, v in mp.items():
        d["moe_" + k] = v
    x = rng.normal(size=(2, 8, dm)).astype(f32)
    d["moe_x"] = x
    d["moe_ref"] = np.asarray(moe_dense_oracle(
        x.reshape(-1, dm), mp, cfg)).reshape(2, 8, dm)
    d["moe_ref1"] = np.asarray(moe_dense_oracle(
        x[:, :1].reshape(-1, dm), mp, cfg)).reshape(2, 1, dm)
    d["lm_table"] = rng.normal(size=(64, 16)).astype(f32)
    d["lm_x"] = rng.normal(size=(2, 8, 16)).astype(f32)
    d["lm_labels"] = rng.integers(0, 60, (2, 8)).astype(np.int32)
    loss, (gx, gt) = jax.value_and_grad(
        lambda x_, t_: j_embedloss.lm_loss(x_, t_, d["lm_labels"],
                                           valid_vocab=60, seq_chunk=4),
        argnums=(0, 1))(d["lm_x"], d["lm_table"])
    d["lm_loss"], d["lm_gx"], d["lm_gt"] = map(np.asarray, (loss, gx, gt))
    scfg = j_smoke("mamba2-1.3b")
    d["ssm_x"] = rng.normal(size=(2, 16, scfg.d_model)).astype(f32)
    for arch in ARCHS:
        mcfg = _ref_smoke(arch)
        model = JModel(mcfg)
        p = jax.tree.map(np.asarray, model.init(0))
        batch = {"tokens": rng.integers(0, mcfg.vocab, (2, 16)).astype(
            np.int32), "labels": rng.integers(0, mcfg.vocab, (2, 16)).astype(
            np.int32)}
        if mcfg.kind == "vlm":
            batch["patches"] = rng.normal(
                size=(2, mcfg.n_patches, mcfg.d_model)).astype(f32)
        if mcfg.kind in ("audio", "encdec"):
            batch["frames"] = rng.normal(
                size=(2, mcfg.enc_len, mcfg.d_model)).astype(f32)
        d[f"loss_{arch}"] = np.asarray(model.loss(p, batch))
        _flat(p, f"params/{arch}/", d)
        _flat(batch, f"batch/{arch}/", d)
    d["train/tokens"] = rng.integers(0, 100, (4, 8)).astype(np.int32)
    d["train/labels"] = rng.integers(0, 100, (4, 8)).astype(np.int32)
    return d


def _spawn(world: int, tmp: Path) -> dict:
    out = tmp / f"out_{world}.json"
    env = dict(os.environ, INIT=f"file://{tmp}/store_{world}",
               PYTHONPATH=str(HERE.parent / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(world), str(tmp / "inputs.npz"),
         str(out)], env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        line for log in logs for line in log.splitlines()
        if "Warning" not in line and "warn" not in line)[-6000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    return {"2x4": _spawn(8, tmp), "1x1": _spawn(1, tmp)}


@pytest.mark.parametrize("check", CHECKS)
def test_sharded_branch_matches_reference_on_2x4(results, check):
    assert results["2x4"]["mesh"][check] <= TOL[check.split("/")[0]], \
        results["2x4"]["mesh"][check]


@pytest.mark.parametrize("check", CHECKS)
def test_one_by_one_mesh_matches_reference_and_no_mesh(results, check):
    tol = TOL[check.split("/")[0]]
    assert results["1x1"]["mesh"][check] <= tol
    if check in results["1x1"]["local"]:
        assert results["1x1"]["local"][check] <= tol
    if check in results["2x4"]["local"]:
        assert results["2x4"]["local"][check] <= tol


def test_pytest_worker_holds_no_process_group(results):
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- worker
def whole(x):
    return x.full_tensor() if rules.is_dtensor(x) else x


def err(a, b) -> float:
    return float((whole(a).double() - whole(torch.as_tensor(b)).double())
                 .abs().max())


def unflatten(data, prefix):
    out = {}
    for key in data.files:
        if key.startswith(prefix):
            node = out
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def _port_smoke(arch):
    """The port's smoke config, MoE without drops."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def checks(mesh, data):
    t = {k: torch.from_numpy(data[k]) for k in data.files
         if not k.startswith(("params/", "train/"))}
    res, local = {}, {}
    # context attention: the kernels' CPU paths and the plain path
    for impl in ("kernel", "chunked", "xla_flash"):
        for name, window in (("causal", 0), ("window8", 8)):
            with use_ctx(mesh):
                out = context_attention(t["q"], t["k"], t["v"], causal=True,
                                        window=window, impl=impl)
            res[f"context_attention/{impl}/{name}"] = err(
                out, t[f"attn_{name}"])
            local[f"context_attention/{impl}/{name}"] = err(
                context_attention(t["q"], t["k"], t["v"], causal=True,
                                  window=window, impl=impl), out)
    # flash-decoding, a shared position and per-lane positions
    for name, pos in (("pos19", 19), ("lanes", t["lanes"])):
        with use_ctx(mesh):
            o = decode_attention(t["qd"], t["kc"], t["vc"], pos=pos)
        res[f"decode_attention/{name}"] = err(o, t[f"dec_{name}"])
        local[f"decode_attention/{name}"] = err(
            decode_attention(t["qd"], t["kc"], t["vc"], pos=pos), o)
    # MoE: a2a (sequence divides), psum (one token), experts over both
    # axes, and the decode cells' 2-D expert sharding
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                    capacity_factor=8.0)
    mp = {k: t["moe_" + k] for k in ("router", "w_gate", "w_up", "w_down")}
    cases = (("a2a", t["moe_x"], None), ("psum", t["moe_x"][:, :1], None),
             ("psum_multi", t["moe_x"][:, :1],
              {"experts": ("data", "model"), "batch": ()}),
             ("decode_2d", t["moe_x"][:, :1],
              {"batch": ("data",), "experts": ("model",),
               "expert_ff": ("pod", "data")}))
    for name, x, over in cases:
        with use_ctx(mesh, rules=over):
            y = moe_apply(x, mp, cfg)
        res[f"moe/{name}"] = err(y, t["moe_ref" if name == "a2a"
                                      else "moe_ref1"])
        local[f"moe/{name}"] = err(
            moe_local(x.reshape(-1, x.shape[-1]), mp, cfg).reshape(x.shape),
            y)
    # vocab-parallel loss: value and both gradients
    for where in ("mesh", "local"):
        x = t["lm_x"].clone().requires_grad_()
        tb = t["lm_table"].clone().requires_grad_()
        ctx = use_ctx(mesh) if where == "mesh" else use_ctx(None)
        with ctx:
            loss = embedloss.lm_loss(x, tb, t["lm_labels"], valid_vocab=60,
                                     seq_chunk=4)
            gx, gt = torch.autograd.grad(loss, (x, tb))
        errs = [err(loss, t["lm_loss"]), err(gx, t["lm_gx"]),
                err(gt, t["lm_gt"])]
        (res if where == "mesh" else local)["lm_loss"] = max(errs)
    # embed_in and greedy against the no-mesh functions
    with use_ctx(mesh):
        emb = embedloss.embed_in(t["lm_table"], t["lm_labels"], torch.float32)
        tok = embedloss.greedy(t["lm_x"][:, 0], t["lm_table"], 60)
    res["embed_in"] = err(emb, embedloss.embed_in(
        t["lm_table"], t["lm_labels"], torch.float32))
    res["greedy"] = err(tok, embedloss.greedy(t["lm_x"][:, 0], t["lm_table"],
                                              60))
    # a Mamba2 block, the scan on each rank's heads
    scfg = get_smoke_config("mamba2-1.3b")
    sp = params_from_jax(unflatten(data, "params/mamba2-1.3b/"), scfg,
                         device="cpu")
    lp = {k: v[0] for k, v in sp["layers"].items()}
    hx = t["ssm_x"]
    y0, (c0, s0) = mamba_block(lp, hx, scfg.ssm, use_kernel=True)
    with use_ctx(mesh):
        lpd = {k: rules.distribute(v, ax) for (k, v), ax in zip(
            lp.items(), [Model(scfg).param_axes()["layers"][k][1:]
                         for k in lp])}
        y1, (_, s1) = mamba_block(lpd, hx, scfg.ssm, use_kernel=True)
    res["mamba_block"] = max(err(y1, y0), err(s1, s0))
    # whole-model losses against the reference's no-mesh loss
    for arch in ARCHS:
        mcfg = _port_smoke(arch)
        model = Model(mcfg)
        p = params_from_jax(unflatten(data, f"params/{arch}/"), mcfg,
                            device="cpu")
        batch = {k[len(arch) + 7:]: torch.from_numpy(data[k])
                 for k in data.files if k.startswith(f"batch/{arch}/")}
        with torch.no_grad():
            l_local = model.loss(p, batch)
            with use_ctx(mesh):
                pd = rules.tree_map2(rules.distribute, p, model.param_axes())
                l_mesh = model.loss(pd, batch)
        res[f"model_loss/{arch}"] = err(l_mesh, t[f"loss_{arch}"])
        local[f"model_loss/{arch}"] = err(l_local, l_mesh)
    # prefill + greedy decode under the mesh: the cache sharded over
    # kv_seq, written shard by shard
    mcfg = _port_smoke("stablelm-3b")
    model = Model(mcfg)
    p = params_from_jax(unflatten(data, "params/stablelm-3b/"), mcfg,
                        device="cpu")
    prompt = torch.from_numpy(data["batch/stablelm-3b/tokens"])[:, :8]
    with torch.no_grad():
        toks = []
        cache, h = model.prefill(p, {"tokens": prompt}, cache_len=16)
        nxt = embedloss.greedy(h, p["embed"], mcfg.vocab)
        for _ in range(4):
            nxt, cache = model.decode_step(p, cache, nxt)
            toks.append(nxt)
        with use_ctx(mesh):
            pd = rules.tree_map2(rules.distribute, p, model.param_axes())
            mcache, mh = model.prefill(pd, {"tokens": prompt}, cache_len=16)
            mnxt = embedloss.greedy(mh, pd["embed"], mcfg.vocab)
            mtoks = []
            for _ in range(4):
                mnxt, mcache = model.decode_step(pd, mcache, mnxt)
                mtoks.append(whole(mnxt))
        res["prefill_decode/hidden"] = err(mh, h)
        res["prefill_decode/k_cache"] = err(mcache["k"], cache["k"])
        res["prefill_decode/tokens"] = float(
            (torch.stack(mtoks) != torch.stack(toks)).sum())
    # one train step, FSDP params and a ZeRO accumulator, 2 microbatches
    res["train_step"] = train_step(mesh, data)
    for arch in ("stablelm-3b", "gemma3-1b", "zamba2-7b"):
        res[f"init_cache/{arch}"] = init_cache_bytes(mesh, arch)
    res.update(apply_updates_checks(mesh))
    return res, local


class LargestAlloc(TorchDispatchMode):
    """The most bytes of storage any op's output held while active (meta
    tensors, which hold none, aside)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.most = max(self.most, t.untyped_storage().nbytes())
        return out


def init_cache_bytes(mesh, arch):
    """How far each rank's cache storage is from its shard's size (bytes,
    summed over the leaves), plus any allocation larger than the largest
    shard, plus how far the zeros' values are off: a mesh-laid cache
    allocates each rank's shard only, never a whole leaf."""
    model = Model(_port_smoke(arch))
    want = model.init_cache(2, 16, device="cpu")
    with use_ctx(mesh), LargestAlloc() as alloc:
        got = model.init_cache(2, 16, device="cpu")
    off, shard_most = 0.0, 0
    for k, leaf in got.items():
        shards = np.prod([rules.dim_shards(leaf, d)
                          for d in range(leaf.dim())])
        shard = leaf.numel() * leaf.element_size() // shards
        shard_most = max(shard_most, shard)
        off += abs(leaf.to_local().untyped_storage().nbytes() - shard)
        off += err(leaf, want[k]) + float(leaf.shape != want[k].shape)
    return off + max(0, alloc.most - shard_most)


def apply_updates_checks(mesh):
    """One optimizer step over DTensors against the same step over whole
    tensors (bit for bit), with the moments laid out as ZeRO lays them:
    a leaf whose shards hold whole int8 blocks, one whose shards would cut
    a block, one replicated. Then how many all-gathers a step issues when
    parameters and moments share a block-aligned layout (none: every rank
    updates its own shard)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.train.optimizer import apply_updates, init_opt_state
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (8, 1024), "b": (8, 80), "c": (6, 300)}
    p_spec = {"a": (None, "model"), "b": ("data", None), "c": (None, None)}
    m_spec = {"a": ("data", "model"), "b": (None, "model"), "c": (None, None)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    # small gradients: the norm stays under the clip, so the clip factor
    # is exactly 1 whichever order the shards' squares are summed in
    grads = {k: 1e-3 * torch.randn(s, generator=gen)
             for k, s in shapes.items()}
    res = {}

    def lay(t, spec):
        return rules.from_whole(t, mesh, rules.placements(mesh, spec))

    def lay_moment(m, spec, s_spec):
        if isinstance(m, dict):
            return {"q": lay(m["q"], spec), "s": lay(m["s"], s_spec)}
        return lay(m, spec)

    for name in ("adamw", "adamw8"):
        cfg = OptConfig(name=name, warmup=1)
        state = init_opt_state(params, cfg)
        for _ in range(2):
            g = {k: v * 1.5 for k, v in grads.items()}
            ref = apply_updates(params, g, state, cfg)
            dp = {k: lay(v, p_spec[k]) for k, v in params.items()}
            dg = {k: lay(v, m_spec[k]) for k, v in g.items()}
            # the scales' last dim unsharded, as train_state_axes lays them
            dm = {mk: {k: lay_moment(v, m_spec[k], m_spec[k][:-1] + (None,))
                       for k, v in state[mk].items()} for mk in ("m", "v")}
            new_p, new_s, _ = apply_updates(
                dp, dg, {**dm, "step": state["step"]}, cfg)
            errs = [err(new_p[k], ref[0][k]) for k in shapes]
            for mk in ("m", "v"):
                tree_map(lambda a, b: errs.extend(
                    [err(a[x], b[x]) for x in a] if isinstance(a, dict)
                    else [err(a, b)]), new_s[mk], ref[1][mk])
            res[f"apply_updates/{name}"] = max(
                res.get(f"apply_updates/{name}", 0.0), max(errs))
            params, state = ref[0], ref[1]
    cfg = OptConfig(name="adamw8")
    state = init_opt_state({"a": params["a"]}, cfg)
    spec = m_spec["a"]
    with CommDebugMode() as comm:
        apply_updates({"a": lay(params["a"], spec)},
                      {"a": lay(grads["a"], spec)},
                      {"m": {"a": lay_moment(state["m"]["a"], spec, spec)},
                       "v": {"a": lay_moment(state["v"]["a"], spec, spec)},
                       "step": state["step"]}, cfg)
    res["apply_updates/gathers"] = float(sum(
        n for op, n in comm.get_comm_counts().items()
        if "all_gather" in str(op)))
    return res


def train_step(mesh, data):
    cfg = _port_smoke("stablelm-3b")
    model = Model(cfg)
    p = params_from_jax(unflatten(data, "params/stablelm-3b/"), cfg,
                        device="cpu")
    batch = {k: torch.from_numpy(data["train/" + k])
             for k in ("tokens", "labels")}
    tcfg = tstep.TrainConfig(n_microbatches=2, opt=OptConfig(name="adamw"),
                             fsdp_params=True, zero_grad_accum=True)
    state = {"params": p, "opt": tstep.init_opt_state(p, tcfg.opt)}
    ref, _ = tstep.make_train_step(model, tcfg)(state, batch)
    with use_ctx(mesh):
        axes = tstep.train_state_axes(model, tcfg)
        dstate = tstep.distribute_state(state, axes)
        new, _ = tstep.make_train_step(model, tcfg)(dstate, batch)
        errs = [err(a, b) for a, b in zip(
            tree_map_leaves(new["params"]), tree_map_leaves(ref["params"]))]
    return max(errs)


def tree_map_leaves(tree):
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def worker_main():
    world, inputs, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=os.environ["INIT"],
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(model_axis=1 if world == 1 else 4,
                               device_type="cpu")
        res, local = checks(mesh, np.load(inputs))
        if rank == 0:
            Path(out_path).write_text(json.dumps({"mesh": res,
                                                  "local": local}))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker_main()
