"""The Zamba2 serving cell (``zamba2-7b.serve-bursty``) driven on the CPU
at the program's smoke size of Zyphra's hybrid, its chip look skipped: the
sound run is correct, and each way of breaking the timed path underneath
makes ``correct`` false. Besides: the Zamba2 reference against the
program's forward, its fp8 control, serve_zamba2's check of the hybrid's
fields, and the step's operation and byte counts against hand counts at
the published widths."""
import dataclasses

import pytest
import smoke
import test_bench_cells as cells

import torch

from bench import harness, weights, work_zamba2
from bench.drivers import serve_zamba2
from bench.reference.zamba2 import Reference, segsum, ssd

torch.set_num_threads(2)

CELL = "zamba2-7b.serve-bursty"
CONFIG = harness.load_json(harness.BENCH / "configs"
                           / "zamba2-7b-instruct.json")


def as_run(cfg) -> dict:
    """A configuration file's ``as_run`` of a program config of Zyphra's
    hybrid: ``smoke.as_run``'s sizes and the hybrid's own."""
    dims = smoke.as_run(cfg)
    dims.update(ssm=dataclasses.asdict(cfg.ssm),
                hybrid_layer_ids=list(cfg.hybrid_layer_ids),
                n_mem_blocks=cfg.n_mem_blocks, attn_in=cfg.attn_width,
                adapter_rank=cfg.adapter_rank)
    return dims


def shrink(cell: harness.Cell, dtype: str = "float32") -> harness.Cell:
    """``cell`` at Zyphra's hybrid's smoke size on the CPU: every size of
    the smoke config as the program's override and in ``as_run``, and the
    serving smoke mix."""
    from repro_torch.models.config import get_smoke_config

    config = dict(cell.config)
    small = get_smoke_config(config["program_arch"])
    over = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if f.name not in ("name", "param_dtype", "compute_dtype")}
    config.update(program_overrides=over, dtype=dtype, as_run=as_run(small))
    mix = {**cell.mix, **smoke.SMOKE_MIX["serve"]}
    cell = dataclasses.replace(cell, config=config, mix=mix, device="cpu")
    cell.limits = cells.SERVE_LIMITS
    return cell


def zamba_cell(seed=7, seconds=1.0):
    return shrink(harness.load_cell(harness.load_spec(), CELL, seed, seconds,
                                    False))


def conv_and_state_unwritten(run):
    """The step writes its K/V and positions but leaves every layer's conv
    and SSM state as it found them."""
    def after(nxt, cache, saved):
        for k in ("conv", "state"):
            cache[k].copy_(saved[k])
    cells.wrap_step(run, after)


def test_cell_files_and_driver():
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    assert cell.mix["driver"] == "serve_zamba2"
    assert cell.config["reduced"] == [] and cell.chips == 1
    assert cell.dims["hybrid_layer_ids"] == CONFIG["hybrid_layer_ids"]
    assert cell.limits["served_tokens_checked"]["min"] >= 100
    mix = cell.mix
    assert (mix["batch_slots"], mix["max_len"]) == (96, 384)
    assert mix["arrivals"]["kind"] == "on_off"
    assert mix["prompt"]["max"] + mix["output"]["max"] <= mix["max_len"]


def test_config_quotes_the_catalog_row():
    """The published keys, as the catalog's row gives them, and the
    program's sizes as run."""
    assert CONFIG["num_hidden_layers"] == CONFIG["as_run"]["n_layers"] == 81
    assert CONFIG["hidden_size"] == CONFIG["as_run"]["d_model"] == 3584
    assert CONFIG["attention_head_dim"] == CONFIG["as_run"]["head_dim"]
    assert CONFIG["attention_hidden_size"] == CONFIG["as_run"]["attn_in"]
    assert CONFIG["mamba_ngroups"] == CONFIG["as_run"]["ssm"]["n_groups"]
    assert CONFIG["n_mamba_heads"] == 2 * 3584 // CONFIG["mamba_headdim"]
    assert len(CONFIG["layers_block_type"]) == 81
    assert [i for i, t in enumerate(CONFIG["layers_block_type"])
            if t == "hybrid"] == CONFIG["hybrid_layer_ids"]


def test_program_config_matches_as_run():
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    serve_zamba2.check_zyphra(cell)
    cfg = harness.port_config(cell)
    assert cfg.zyphra and cfg.vocab == 32000


def test_driver_refuses_other_hybrid_fields():
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    config = dict(cell.config)
    config["as_run"] = {**cell.dims, "hybrid_layer_ids": [6, 12]}
    with pytest.raises(ValueError, match="hybrid_layer_ids"):
        serve_zamba2.check_zyphra(dataclasses.replace(cell, config=config))


def test_sound_run_is_correct():
    ok, values = cells.correct(zamba_cell())
    assert ok, values
    assert values["served_tokens_checked"] >= 10


@pytest.mark.parametrize("fault", [cells.token_altered, cells.state_unchanged,
                                   cells.half_batch, conv_and_state_unwritten],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    ok, values = cells.correct(zamba_cell(), fault)
    assert not ok, values


def test_metrics_read_the_run():
    run, rec, values, checks = smoke.run_cell(zamba_cell())
    record = {**rec, "dims": run.cell.dims, "peaks": {
        "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}}
    mfu = harness.load_module("metrics", "mfu.zamba2-serve").read(record)
    assert 0 < mfu < 100
    non_gemm = harness.load_module("metrics", "non_gemm_share.zamba2-serve")
    assert non_gemm.read(record) is None            # no trace: nothing
    trace = {"kernels": {"nvjet_tst_64x8": {"seconds": 3.0, "launches": 9},
                         "elementwise_kernel": {"seconds": 1.0,
                                                "launches": 9},
                         "Memcpy DtoD (Device -> Device)": {
                             "seconds": 5.0, "launches": 1}}}
    assert non_gemm.read({**record, "trace": trace}) == 25.0


def test_reference_matches_program_forward():
    """The Zamba2 reference against the program's forward at the smoke
    size, fp32, on the benchmark's weights: the same hidden states and
    greedy tokens; the fp8 control departs from both."""
    from repro_torch.models.embedloss import greedy
    from repro_torch.models.transformer import STACK_DIMS, Model

    cell = zamba_cell()
    model = Model(harness.port_config(cell))
    params = weights.make(model.param_shapes(), STACK_DIMS, 11, "cpu",
                          torch.float32)
    tokens = torch.randint(0, cell.dims["vocab"], (2, 37),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens.int()})
    ref = Reference(cell.dims, params)
    want = ref.hidden(tokens)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 1e-4, rel
    logits = ref.logits(want)
    prog = greedy(got.reshape(-1, got.shape[-1]), params["embed"],
                  valid_vocab=cell.dims["vocab"])
    assert (prog.long() == logits.reshape(-1, logits.shape[-1]).argmax(-1)
            ).float().mean() > 0.99
    low = Reference(cell.dims, params, fp8=True).hidden(tokens)
    assert ((low - want).norm() / want.norm()).item() > 100 * rel


def test_masked_decay_ssd_matches_steps():
    """The reference's quadratic SSD against its step recurrence, two
    groups, and the direct segment sums against their definition."""
    gen = torch.Generator().manual_seed(3)
    b, l, h, p, g, n = 2, 23, 4, 8, 2, 5
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.rand(b, l, h, generator=gen) + 0.1
    a = -torch.rand(h, generator=gen) - 0.2
    bm = torch.randn(b, l, g, n, generator=gen)
    cm = torch.randn(b, l, g, n, generator=gen)
    s = torch.zeros(b, h, p, n)
    want = []
    for t in range(l):
        bt = bm[:, t].repeat_interleave(h // g, 1)
        ct = cm[:, t].repeat_interleave(h // g, 1)
        s = s * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bt[:, :, None]
        want.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    y = ssd(x, dt, a, bm, cm)
    assert ((y - torch.stack(want, 1)).norm() / y.norm()).item() < 1e-5
    da = torch.randn(3, 6)
    seg = segsum(da)
    assert seg[1, 4, 1].item() == pytest.approx(da[1, 2:5].sum().item())
    assert seg[0, 3, 3].item() == 0.0 and seg[0, 2, 3].item() == -torch.inf


def test_step_work_counts_at_the_published_widths():
    dims = CONFIG["as_run"]
    mamba = 3584 * (7168 + 7424 + 112) + 7168 * 3584
    block = 7168 * 3 * 32 * 224 + 32 * 224 * 3584 + 3 * 3584 * 14336
    app = 3584 * 128 + 2 * 128 * 14336 + 3584 * 3584
    assert work_zamba2.mamba_params(dims) == mamba
    assert work_zamba2.block_params(dims) == block
    assert work_zamba2.app_params(dims) == app
    assert work_zamba2.weight_bytes(dims) == 2 * 7_356_749_648
    ssm = 81 * 112 * 64 * 64 * 4           # 148.6 MB a lane
    conv = 81 * 3 * 7424 * 2               # 3.6 MB a lane
    assert work_zamba2.state_bytes(dims) == ssm + conv
    kv_row = 2 * 32 * 224 * 2
    flops, nbytes = work_zamba2.decode_step_work(dims, 96, 96 * 200)
    assert nbytes == 2 * 7_356_749_648 + 2 * 96 * (ssm + conv) \
        + 13 * (96 * 200 + 96) * kv_row
    assert 2 * 96 * ssm == pytest.approx(28.5e9, rel=2e-3)
    per_lane = 81 * mamba + 13 * (block + app) + 32000 * 3584
    assert flops == 96 * (2 * per_lane + 81 * 5 * 112 * 64 * 64) \
        + 13 * 4 * 32 * 224 * 96 * 200
