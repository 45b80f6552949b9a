"""``ssd_update_roofline.zamba2-serve`` on made-up traces: the least time
of each ``ssd_decode`` launch (the fp32 state of every lane read and
written once) over the launches' device seconds, at the cell's published
shapes; nothing where no such kernel ran or nothing was traced."""
import pytest

from bench import harness

CONFIG = harness.load_json(harness.BENCH / "configs"
                           / "zamba2-7b-instruct.json")
MIX = harness.load_json(harness.BENCH / "traffic"
                        / "serve-shortchat-bursty.json")
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
METRIC = harness.load_module("metrics", "ssd_update_roofline.zamba2-serve")
# one layer's state at the cell's 96 lanes: 112 heads x 64 x 64 fp32
LAYER_BYTES = 96 * 112 * 64 * 64 * 4


def record(kernels):
    return {"dims": CONFIG["as_run"], "peaks": PEAKS,
            "serve": {"batch_slots": MIX["batch_slots"], "steps": []},
            "trace": {"kernels": kernels}}


def test_reads_the_update_kernels_against_the_state_bytes():
    least = 2 * LAYER_BYTES / PEAKS["hbm_bytes_per_s"]
    kernels = {
        "void ssd_decode_update<64, __nv_bfloat16>(float*, float*)": {
            "launches": 81 * 3, "seconds": 81 * 3 * least / 0.8},
        "nvjet_tst_128x96_64x7_4x1_v_bz_NNT": {"launches": 9,
                                                "seconds": 5.0},
        "memcpy128": {"launches": 3, "seconds": 1.0}}
    assert METRIC.read(record(kernels)) == pytest.approx(80.0)
    assert least == pytest.approx(105.2e-6, rel=1e-3)   # 352 MB a layer


@pytest.mark.parametrize("kernels", [
    {},
    {"void at::native::elementwise_kernel<128, 2>": {"launches": 9,
                                                     "seconds": 1.0},
     "std::enable_if<true, void>::type internal::gemvx::kernel<int>": {
         "launches": 81, "seconds": 0.5}}], ids=["empty", "plain_ops"])
def test_nothing_to_read_without_the_kernel(kernels):
    assert METRIC.read(record(kernels)) is None


def test_nothing_to_read_without_a_trace_or_serve_record():
    rec = record({"ssd_decode_update<64, float>": {"launches": 1,
                                                   "seconds": 1.0}})
    assert METRIC.read({**rec, "trace": None}) is None
    assert METRIC.read({**rec, "serve": None}) is None
