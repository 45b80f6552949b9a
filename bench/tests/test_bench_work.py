"""The operation and byte counts against hand counts of phi3-medium-14b's
shapes (40 layers, d 5,120, 40/10 heads of 128, d_ff 17,920, vocab
32,064 padded to 32,128)."""
import pytest
import smoke  # noqa: F401

from bench import harness, work

DIMS = harness.load_json(harness.BENCH / "configs" / "phi3-medium-14b.json"
                         )["as_run"]
# q and o: 2 x 5120 x 5120; k and v: 2 x 5120 x 1280; gate, up, down:
# 3 x 5120 x 17920
BLOCK = 2 * 5120 * 5120 + 2 * 5120 * 1280 + 3 * 5120 * 17920
TABLE = 32128 * 5120


def test_block_and_weight_counts():
    assert work.attn_block_params(DIMS) == BLOCK == 340_787_200
    assert work.weight_bytes(DIMS) == 2 * (TABLE + 40 * BLOCK) \
        == 27_591_966_720


def test_attention_pairs():
    # causal: 4 x 3 x 4 / 2 = 6 pairs of 4 x 8 flops, for 2 batches x 2 heads
    assert work.attn_work(2, 2, 1, 3, 8) == (4 * 2 * 2 * 6 * 8,
                                             2 * 2 * 8 * (2 * 2 * 3
                                                          + 2 * 1 * 3))
    # a window of 2 over 4 queries: 2 x 3 / 2 + 2 x 2 = 7 pairs
    assert work.attn_work(1, 1, 1, 4, 8, window=2)[0] == 4 * 7 * 8
    # without the mask: 3 x 5 pairs
    assert work.attn_work(1, 1, 1, 3, 8, skv=5, causal=False)[0] \
        == 4 * 15 * 8


def test_phi3_frame_is_about_60_tflop():
    s = 2048
    attn = 4 * 40 * (s * (s + 1) // 2) * 128
    want = 40 * (2 * s * BLOCK + attn) + 2 * TABLE
    assert work.frame_flops(DIMS, s) == float(want)
    assert want == pytest.approx(57.56e12, rel=1e-3)
    # the planner's 60.3 ms a frame at 989 TFLOP/s counts within 5 % of it
    assert want / 989e12 == pytest.approx(60.3e-3, rel=0.05)
    assert work.frame_bytes(DIMS, s) == float(
        2 * (TABLE + 40 * BLOCK) + 40 * 2 * 128 * (2 * 40 * s + 2 * 10 * s))


def test_decode_step_reads_each_lane_to_its_position():
    kv_row = 2 * 10 * 128 * 2
    one = work.decode_step_work(DIMS, 1, 1)
    assert one == (float(2 * TABLE + 40 * (2 * BLOCK + 4 * 40 * 128)),
                   float(2 * (TABLE + 40 * BLOCK) + 40 * 2 * kv_row))
    # 3 lanes at positions 9, 99 and 999 see 10 + 100 + 1000 keys
    flops, nbytes = work.decode_step_work(DIMS, 3, 1110)
    assert nbytes - work.weight_bytes(DIMS) == 40 * (1110 + 3) * kv_row
    assert flops == 3 * 2 * TABLE + 40 * (3 * 2 * BLOCK
                                          + 4 * 40 * 128 * 1110)


def test_bound_is_the_larger_time():
    peaks = (989e12, 3.35e12)
    assert work.bound_s(989e12, 1.0, peaks) == (1.0, "operations")
    assert work.bound_s(1.0, 6.7e12, peaks) == (2.0, "bytes")
