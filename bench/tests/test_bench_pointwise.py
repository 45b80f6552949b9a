"""The two readers of the fused pointwise path, on a synthetic trace of a
chain slice: the share of kernel time outside the GEMMs and the prefill
attention, and the fused RoPE kernel's launches over the attention's."""
import pytest

from bench import harness

# one frame of a 2-layer chain as the parent ran it, and as the fused
# path runs it (kernel names as the profiler gives them, cut at 100)
PLAIN = {
    "nvjet_tst_320x128_64x3_1x2_h_bz_coopA_NTN": (8, 0.0060),
    "void attn::tc::flash_fwd_tc<128>(attn::Params)": (2, 0.0009),
    "void at::native::elementwise_kernel<128, 2, ...>": (40, 0.0018),
    "void at::native::reduce_kernel<512, 1, ...>": (4, 0.0004),
    "Memcpy HtoD (Pageable -> Device)": (1, 0.0100),
}
FUSED = {
    "nvjet_tst_320x128_64x3_1x2_h_bz_coopA_NTN": (8, 0.0060),
    "void attn::tc::flash_fwd_tc<128>(attn::Params)": (2, 0.0009),
    "void rms_norm_fwd<8, false, __nv_bfloat16>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16*, ": (2, 0.0001),
    "void rms_norm_fwd<8, true, __nv_bfloat16>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16*, _": (2, 0.0001),
    "rope_qk_fwd(__nv_bfloat16*, __nv_bfloat16*, float const*, float "
    "const*, int, int, int, int, long, long, lon": (2, 0.0001),
    "swiglu_gate_fwd(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "__nv_bfloat16*, long)": (2, 0.0002),
    "Memset (Device)": (1, 0.0100),
}


def _rec(kernels, chain=True):
    trace = {"kernels": {n: {"launches": c, "seconds": s}
                         for n, (c, s) in kernels.items()}}
    return {"trace": trace, "chain": {"frames": 1} if chain else None}


@pytest.mark.parametrize("kernels,share", [
    (PLAIN, 100 * 0.0022 / 0.0091), (FUSED, 100 * 0.0005 / 0.0074)],
    ids=["plain", "fused"])
def test_pointwise_share_reads_what_is_neither_gemm_nor_attention(
        kernels, share):
    reader = harness.load_module("metrics", "pointwise_share.chain")
    assert reader.read(_rec(kernels)) == pytest.approx(share)
    assert reader.read(_rec(kernels, chain=False)) is None
    assert reader.read({"trace": {"kernels": {}}, "chain": {}}) is None


def test_fused_layer_share_counts_rope_launches_per_attention_launch():
    reader = harness.load_module("metrics", "fused_layer_share.chain")
    assert reader.read(_rec(FUSED)) == pytest.approx(100.0)
    half = dict(FUSED)
    name = next(n for n in half if n.startswith("rope_qk_fwd"))
    half[name] = (1, 0.00005)
    assert reader.read(_rec(half)) == pytest.approx(50.0)
    # the parent's program has no fused kernel: nothing to read
    assert reader.read(_rec(PLAIN)) is None
    assert reader.read(_rec(FUSED, chain=False)) is None
