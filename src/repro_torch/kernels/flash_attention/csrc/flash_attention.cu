// Flash attention forward for Hopper (sm_90a), causal / sliding-window, GQA.
//
// Replaces the Pallas TPU kernel flash_attention_tpu
// (src/repro/kernels/flash_attention/kernel.py). It computes the same
// function, softmax(q k^T / sqrt(d) + mask) v, by blocked online softmax:
// a running max m, a running sum l and an fp32 accumulator rescaled by
// exp(m_prev - m_new) for every kv tile, then acc / max(l, 1e-30), so a
// fully masked row gives 0.
//
// What bounds it on this card: at prefill shapes (S = 2048, d = 128) the
// work is ~2 S^2 d flops per (batch, head) against ~4 S d bytes, far above
// the H100's ~295 flops/byte balance point, so it is bound by operations.
// The launcher picks the body by dtype (attention_common.cuh):
// - bf16, the serving dtype, runs flash_fwd_tc on the tensor cores: per
//   block two warpgroups of 64 query rows over a two-stage cp.async ring
//   of 64-row K/V tiles in 128-byte-swizzled shared memory (coalesced
//   copies, no bank conflicts); S = Q K^T and O += P V by wgmma with fp32
//   accumulators in registers; the row max and sum on the accumulator
//   fragment (two quad shuffles for the max; the sum is reduced once at
//   the end). P is rounded to bf16 for the product and l sums the rounded
//   values, so the normaliser and the weights of V agree. Only tiles the
//   mask cuts (the causal diagonal, the window's edge, the ragged end)
//   evaluate the mask; a warpgroup skips tiles none of its rows sees; the
//   query tiles run in reverse, the longest causal rows first.
// - fp32 runs flash_fwd, the first body, on the CUDA cores: TF32
//   cannot meet the reference's 2e-5 fp32 tolerance.
// Both never compute a kv tile the mask hides entirely: causal and window
// become loop bounds, halving the causal work.
//
// Layout: the inputs are read through strides in the (B, S, H, D) layout,
// so the caller never materialises a transpose; the ragged tail of S is
// handled by load/store masks, not padding. GQA: the kv head is
// q_head / group, K/V are never repeated. Head dims 32, 64, 80 (stablelm-3b),
// 112 (the zamba2 variant's shared attention), 128, 224 (Zyphra's zamba2)
// and 256 (gemma3; the fp32 body's K/V tiles have 16 rows at 224 and 256,
// attention_common.cuh).
#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd(const Params p) {
  constexpr int DPT = D / TPR;       // head dims per thread
  constexpr int NV = DPT / 4;        // float4 groups per thread
  constexpr int BK = simt_bk<D>();
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;        // thread's dims: i*4*TPR + part*4 + c
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int qp = q0 + row;
  const bool row_ok = qp < p.sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = i * 4 * TPR + part * 4 + c;
      qr[i * 4 + c] = row_ok ? to_f(qg[qp * p.q_ss + d]) : 0.f;
      acc[i * 4 + c] = 0.f;
    }
  }
  float m = NEG;
  float l = 0.f;

  // kv tiles the mask can reach from this q tile: causality bounds the
  // top, the window the bottom (the TPU kernel's pl.when block skip).
  // Query row r sits at position r + q_off.
  const int qa = qp + p.q_off;
  int hi = p.skv;
  if (p.causal) hi = min(hi, q0 + p.q_off + BQ);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 + p.q_off - p.window + 1);
  lo = (lo / BK) * BK;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kp = k0 + j;
      const bool ok = kp < p.skv;
      ks[j][d] = ok ? to_f(kg[kp * p.k_ss + d]) : 0.f;
      vs[j][d] = ok ? to_f(vg[kp * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    unsigned okbits = 0u;
    float m_cur = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = kr[i * TPR + part];
        dot += qr[i * 4 + 0] * kk.x;
        dot += qr[i * 4 + 1] * kk.y;
        dot += qr[i * 4 + 2] * kk.z;
        dot += qr[i * 4 + 3] * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      const bool ok = kp < p.skv && (!p.causal || kp <= qa) &&
                      (p.window <= 0 || kp > qa - p.window);
      okbits |= ok ? (1u << j) : 0u;
      s[j] = ok ? dot * p.scale : NEG;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = ((okbits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vr[i * TPR + part];
        acc[i * 4 + 0] += s[j] * vv.x;
        acc[i * 4 + 1] += s[j] * vv.y;
        acc[i * 4 + 2] += s[j] * vv.z;
        acc[i * 4 + 3] += s[j] * vv.w;
      }
    }
  }

  if (row_ok) {
    T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + qp * p.o_ss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        og[i * 4 * TPR + part * 4 + c] = from_f<T>(acc[i * 4 + c] / den);
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Params& p, int batch, int hq, int d,
                         cudaStream_t stream) {
  const dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  ATTN_DISPATCH_D(flash_fwd, T, d, grid, stream, p)
  return cudaGetLastError();
}

}  // namespace

// bf16 on the tensor cores (see the note at the top), beside the shared
// machinery it uses.
namespace attn::tc {
namespace {

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_tc(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Block<D> blk(p, smem);
  const int lo = blk.lo, n = blk.n;

  blk.load_q(p);
  if (n > 0) {
    load_tile<D, BK>(blk.k_stage(0), blk.kg, p.k_ss, lo, p.skv);
    load_tile<D, BK>(blk.v_stage(0), blk.vg, p.v_ss, lo, p.skv);
  }
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * LOG2E;

  for (int t = 0; t < n; ++t) {
    const int k0 = lo + t * BK;
    cp_async_wait_all();
    __syncthreads();                 // tile t landed; tile t-1 is consumed
    if (t + 1 < n) {
      load_tile<D, BK>(blk.k_stage(t + 1), blk.kg, p.k_ss, k0 + BK, p.skv);
      load_tile<D, BK>(blk.v_stage(t + 1), blk.vg, p.v_ss, k0 + BK, p.skv);
    }
    cp_async_commit();
    if (!blk.sees(k0)) continue;

    float s[BK / 2];
    qk<D>(s, blk.dq, desc_k_major(blk.k_stage(t)));
    scale_and_mask(s, p, tile_needs_mask(p, blk.r0, k0), blk.row0, k0, scale_log2);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - (mx[r] == -INFINITY ? 0.f : mx[r]));
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t pa[BK / 16][4];
    exp_pack(s, m, l, pa);
    pv<D>(o, pa, desc_mn_major<BK>(blk.v_stage(t)));
  }

  store_o<D>(o, l, p, static_cast<__nv_bfloat16*>(p.o) + blockIdx.z * p.o_sb +
                          blockIdx.y * p.o_sh, blk.row0);
}

}  // namespace
}  // namespace attn::tc

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, seq, head) for each tensor; the head dim must be contiguous.
// Returns the first CUDA error: for bf16, cudaErrorMisalignedAddress when a
// row is not 16-byte aligned, then the shared-memory attribute's; then the
// launch's cudaGetLastError().
cudaError_t flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int hq, int hkv, int d,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides,
    int causal, int window, int q_off, float scale, cudaStream_t stream) {
  const attn::Params p = attn::make_params(
      q, k, v, o, sq, skv, hq, hkv, q_strides, k_strides, v_strides,
      o_strides, causal, window, q_off, scale);
  if (dtype == 0) return launch_typed<float>(p, batch, hq, d, stream);
  if (dtype == 1) { ATTN_DISPATCH_TC(attn::tc::flash_fwd_tc, d, p, batch, hq, stream) }
  return cudaErrorInvalidValue;
}
