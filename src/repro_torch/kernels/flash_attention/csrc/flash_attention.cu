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
// This first version runs them on the fp32 CUDA cores (67 TFLOP/s), not the
// tensor cores (989 TFLOP/s bf16): simple and exact first, wgmma/TMA later.
// What the design does about the bound: it never computes a kv tile that
// the mask hides entirely (causal and window become loop bounds, halving
// the causal work), keeps K/V tiles in shared memory so each is read from
// device memory once per 32 query rows, and keeps scores, the running
// statistics and the accumulator in registers.
//
// Layout (attention_common.cuh, shared with chunked_attention.cu): one
// block per (q tile of BQ rows, q head, batch), TPR threads per row, the
// inputs read through strides in the (B, S, H, D) layout, so the caller
// never materialises a transpose; the ragged tail of S is handled by
// load/store masks, not padding. GQA: the kv head is q_head / group, K/V
// are never repeated. Head dims 32, 64, 112 (zamba2's shared attention)
// and 128.
#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd(const Params p) {
  constexpr int DPT = D / TPR;       // head dims per thread
  constexpr int NV = DPT / 4;        // float4 groups per thread
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
  int hi = p.skv;
  if (p.causal) hi = min(hi, q0 + BQ);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
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
      const bool ok = kp < p.skv && (!p.causal || kp <= qp) &&
                      (p.window <= 0 || kp > qp - p.window);
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

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, seq, head) for each tensor; the head dim must be contiguous.
// Returns the launch's cudaGetLastError().
cudaError_t flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int hq, int hkv, int d,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides,
    int causal, int window, float scale, cudaStream_t stream) {
  const attn::Params p = attn::make_params(
      q, k, v, o, sq, skv, hq, hkv, q_strides, k_strides, v_strides,
      o_strides, causal, window, scale);
  if (dtype == 0) return launch_typed<float>(p, batch, hq, d, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, batch, hq, d, stream);
  return cudaErrorInvalidValue;
}
