// Two-pass (lazy softmax) attention forward for Hopper (sm_90a), causal /
// sliding-window, GQA.
//
// Replaces the Pallas TPU kernel chunked_attention_tpu
// (src/repro/kernels/flash_attention/chunked.py). It computes the same
// function as flash_attention.cu, softmax(q k^T / sqrt(d) + mask) v, by the
// memory-efficient two-pass softmax of Rabe & Staats (arXiv:2112.05682):
//   pass 1: m = the row max of the masked scores over every reachable kv
//           tile (K only);
//   pass 2: l += sum exp(s - m), acc += exp(s - m) v over the same tiles,
//           with no rescale of acc, since m is final before pass 2 starts;
// then acc / max(l, 1e-30), so a fully masked row gives 0. It is a distinct
// implementation point, not an alias of the flash kernel: it reads K twice
// and drops the per-tile exp(m_prev - m_new) corrections, and the
// scheduler's variant axis prices the two apart.
//
// What bounds it on this card: as for the flash kernel, operations (2 S^2 d
// flops per (batch, head) at S = 2048 against ~4 S d bytes), plus the
// second pass's q.k products: ~1.5x the flash kernel's multiply-adds. The
// launcher picks the body by dtype (attention_common.cuh):
// - bf16 runs chunked_fwd_tc on the tensor cores, on the flash kernel's
//   tiles and two-stage cp.async ring: S = Q K^T by wgmma in both passes,
//   P V by wgmma in pass 2. The ring walks the 2n steps of both passes as
//   one sequence (K tiles for pass 1, K and V tiles for pass 2), so pass
//   2's first tile loads during pass 1's last. P is rounded to bf16 for
//   the product and l sums the rounded values.
// - fp32 runs chunked_fwd, the first body, on the CUDA cores: TF32
//   cannot meet the reference's 2e-5 fp32 tolerance.
// Both passes stop at the causal top and start at the window's bottom (the
// reference runs every kv chunk in both passes, chunked.py:66-84; the loop
// bounds compute the same function).
//
// Layout: the flash kernel's (strided (B, S, H, D) reads, masks instead of
// padding). Head dims 32, 64, 80, 112, 128, 224 and 256.
#include "attention_common.cuh"

namespace {

using namespace attn;

// The head dim d of the thread's c-th component of float4 group i.
__device__ __forceinline__ int dim_of(int i, int part, int c) {
  return i * 4 * TPR + part * 4 + c;
}

// The thread's slice of one query row, in fp32 (0 past the sequence end).
template <typename T, int D>
__device__ __forceinline__ void load_q(float (&qr)[D / TPR], const T* qg,
                                       int64_t q_ss, int qp, bool row_ok,
                                       int part) {
#pragma unroll
  for (int i = 0; i < D / TPR / 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qr[i * 4 + c] = row_ok ? to_f(qg[qp * q_ss + dim_of(i, part, c)]) : 0.f;
    }
  }
}

// Rows k0 .. k0+BK of a (S, D) head slice into shared memory in fp32, 0
// past the sequence end.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* g,
                                          int64_t ss, int k0, int skv) {
  constexpr int BK = simt_bk<D>();
  for (int idx = threadIdx.x; idx < BK * D; idx += NTHREADS) {
    const int j = idx / D;
    const int d = idx % D;
    const int kp = k0 + j;
    dst[j][d] = kp < skv ? to_f(g[kp * ss + d]) : 0.f;
  }
}

// Rows k0 .. k0+BK of the K and V head slices together (one index
// computation for both), as load_tile does for one.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(float (*ks)[D], float (*vs)[D],
                                             const T* kg, int64_t k_ss,
                                             const T* vg, int64_t v_ss,
                                             int k0, int skv) {
  constexpr int BK = simt_bk<D>();
  for (int idx = threadIdx.x; idx < BK * D; idx += NTHREADS) {
    const int j = idx / D;
    const int d = idx % D;
    const int kp = k0 + j;
    const bool ok = kp < skv;
    ks[j][d] = ok ? to_f(kg[kp * k_ss + d]) : 0.f;
    vs[j][d] = ok ? to_f(vg[kp * v_ss + d]) : 0.f;
  }
}

// q . k_j over the full head dim: the thread's partial sum, finished across
// the TPR threads of the row by two shuffles.
template <int D>
__device__ __forceinline__ float row_dot(const float (&qr)[D / TPR],
                                         const float (*ks)[D], int j,
                                         int part) {
  const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < D / TPR / 4; ++i) {
    const float4 kk = kr[i * TPR + part];
    dot += qr[i * 4 + 0] * kk.x;
    dot += qr[i * 4 + 1] * kk.y;
    dot += qr[i * 4 + 2] * kk.z;
    dot += qr[i * 4 + 3] * kk.w;
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  return dot;
}

// Whether query row qp (at position qp + q_off) attends to key position kp.
__device__ __forceinline__ bool visible(const Params& p, int kp, int qp) {
  const int qa = qp + p.q_off;
  return kp < p.skv && (!p.causal || kp <= qa) &&
         (p.window <= 0 || kp > qa - p.window);
}

// The kv range [lo, hi) the mask can reach from the q tile starting at q0:
// causality bounds the top, the window the bottom (the TPU kernels'
// pl.when block skip); lo is rounded down to a tile start.
template <int D>
__device__ __forceinline__ void kv_bounds(const Params& p, int q0, int& lo,
                                          int& hi) {
  constexpr int BK = simt_bk<D>();
  hi = p.skv;
  if (p.causal) hi = min(hi, q0 + p.q_off + BQ);
  lo = 0;
  if (p.window > 0) lo = max(0, q0 + p.q_off - p.window + 1);
  lo = (lo / BK) * BK;
}

// The thread's slice of acc / max(l, 1e-30) into the output row (a fully
// masked row gives 0).
template <typename T, int D>
__device__ __forceinline__ void store_row(const float (&acc)[D / TPR],
                                          float l, T* og, int part) {
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / TPR / 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      og[dim_of(i, part, c)] = from_f<T>(acc[i * 4 + c] / den);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) chunked_fwd(const Params p) {
  constexpr int DPT = D / TPR;       // head dims per thread
  constexpr int BK = simt_bk<D>();
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int qp = q0 + row;
  const bool row_ok = qp < p.sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (h / p.group) * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (h / p.group) * p.v_sh;

  float qr[DPT];
  load_q<T, D>(qr, qg, p.q_ss, qp, row_ok, part);
  int lo, hi;
  kv_bounds<D>(p, q0, lo, hi);

  // pass 1: the row max over every reachable kv tile
  float m = NEG;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    load_tile<T, D>(ks, kg, p.k_ss, k0, p.skv);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dot = row_dot<D>(qr, ks, j, part);
      if (visible(p, k0 + j, qp)) m = fmaxf(m, dot * p.scale);
    }
  }

  // pass 2: sum and accumulate against the final max, no rescale
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
  float l = 0.f;
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    load_kv_tile<T, D>(ks, vs, kg, p.k_ss, vg, p.v_ss, k0, p.skv);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dot = row_dot<D>(qr, ks, j, part);
      const float e = visible(p, k0 + j, qp) ? expf(dot * p.scale - m) : 0.f;
      l += e;
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int i = 0; i < DPT / 4; ++i) {
        const float4 vv = vr[i * TPR + part];
        acc[i * 4 + 0] += e * vv.x;
        acc[i * 4 + 1] += e * vv.y;
        acc[i * 4 + 2] += e * vv.z;
        acc[i * 4 + 3] += e * vv.w;
      }
    }
  }

  if (row_ok) {
    store_row<T, D>(acc, l, static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
                                qp * p.o_ss, part);
  }
}

template <typename T>
cudaError_t launch_typed(const Params& p, int batch, int hq, int d,
                         cudaStream_t stream) {
  const dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  ATTN_DISPATCH_D(chunked_fwd, T, d, grid, stream, p)
  return cudaGetLastError();
}

}  // namespace

// bf16 on the tensor cores (see the note at the top), beside the shared
// machinery it uses.
namespace attn::tc {
namespace {

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) chunked_fwd_tc(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Block<D> blk(p, smem);
  const int lo = blk.lo, n = blk.n;

  // step st < n is pass 1 over tile st (K only), st >= n pass 2 over tile
  // st - n (K and V)
  blk.load_q(p);
  if (n > 0) load_tile<D, BK>(blk.k_stage(0), blk.kg, p.k_ss, lo, p.skv);
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // this thread's share until pass 2
  float l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * LOG2E;

  for (int st = 0; st < 2 * n; ++st) {
    const bool second = st >= n;
    const int k0 = lo + (second ? st - n : st) * BK;
    cp_async_wait_all();
    __syncthreads();                 // step st landed; step st-1 is consumed
    if (st + 1 < 2 * n) {
      const int next = st + 1;
      const int nk0 = lo + (next >= n ? next - n : next) * BK;
      load_tile<D, BK>(blk.k_stage(next), blk.kg, p.k_ss, nk0, p.skv);
      if (next >= n) load_tile<D, BK>(blk.v_stage(next), blk.vg, p.v_ss, nk0, p.skv);
    }
    cp_async_commit();
    if (st == n) {                   // pass 1 is over: the row max is final
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
    }
    if (!blk.sees(k0)) continue;

    float s[BK / 2];
    qk<D>(s, blk.dq, desc_k_major(blk.k_stage(st)));
    scale_and_mask(s, p, tile_needs_mask(p, blk.r0, k0), blk.row0, k0, scale_log2);
    if (!second) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
      continue;
    }
    uint32_t pa[BK / 16][4];
    exp_pack(s, m, l, pa);
    pv<D>(o, pa, desc_mn_major<BK>(blk.v_stage(st)));
  }

  store_o<D>(o, l, p, static_cast<__nv_bfloat16*>(p.o) + blockIdx.z * p.o_sb +
                          blockIdx.y * p.o_sh, blk.row0);
}

}  // namespace
}  // namespace attn::tc

// Same interface as flash_attention_fwd_launch: dtype 0 = float32,
// 1 = bfloat16; element strides ordered (batch, seq, head), head dim
// contiguous. Returns the first CUDA error, as flash_attention_fwd_launch.
cudaError_t chunked_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int hq, int hkv, int d,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides,
    int causal, int window, int q_off, float scale, cudaStream_t stream) {
  const attn::Params p = attn::make_params(
      q, k, v, o, sq, skv, hq, hkv, q_strides, k_strides, v_strides,
      o_strides, causal, window, q_off, scale);
  if (dtype == 0) return launch_typed<float>(p, batch, hq, d, stream);
  if (dtype == 1) { ATTN_DISPATCH_TC(attn::tc::chunked_fwd_tc, d, p, batch, hq, stream) }
  return cudaErrorInvalidValue;
}
