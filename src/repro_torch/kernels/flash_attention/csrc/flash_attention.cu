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
// - bf16, the serving dtype, runs flash_fwd_tc on the tensor cores in
//   Hopper's producer/consumer shape. One persistent block an SM walks a
//   list of (128 query rows, head, batch) items: groups of (head, batch)
//   pairs whose K/V fits L2, each with its longest causal rows first,
//   dealt to the blocks in rounds that alternate direction, so no partial
//   last wave idles the card. In each block a producer warpgroup (registers
//   lowered to 24) has one thread keep TMA loads in flight: the Q tile, then
//   K and V tiles of 128 rows (64 at D = 224 and 256) into a two-stage ring
//   of 128-byte-swizzled shared tiles, with separate full and empty
//   mbarriers for K and V, so S = Q K^T waits for K alone; TMA fills rows
//   past S and columns past D with zeros, so no load is masked. Two
//   consumer warpgroups of 64 query rows (registers raised to 240) take
//   turns to issue their wgmma products (named barriers), so one's softmax
//   runs while the other's products do; within a warpgroup, S of tile j is
//   issued beside O += P V of tile j - 1. The softmax runs on the
//   accumulator fragment: the mask (only on tiles it cuts: the causal
//   diagonal, the window's edge, the ragged end) is one unsigned compare a
//   score against the row's key range, the scale folds into the exponent's
//   FFMA, ex2 is the hardware's. P is rounded to bf16 for the product and
//   l sums the rounded values, so the normaliser and the weights of V
//   agree. The tensor maps are encoded on the host at each call, with no
//   allocation and no synchronisation.
// - fp32 runs flash_fwd, the first body, on the CUDA cores: TF32
//   cannot meet the reference's 2e-5 fp32 tolerance.
// Both never compute a kv tile the mask hides entirely: causal and window
// become loop bounds, halving the causal work.
//
// Layout: the inputs are read through strides in the (B, S, H, D) layout,
// so the caller never materialises a transpose; the ragged tail of S is
// handled by load/store masks (in the bf16 body, TMA's zero fill), not
// padding. GQA: the kv head is
// q_head / group, K/V are never repeated. Head dims 32, 64, 80 (stablelm-3b),
// 112 (the zamba2 variant's shared attention), 128, 224 (Zyphra's zamba2)
// and 256 (gemma3; the fp32 body's K/V tiles have 16 rows at 224 and 256,
// attention_common.cuh).
#include "attention_common.cuh"
#include "../../csrc/tma.cuh"

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

// bf16 on the tensor cores (see the note at the top): Hopper's producer /
// consumer shape. The tiles, masks, online softmax and epilogue are those of
// attention_common.cuh's tc namespace; the ring, the schedule and the
// warpgroups' roles are this kernel's own.
namespace attn::tc {
namespace {

constexpr int CONSUMERS = 2;                       // warpgroups of 64 query rows
constexpr int WS_THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr int STAGES = 2;                          // K/V ring depth
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;      // arrivals that free a slot
constexpr int PRODUCER_REGS = 24;                  // 128 x 24 + 256 x 240 of
constexpr int CONSUMER_REGS = 240;                 // the SM's 65,536
constexpr int TURN_BAR = 1;                        // named barriers 1 and 2

// kv rows of a ring stage: 128 up to D = 128 (one online-softmax rescale
// per 128 keys); 64 at D = 224 and 256, where the Q tile (64 KB) and two
// stages of K and V (128 KB) fill 193 KB of the 227.
template <int D>
__host__ __device__ constexpr int kv_rows() { return D <= 128 ? 128 : 64; }

// The block's dynamic shared memory, 1024-byte aligned: the Q tile, then
// stage s's K tile at kv + 2 s kv_bytes and its V tile after it, then the
// mbarriers: Q full and empty, then K full, K empty, V full and V empty for
// every stage.
template <int D>
struct Ring {
  static constexpr int BK = kv_rows<D>();
  static constexpr int Q_BYTES = tile_bytes<D>(BQ);
  static constexpr int KV_BYTES = tile_bytes<D>(BK);
  static constexpr int BARS = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = BARS + 8 * (2 + 4 * STAGES) + 1024;
  uint32_t base;

  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + Q_BYTES + s * 2 * KV_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + KV_BYTES; }
  __device__ uint32_t q_full() const { return base + BARS; }
  __device__ uint32_t q_empty() const { return base + BARS + 8; }
  __device__ uint32_t k_full(int s) const { return base + BARS + 16 + 8 * s; }
  __device__ uint32_t k_empty(int s) const { return k_full(STAGES + s); }
  __device__ uint32_t v_full(int s) const { return k_full(2 * STAGES + s); }
  __device__ uint32_t v_empty(int s) const { return k_full(3 * STAGES + s); }

  // Full barriers take the producer's one arrival and its bytes; empty
  // ones an arrival from each consumer warp.
  __device__ void init() const {
    mbar_init(q_full(), 1);
    mbar_init(q_empty(), CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMER_WARPS);
      mbar_init(v_empty(s), CONSUMER_WARPS);
    }
  }
};

// What a launch carries: the tensor maps of q, k and v (boxes of one
// 64-column swizzle atom by BQ or kv_rows rows of one head, over the
// (B, S, H, D) strides), the shared parameters, and the work list's shape.
struct Args {
  CUtensorMap q, k, v;
  Params p;
  int heads, batch, q_tiles, items;
  int group_pairs;                   // (head, batch) pairs a group of the list
};

// Work item t: a (query tile, head, batch). The list runs through groups of
// group_pairs (head, batch) pairs, heads fastest, few enough that a group's
// K/V stays in L2 while the blocks work on it; within a group, the last
// query tiles come first (the longest causal rows), every pair's before the
// tile above it.
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item(const Args& a, int t) {
  const int pairs = a.heads * a.batch, span = a.group_pairs * a.q_tiles;
  const int g = t / span, first = g * a.group_pairs;
  const int size = min(a.group_pairs, pairs - first), r = t - g * span;
  const int qt = r / size, pair = first + (r - qt * size);
  return {(a.q_tiles - 1 - qt) * BQ, pair % a.heads, pair / a.heads};
}

// This block's item of round r: the persistent blocks deal the list out in
// rounds of gridDim.x items, forwards in even rounds and backwards in odd
// ones, so the blocks that drew the longest items of one round draw the
// shortest of the next.
__device__ __forceinline__ int item_index(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The kv tiles of BK rows, from lo, that the query tile at q0 reaches.
template <int BK>
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int& lo) {
  int hi;
  reach(p, q0, BQ, lo, hi);
  lo = lo / BK * BK;
  return hi > lo ? (hi - lo + BK - 1) / BK : 0;
}

// Whether the mask cuts the tile of BK keys from k0 for the 64 rows from r0.
template <int BK>
__device__ __forceinline__ bool cuts(const Params& p, int r0, int k0) {
  const int a0 = r0 + p.q_off;
  return k0 + BK > p.skv || (p.causal && k0 + BK - 1 > a0) ||
         (p.window > 0 && k0 <= a0 + 63 - p.window);
}

// The producer: one thread walks the block's items and keeps the ring full.
// Each tile is one TMA box a 64-column atom; rows past S and columns past D
// arrive as zeros.
template <int D>
__device__ __forceinline__ void produce(const Args& a, const Ring<D>& ring) {
  constexpr int BK = Ring<D>::BK, ATOMS = padded<D>() / 64;
  int stage = 0, parity = 1, q_parity = 1;   // every slot starts empty
  for (int r = 0; r * static_cast<int>(gridDim.x) < a.items; ++r) {
    const int t = item_index(r);
    if (t >= a.items) continue;
    const Item w = item(a, t);
    int lo;
    const int n = kv_tiles<BK>(a.p, w.q0, lo);
    if (n == 0) continue;
    const int hkv = w.h / a.p.group;
    mbar_wait(ring.q_empty(), q_parity);
    q_parity ^= 1;
    mbar_expect_tx(ring.q_full(), Ring<D>::Q_BYTES);
    for (int c = 0; c < ATOMS; ++c)
      tma_load_4d(ring.q() + c * BQ * 128, a.q, ring.q_full(), 64 * c, w.q0, w.h, w.b);
    for (int j = 0; j < n; ++j) {
      const int k0 = lo + j * BK;
      mbar_wait(ring.k_empty(stage), parity);
      mbar_expect_tx(ring.k_full(stage), Ring<D>::KV_BYTES);
      for (int c = 0; c < ATOMS; ++c)
        tma_load_4d(ring.k(stage) + c * BK * 128, a.k, ring.k_full(stage), 64 * c, k0, hkv, w.b);
      mbar_wait(ring.v_empty(stage), parity);
      mbar_expect_tx(ring.v_full(stage), Ring<D>::KV_BYTES);
      for (int c = 0; c < ATOMS; ++c)
        tma_load_4d(ring.v(stage) + c * BK * 128, a.v, ring.v_full(stage), 64 * c, k0, hkv, w.b);
      if (++stage == STAGES) { stage = 0; parity ^= 1; }
    }
  }
}

// S = Q K^T over the head dim (D / 16 k-steps; the padding is never read),
// issued, not waited for.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (BK == 128)
      wgmma_ss_n128(s, dq + k_step<BQ>(kk), dk + k_step<BK>(kk), kk);
    else
      wgmma_ss_n64(s, dq + k_step<BQ>(kk), dk + k_step<BK>(kk), kk);
  }
  wgmma_commit();
}

// O += P V over a kv tile (BK / 16 k-steps of 16 rows, 128 descriptor
// units each), issued, not waited for.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, pa[kk], dv + 128 * kk);
  wgmma_commit();
}

// Keep P's fragments in their registers until the product reading them is
// waited for.
template <int K>
__device__ __forceinline__ void hold(uint32_t (&pa)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(pa[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The keys this thread's two query rows see: [from, from + width), from the
// window's lower edge to the causal edge or the end of the keys.
struct Rows {
  int from[2], width[2];

  __device__ Rows(const Params& p, int row0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = row0 + 8 * h + p.q_off;
      const int hi = p.causal ? min(p.skv, qp + 1) : p.skv;
      from[h] = p.window > 0 ? max(0, qp - p.window + 1) : 0;
      width[h] = max(hi - from[h], 0);
    }
  }

  // -inf for the scores of a tile from key k0 that lie outside the rows'
  // keys: one unsigned compare a score, no branch.
  template <int NS>
  __device__ __forceinline__ void mask(float (&s)[NS], int k0) const {
    const int c0 = k0 + 2 * (threadIdx.x & 3);
    const int off[2] = {c0 - from[0], c0 - from[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      const unsigned k = static_cast<unsigned>(off[h] + 8 * (i >> 2) + (i & 1));
      s[i] = k < static_cast<unsigned>(width[h]) ? s[i] : -INFINITY;
    }
  }
};

// The softmax of one tile of raw scores s for this thread's two rows: the
// new running max m, the factor corr = 2^((m_old - m_new) scale_log2) that
// rescales what was summed before (a row whose max is still -inf takes 0
// as its base), P = 2^(s scale_log2 - m scale_log2) (one FFMA and one ex2 a
// score) rounded to bf16 and packed as P V's A fragments, and l rescaled
// and given the sum of the rounded values, so the normaliser sums exactly
// the P that multiplies V.
template <int NS>
__device__ __forceinline__ void softmax(const float (&s)[NS], float scale_log2, float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        uint32_t (&pb)[NS / 8][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float nb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    const float base = mx[h] == -INFINITY ? 0.f : mx[h];
    corr[h] = ex2((m[h] - base) * scale_log2);
    nb[h] = -base * scale_log2;
    m[h] = mx[h];
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {    // r: (column block 2kk + r / 2, row +8 (r % 2))
      const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
      const uint32_t packed = pack_bf16(ex2(fmaf(s[i], scale_log2, nb[r & 1])),
                                        ex2(fmaf(s[i + 1], scale_log2, nb[r & 1])));
      sum[r & 1][kk & 1] += __uint_as_float(packed << 16) + __uint_as_float(packed & 0xffff0000u);
      pb[kk][r] = packed;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + (sum[h][0] + sum[h][1]);
}

// A consumer warpgroup: 64 query rows of each of the block's items. The two
// warpgroups take turns to issue their products (named barriers TURN_BAR +
// wg), so one's softmax runs while the other's products do. Within a
// warpgroup, S of tile j is issued, O is rescaled by tile j - 1's factor,
// and P V of tile j - 1 is issued beside it; once S has landed the mask
// runs while that product does, and the softmax of tile j writes its P into
// a second set of fragments, taken over once the product is done. (At
// D = 128 ptxas places the product's wait ahead of the softmax, and one set
// of fragments is as fast; at D = 256 it is 13 % slower.)
template <int D>
__device__ __forceinline__ void consume(const Args& a, const Ring<D>& ring, int wg) {
  constexpr int BK = Ring<D>::BK, NS = BK / 2;
  const Params& p = a.p;
  const bool signals = (threadIdx.x & 31) == 0;   // one arrival a warp
  const uint64_t dq = desc_k_major(ring.q() + wg * 64 * 128);
  const float scale_log2 = p.scale * LOG2E;
  const int mine = TURN_BAR + wg, other = TURN_BAR + 1 - wg;
  int stage = 0, parity = 0, q_parity = 0;
  if (wg == 1) named_arrive(TURN_BAR, 256);       // warpgroup 0 goes first

  for (int r = 0; r * static_cast<int>(gridDim.x) < a.items; ++r) {
    const int t = item_index(r);
    if (t >= a.items) continue;
    const Item w = item(a, t);
    int lo;
    const int n = kv_tiles<BK>(p, w.q0, lo);
    const int r0 = w.q0 + 64 * wg;
    const int row0 = r0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    if (n > 0) {
      const Rows rows(p, row0);
      float s[NS], corr[2];
      uint32_t pa[BK / 16][4], pb[BK / 16][4];
      mbar_wait(ring.q_full(), q_parity);
      q_parity ^= 1;

      // tile 0: S alone
      mbar_wait(ring.k_full(stage), parity);
      named_sync(mine, 256);
      wgmma_fence();
      issue_qk<D, BK>(s, dq, desc_k_major(ring.k(stage)));
      named_arrive(other, 256);
      wgmma_wait_upto<0>();
      fence_regs(s);
      if (signals) {
        mbar_arrive(ring.k_empty(stage));
        if (n == 1) mbar_arrive(ring.q_empty());
      }
      if (cuts<BK>(p, r0, lo)) rows.mask(s, lo);
      softmax(s, scale_log2, m, l, corr, pa);
      int vstage = stage, vparity = parity;
      if (++stage == STAGES) { stage = 0; parity ^= 1; }

      // tiles 1 .. n-1: S of tile j beside P V of tile j - 1
      for (int j = 1; j < n; ++j) {
        const int k0 = lo + j * BK;
        mbar_wait(ring.k_full(stage), parity);
        mbar_wait(ring.v_full(vstage), vparity);
        named_sync(mine, 256);
        wgmma_fence();
        issue_qk<D, BK>(s, dq, desc_k_major(ring.k(stage)));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        fence_regs(o);
        wgmma_fence();
        issue_pv<D, BK>(o, pa, desc_mn_major<BK>(ring.v(vstage)));
        named_arrive(other, 256);
        wgmma_wait_upto<1>();
        fence_regs(s);
        if (signals) {
          mbar_arrive(ring.k_empty(stage));
          if (j == n - 1) mbar_arrive(ring.q_empty());
        }
        if (cuts<BK>(p, r0, k0)) rows.mask(s, k0);
        softmax(s, scale_log2, m, l, corr, pb);
        hold(pb);
        wgmma_wait_upto<0>();
        fence_regs(o);
        hold(pa);
        if (signals) mbar_arrive(ring.v_empty(vstage));
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pb[kk][e];
        vstage = stage;
        vparity = parity;
        if (++stage == STAGES) { stage = 0; parity ^= 1; }
      }

      // the last tile's P V
      mbar_wait(ring.v_full(vstage), vparity);
      named_sync(mine, 256);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      fence_regs(o);
      wgmma_fence();
      issue_pv<D, BK>(o, pa, desc_mn_major<BK>(ring.v(vstage)));
      named_arrive(other, 256);
      wgmma_wait_upto<0>();
      fence_regs(o);
      hold(pa);
      if (signals) mbar_arrive(ring.v_empty(vstage));
    }

    store_o<D>(o, l, p, static_cast<__nv_bfloat16*>(p.o) + w.b * p.o_sb + w.h * p.o_sh,
               row0);
  }
}

// One persistent block an SM: two consumer warpgroups (registers raised to
// 240) and a producer warpgroup (lowered to 24) of which one thread issues
// the TMA loads. The roles split once and never rejoin.
template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1) flash_fwd_tc(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Ring<D> ring{(smem_addr(smem) + 1023) & ~1023u};
  if (threadIdx.x == 0) {
    ring.init();
    fence_barrier_init();
  }
  __syncthreads();
  // the warpgroup index, read from lane 0 so the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    regs_lower<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) produce<D>(a, ring);
  } else {
    regs_raise<CONSUMER_REGS>();
    consume<D>(a, ring, wg);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the CUDA runtime's
// entry-point query (so the extension need not link libcuda); null where it
// is missing.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 (B, S, H, D) tensor with element strides ss, sh,
// sb (D contiguous), read in boxes of 64 columns by `rows` rows of one head
// into the 128-byte swizzle; what lies past S or D reads as zeros. Host
// work only: no allocation, no synchronisation.
bool encode(CUtensorMap* map, const void* ptr, int d, int s, int h, int b, int64_t ss,
            int64_t sh, int64_t sb, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Launch flash_fwd_tc<D>: encode the three tensor maps, opt into the
// block's dynamic shared memory, and start one block an SM (fewer where the
// list is shorter). Returns the first CUDA error.
template <int D>
cudaError_t launch_ws(const Params& p, int batch, int hq, cudaStream_t stream) {
  if (!aligned16(p)) return cudaErrorMisalignedAddress;
  Args a;
  a.p = p;
  a.heads = hq;
  a.batch = batch;
  a.q_tiles = (p.sq + BQ - 1) / BQ;
  const int64_t items = static_cast<int64_t>(a.q_tiles) * hq * batch;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  a.items = static_cast<int>(items);
  const int hkv = hq / p.group;
  // a group of the work list: the (head, batch) pairs whose K/V (read by
  // each of a pair's query tiles, shared by a GQA group) fill L2, a whole
  // number of GQA groups
  int dev = 0, sms = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  const int64_t pair_bytes = 4LL * p.skv * padded<D>() / p.group;
  const int64_t fit = l2 / (pair_bytes > 0 ? pair_bytes : 1);
  const int64_t pairs = static_cast<int64_t>(hq) * batch;
  int64_t group = fit >= p.group ? fit / p.group * p.group : (fit > 0 ? fit : 1);
  a.group_pairs = static_cast<int>(group < pairs ? group : pairs);
  if (!encode(&a.q, p.q, D, p.sq, hq, batch, p.q_ss, p.q_sh, p.q_sb, BQ) ||
      !encode(&a.k, p.k, D, p.skv, hkv, batch, p.k_ss, p.k_sh, p.k_sb, Ring<D>::BK) ||
      !encode(&a.v, p.v, D, p.skv, hkv, batch, p.v_ss, p.v_sh, p.v_sb, Ring<D>::BK))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<D>::BYTES);
  if (err != cudaSuccess) return err;
  flash_fwd_tc<D><<<a.items < sms ? a.items : sms, WS_THREADS, Ring<D>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attn::tc

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, seq, head) for each tensor; the head dim must be contiguous.
// Returns the first CUDA error: for bf16, cudaErrorMisalignedAddress when a
// row is not 16-byte aligned, cudaErrorInvalidValue when a tensor map
// cannot be encoded, then the shared-memory attribute's; then the launch's
// cudaGetLastError().
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
  if (dtype == 1) {
    switch (d) {
      case 32: return attn::tc::launch_ws<32>(p, batch, hq, stream);
      case 64: return attn::tc::launch_ws<64>(p, batch, hq, stream);
      case 80: return attn::tc::launch_ws<80>(p, batch, hq, stream);
      case 112: return attn::tc::launch_ws<112>(p, batch, hq, stream);
      case 128: return attn::tc::launch_ws<128>(p, batch, hq, stream);
      case 224: return attn::tc::launch_ws<224>(p, batch, hq, stream);
      case 256: return attn::tc::launch_ws<256>(p, batch, hq, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
