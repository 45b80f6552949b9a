// Definitions shared by the two attention kernels of the port
// (flash_attention.cu: one pass, online softmax; chunked_attention.cu: two
// passes, lazy softmax). Both compute softmax(q k^T / sqrt(d) + mask) v for
// q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), causal and/or sliding window,
// GQA, reading the inputs through element strides in the (B, S, H, D)
// layout with the last dim contiguous; ragged tails are load and store
// masks, not padding. Each kernel has two bodies, chosen by dtype in its
// launcher:
//
// fp32, the SIMT body (namespace attn): one block per (q tile of BQ rows,
// q head, batch), TPR threads per query row, each owning an interleaved
// D/TPR slice of the head dim (dims i*4*TPR + part*4 + c), so K/V rows are
// read from shared memory as conflict-free float4s and a row's dot product
// is finished with two warp shuffles. fp32 stays on the CUDA cores: TF32
// tensor cores keep ~3 decimal digits and cannot meet the reference's 2e-5
// fp32 tolerance, and fp32 is the verification dtype, not the serving one.
//
// bf16, the tensor-core body (namespace attn::tc): Hopper's warpgroup MMA
// (wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate). One block of NWG
// consumer warpgroups owns BQ = 64 * NWG query rows; the Q tile is copied
// to shared memory once, and K/V tiles of BK rows stream through a
// two-stage ring filled by cp.async (16 bytes a thread), so tile j+1 loads
// while tile j's products run. S = Q K^T takes both operands from shared
// memory (K is D-contiguous: the K-major B operand); O += P V takes P from
// registers (the S accumulator converted to bf16 in place: the fp32
// accumulator fragment and the bf16 A fragment order their elements
// alike) and V from shared memory (D-contiguous: the MN-major B operand,
// transpose bit set). Shared tiles use the 128-byte swizzle: 64-column
// atoms of 128-byte rows, each row's 16-byte chunks permuted by the row
// index mod 8, so that a warp's copies read whole rows from device memory
// and fill shared memory without bank conflicts (the unswizzled layout of
// 8 x 16-byte core matrices makes a warp either read eight rows at once or
// write eight times into the same banks). D = 112 (224 bytes a row),
// D = 80 (stablelm-3b, 160 bytes) and D = 32 do not fill their last atom:
// the tile is padded to 128, 128 and 64 columns, the padding zeroed once
// and never read (D = 80 runs 5 k-steps of Q K^T and one m64n80k16 for
// P V). D = 256 (gemma3) spans
// four atoms: its tiles take 197.6 KB of shared memory a block, and a
// thread holds the 64 x 256 fp32 O fragment of its warpgroup in 128
// registers (P V is one m64n256k16, the widest N wgmma takes). D = 224
// (Zyphra's zamba2, 448 bytes a row) pads to D = 256's four atoms and
// shared memory, runs 14 k-steps of Q K^T and one m64n224k16 for P V, and
// holds 112 O registers a thread. That is the two-pass kernel's body
// (chunked_fwd_tc) as a whole; the flash kernel's (flash_attention.cu)
// shares its swizzled tile layout, masks, online softmax and epilogue, and
// fills its tiles by TMA in the producer/consumer shape, with its own tile
// rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/dtype.cuh"
#include "../../csrc/wgmma.cuh"

namespace attn {

constexpr int BQ = 32;               // query rows per block
constexpr int TPR = 4;               // threads per query row
constexpr int NTHREADS = BQ * TPR;   // 128
constexpr float NEG = -1e30f;

// kv rows per shared-memory tile: 32, or 16 at D = 224 and 256, so that the fp32 K
// and V tiles (2 * BK * D * 4 bytes: 32 KB either way) stay within the
// 48 KB of static shared memory.
template <int D>
__host__ __device__ constexpr int simt_bk() { return D > 128 ? 16 : 32; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;          // element strides (batch, seq, head)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, skv, group, causal, window;
  int q_off;                         // absolute position of query row 0
  float scale;
};

inline Params make_params(const void* q, const void* k, const void* v,
                          void* o, int sq, int skv, int hq, int hkv,
                          const int64_t* q_strides, const int64_t* k_strides,
                          const int64_t* v_strides, const int64_t* o_strides,
                          int causal, int window, int q_off, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_strides[0]; p.q_ss = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.o_sb = o_strides[0]; p.o_ss = o_strides[1]; p.o_sh = o_strides[2];
  p.sq = sq; p.skv = skv; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.q_off = q_off; p.scale = scale;
  return p;
}

// Launch kernel<T, D> for the head dims both kernels instantiate.
#define ATTN_DISPATCH_D(KERNEL, T, d, grid, stream, p)                      \
  switch (d) {                                                              \
    case 32: KERNEL<T, 32><<<grid, attn::NTHREADS, 0, stream>>>(p); break;  \
    case 64: KERNEL<T, 64><<<grid, attn::NTHREADS, 0, stream>>>(p); break;  \
    case 80: KERNEL<T, 80><<<grid, attn::NTHREADS, 0, stream>>>(p); break;  \
    case 112: KERNEL<T, 112><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    case 128: KERNEL<T, 128><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    case 224: KERNEL<T, 224><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    case 256: KERNEL<T, 256><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    default: return cudaErrorInvalidValue;                                  \
  }


// ---------------------------------------------------------------- tensor cores
namespace tc {

using namespace hopper;   // swizzle, descriptors, wgmma (../../csrc/wgmma.cuh)

constexpr int NWG = 2;               // consumer warpgroups per block
constexpr int BQ = 64 * NWG;         // query rows per block
constexpr int BK = 64;               // kv rows per ring stage
constexpr int NTHREADS = 128 * NWG;
constexpr float LOG2E = 1.4426950408889634f;

// Head dims are stored padded to whole 64-column swizzle atoms (32 -> 64,
// 80 and 112 -> 128, 224 -> 256). The padding is zeroed and never read: the k-steps of
// S = Q K^T stop at D, and P V's N is D.
template <int D>
__host__ __device__ constexpr int padded() { return (D + 63) / 64 * 64; }

// Bytes of a tile of `rows` rows.
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * padded<D>() * 2; }

// Dynamic shared memory of one block: the Q tile, two stages of K and V,
// and 1 KB to align the tiles to the swizzle pattern's 1024 bytes.
template <int D>
__host__ __device__ constexpr int smem_bytes() { return tile_bytes<D>(BQ + 4 * BK) + 1024; }

// Rows r0 .. r0+ROWS of a (S, D) bf16 head slice with row stride ss (in
// elements) into the swizzled tile at shared address dst, 16 bytes a copy;
// rows at or past `valid` are zero-filled (source size 0). Consecutive
// threads copy consecutive 16 bytes of a row (coalesced reads), and eight
// of them fill one 128-byte row of the tile (no bank conflict).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g,
                                          int64_t ss, int r0, int valid) {
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx - r * CHUNKS;
    const int ok = r0 + r < valid;
    const __nv_bfloat16* src = g + (ok ? r0 + r : 0) * ss + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst + swizzled<ROWS>(r, c)), "l"(src), "r"(ok ? 16 : 0));
  }
}

// Zero the padding chunks of a tile of ROWS rows (none where D fills its
// atoms).
template <int D, int ROWS>
__device__ __forceinline__ void zero_pad(uint32_t dst) {
  constexpr int PAD = (padded<D>() - D) / 8;
  if constexpr (PAD > 0) {
    for (int idx = threadIdx.x; idx < ROWS * PAD; idx += NTHREADS) {
      const int r = idx / PAD;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n"
                   :: "r"(dst + swizzled<ROWS>(r, D / 8 + idx - r * PAD)), "r"(0));
    }
  }
}

// Whether any (query row, kv position) pair of the 64 rows from r0 and the
// BK positions from k0 is masked: only such tiles pay for the mask. Query
// row r sits at position r + q_off.
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int r0,
                                                int k0) {
  const int a0 = r0 + p.q_off;
  return k0 + BK > p.skv || (p.causal && k0 + BK - 1 > a0) ||
         (p.window > 0 && k0 <= a0 + 63 - p.window);
}

// The kv range [lo, hi) the mask can reach from the `rows` query rows at
// q0 (positions from q0 + q_off): causality bounds the top, the window the
// bottom.
__device__ __forceinline__ void reach(const Params& p, int q0, int rows,
                                      int& lo, int& hi) {
  const int a0 = q0 + p.q_off;
  hi = p.causal ? min(p.skv, a0 + rows) : p.skv;
  lo = p.window > 0 ? max(0, a0 - p.window + 1) : 0;
}

// Scores of one tile in the log2 domain for this thread's values:
// s * scale * log2(e), -inf where the mask hides the pair.
template <int NS>
__device__ __forceinline__ void scale_and_mask(float (&s)[NS], const Params& p,
                                               bool masked, int row0, int k0,
                                               float scale_log2) {
  const int col0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float v = s[i] * scale_log2;
    if (masked) {
      const int qp = row0 + 8 * ((i >> 1) & 1) + p.q_off;
      const int kp = col0 + 8 * (i >> 2) + (i & 1);
      const bool ok = kp < p.skv && (!p.causal || kp <= qp) &&
                      (p.window <= 0 || kp > qp - p.window);
      v = ok ? v : -INFINITY;
    }
    s[i] = v;
  }
}

// The row max over the quad of threads that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// P = 2^(s - m) for this thread's values (0 where s is -inf; a row whose
// max is still -inf subtracts 0), rounded to bf16 and packed as the A
// fragments of P V; l gains the sum of the rounded values, so the
// normaliser sums exactly the P that multiplies V.
template <int NS>
__device__ __forceinline__ void exp_pack(const float (&s)[NS], const float (&m)[2],
                                         float (&l)[2],
                                         uint32_t (&pa)[NS / 8][4]) {
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) base[h] = m[h] == -INFINITY ? 0.f : m[h];
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {    // r: (column block 2kk + r / 2, row +8 (r % 2))
      const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
      const float lo = exp2f(s[i] - base[r & 1]);
      const float hi = exp2f(s[i + 1] - base[r & 1]);
      const uint32_t packed = pack_bf16(lo, hi);
      const __nv_bfloat162 rounded = *reinterpret_cast<const __nv_bfloat162*>(&packed);
      const float2 f = __bfloat1622float2(rounded);
      l[r & 1] += f.x + f.y;
      pa[kk][r] = packed;
    }
  }
}

// S = Q K^T for one warpgroup over the head dim (D / 16 k-steps), waited
// for.
template <int D>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint64_t dq, uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, dq + k_step<BQ>(kk), dk + k_step<BK>(kk), kk);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// O += P V for one warpgroup over a kv tile (BK / 16 k-steps of 16 rows,
// 2048 bytes = 128 descriptor units each), waited for.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                   uint64_t dv) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, pa[kk], dv + 128 * kk);
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
}

// What one block of a bf16 body works on: its shared tiles (1024-byte
// aligned: the Q tile, then two stages of a K and a V tile), its head's
// slices of q, k and v, its warpgroup's rows, and the n kv tiles from lo
// that the mask lets its rows reach. The query tiles run in reverse, the
// longest causal rows first.
template <int D>
struct Block {
  static constexpr int TILE = tile_bytes<D>(BK);  // bytes of one K or V stage
  uint32_t q_s, kv_s;
  const __nv_bfloat16 *qg, *kg, *vg;
  int q0, r0, row0, lo, n, wlo, whi;
  uint64_t dq;                       // this warpgroup's rows of the Q tile

  __device__ Block(const Params& p, unsigned char* smem) {
    q_s = (smem_addr(smem) + 1023) & ~1023u;
    kv_s = q_s + tile_bytes<D>(BQ);
    // the warpgroup index, read from lane 0 so the compiler sees it uniform
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int h = blockIdx.y, b = blockIdx.z, hkv = h / p.group;
    qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hkv * p.k_sh;
    vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hkv * p.v_sh;
    q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    r0 = q0 + 64 * wg;
    row0 = r0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
    int hi;
    reach(p, q0, BQ, lo, hi);
    reach(p, r0, 64, wlo, whi);
    lo = lo / BK * BK;
    n = hi > lo ? (hi - lo + BK - 1) / BK : 0;
    dq = desc_k_major(q_s + wg * 64 * 128);  // rows 64 wg .. of each atom
  }

  // Zero every tile's padding and start copying the Q tile.
  __device__ void load_q(const Params& p) const {
    zero_pad<D, BQ>(q_s);
    for (int st = 0; st < 4; ++st) zero_pad<D, BK>(kv_s + st * TILE);
    load_tile<D, BQ>(q_s, qg, p.q_ss, q0, p.sq);
  }

  __device__ uint32_t k_stage(int st) const { return kv_s + (st & 1) * 2 * TILE; }
  __device__ uint32_t v_stage(int st) const { return k_stage(st) + TILE; }

  // Whether some row of this warpgroup sees the kv tile at k0.
  __device__ bool sees(int k0) const { return k0 < whi && k0 + BK > wlo; }
};

// O / max(l, 1e-30) into the output rows (a fully masked row gives 0);
// this thread's two rows and D / 4 columns, rows past Sq skipped.
template <int D>
__device__ __forceinline__ void store_o(const float (&o)[D / 2], const float (&l)[2],
                                        const Params& p, __nv_bfloat16* og,
                                        int row0) {
  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row0 + 8 * h;
    if (qp >= p.sq) continue;
    const float inv = 1.f / fmaxf(lsum[h], 1e-30f);
    __nv_bfloat16* orow = og + qp * p.o_ss + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// 16-byte copies need 16-byte aligned rows: every base pointer and every
// (batch, seq, head) stride of q, k, v and o.
inline bool aligned16(const Params& p) {
  const int64_t strides[12] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                               p.v_sb, p.v_ss, p.v_sh, p.o_sb, p.o_ss, p.o_sh};
  for (int64_t s : strides)
    if (s % 8) return false;
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

// Launch the bf16 body kernel<D>: opt into its dynamic shared memory (over
// 48 KB at every head dim) and launch one block per (BQ query rows, q head,
// batch). Returns the first CUDA error.
template <int D>
cudaError_t launch(void (*kernel)(Params), const Params& p, int batch, int hq,
                   cudaStream_t stream) {
  if (!aligned16(p)) return cudaErrorMisalignedAddress;
  constexpr int bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.sq + BQ - 1) / BQ, hq, batch), NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// Launch the bf16 body KERNEL<D> for the head dims both kernels
// instantiate, returning its error.
#define ATTN_DISPATCH_TC(KERNEL, d, p, batch, hq, stream)                      \
  switch (d) {                                                                 \
    case 32: return attn::tc::launch<32>(KERNEL<32>, p, batch, hq, stream);    \
    case 64: return attn::tc::launch<64>(KERNEL<64>, p, batch, hq, stream);    \
    case 80: return attn::tc::launch<80>(KERNEL<80>, p, batch, hq, stream);    \
    case 112: return attn::tc::launch<112>(KERNEL<112>, p, batch, hq, stream); \
    case 128: return attn::tc::launch<128>(KERNEL<128>, p, batch, hq, stream); \
    case 224: return attn::tc::launch<224>(KERNEL<224>, p, batch, hq, stream); \
    case 256: return attn::tc::launch<256>(KERNEL<256>, p, batch, hq, stream); \
    default: return cudaErrorInvalidValue;                                     \
  }

}  // namespace attn
