// Mamba2 SSD chunked scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_tpu (src/repro/kernels/ssd_scan/
// kernel.py). For x (B, L, H, P), dt (B, L, H) (post-softplus), a (H,) < 0
// and B/C (B, L, G, N) in G groups (head h reads group h / (H / G); G = 1
// is one B and C for every head, Zyphra's zamba2 has G = 2), per chunk of Q
// tokens (Dao & Gu 2024):
//   seg_i = cumsum_{k<=i} dt_k a                          (inclusive)
//   y_i   = sum_{j<=i} (C_i . B_j) e^{seg_i - seg_j} dt_j x_j
//           + e^{seg_i} C_i . S_prev
//   S     = e^{seg_last} S_prev + sum_j e^{seg_last - seg_j} dt_j x_j (x) B_j
// and returns y (B, L, H, P) in x's dtype and the final state (B, H, P, N)
// in fp32. S_prev of the first chunk is a given initial state (B, H, P, N)
// fp32, or 0, so a prefill can continue a scan (ssd_tpu starts at 0).
//
// What bounds it on this card: at zamba2's prefill shape (B 4, L 2048,
// H 112, P 64, N 64, Q 256) the function must move ~248 MB (x and y 235
// MB, B and C 2 MB, dt, a and the state) for ~30 GFLOP: 0.074 ms of bytes
// at 3.35 TB/s against 0.031 ms of bf16 tensor-core operations, so bytes
// bound it. The TPU kernel walks the chunks as a sequential grid axis with
// S in VMEM; on the card that leaves one block per (head, batch) walking
// the chunks in turn, the first version's design, which ran at 1.8 % of
// the bound. The launcher picks the body by dtype:
//
// bf16, the serving dtype: four chunk-parallel kernels on the current
// stream, the decomposition of the public Mamba2 chunked-scan kernels (Dao
// & Gu 2024, arXiv:2405.21060, section 6; mamba_ssm's ssd_combined):
// - ssd_seg (A), per (32 heads, chunk, batch): dt read as (64 positions x
//   32 heads) slabs, coalesced along the heads, a warp scan per head, and
//   written head-major (3, B, H, L) fp32 (3.7 MB each at zamba2's shape):
//   seg = cumsum(dt a), dt, and cw = e^{seg_end - seg} dt, seg_end the
//   last seg of the position's 64-row tile. Every later decay then takes
//   one exponential per tile and row instead of one per pair, with no
//   exponent above 0.
// - ssd_states (B), per (head, chunk, batch): the chunk's own state
//   S_c = x^T (w ⊙ B), w_j = e^{seg_last - seg_end} cw_j, by wgmma with
//   both operands MN-major (64-row tiles of x and B, the positions as K)
//   and fp32 accumulate, written fp32 (B, nc, H, P, N): 58.7 MB.
// - ssd_pass (C), per (head, 1024 state entries, batch): the short scan
//   over chunks, S_prev[c] = e^{seg_last[c-1]} S_prev[c-1] + S_c[c-1] from
//   the initial state in fp32, writing each chunk's S_prev as two bf16
//   parts (hi and lo, below) for phase D and the final state in fp32.
// - ssd_out (D), per (head, 64 query rows of a chunk, batch), the longest
//   query tiles first: y = e^{seg_i} (C . S_prev^T) by wgmma, then for each
//   key tile at or before the query tile G = C . B^T by wgmma,
//   M = G e^{seg_i - seg_j} dt_j in fp32 on the accumulator fragment
//   (e^{seg_i - seg_end} cw_j off the diagonal), split into bf16 parts as
//   the register A operand of y += M . x (x MN-major). G is recomputed
//   per head rather than shared: at one state group it is ~15 GFLOP at
//   zamba2's shape, ~0.015 ms at the tensor cores' peak, and one head per
//   block keeps one accumulator per thread and 14,336 blocks in flight;
//   sharing G would need an accumulator per head in flight.
// Tiles are 64 rows, copied by cp.async in 16-byte pieces into
// 128-byte-swizzled shared memory (../../csrc/wgmma.cuh, shared with the
// attention kernels) through a two-stage ring; P and N are padded in
// shared memory with zeros to whole 64-column atoms (N to 64 or 128), so
// the reference grid's P 8-32 and N 8-32 run the same body. Rows that are
// not 16-byte aligned (P or N not a multiple of 8, odd strides) are
// gathered element by element instead. The design moves x twice (phases B
// and D), the chunk states three times (~0.6 GB in all at zamba2's shape,
// 0.18 ms at 3.35 TB/s); x tiles re-read by later query tiles of a chunk
// come from L2.
//
// Precision: every fp32 operand that the products take (w ⊙ B in phase
// B, S_prev and M in phase D) is split into two bf16 parts, hi = bf16(v)
// and lo = bf16(v - hi), and multiplied as hi + lo (x, B and C are bf16
// inputs, exact): ~16 bits of mantissa, for one more product each. A CPU
// emulation of this body (tests/test_torch_ssd.py) shows why one bf16
// rounding is not enough: rounding w ⊙ B once puts the state 1.8-2.6e-3
// (relative to its largest entry) from the reference, over the 1e-3 gate
// (TF32 operands would need K-major, transposed fp32 copies of x and B and
// still keep only 11 bits); rounding M and S_prev once moves y by 2^-9
// relative, and at |y| >= 8 a bf16 output then differs from the
// reference's by a whole ulp (0.0625) on the reference cases, over their
// 5e-2 tolerance. With the splits the emulation reads the state ~5e-6
// and the four reference cases <= 1.6e-2 from the sequential recurrence.
// The products are not the bottleneck (bytes are), so the extra products
// cost little.
//
// fp32, the verification dtype, runs ssd_fwd, the first version, on the
// CUDA cores: TF32 or bf16 products cannot meet the reference's 1e-4.
// One block per (head, batch) walks the chunks and carries S (N x P, fp32)
// in shared memory; a chunk is walked in tiles of TI = 64 query rows, each
// streaming the key tiles of TJ = 64 rows at or before it, fp32
// multiply-adds in 4x4 register blocks (85 KB of shared memory at
// N = P = 64, 134 KB at N = 128).
//
// Causal decay without NaN (both bodies): e^{seg_i - seg_j} is evaluated
// only where j <= i (there the exponent is <= 0); for j > i it would
// overflow to inf and inf * 0 is NaN, so the masked entries are set to 0,
// never multiplied. e^{seg_i} and e^{seg_last - seg_j} have exponents <= 0
// as well.
//
// No padding in device memory and no transposes of the inputs: positions
// past L are masked (their rows load as 0 and no output is written for
// them, the TPU kernel's dt = 0 identity update), and every input is read
// through its strides, so mamba_block's column slices of one
// (B, L, di + 2n) tensor are read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/dtype.cuh"
#include "../../csrc/wgmma.cuh"

namespace {

constexpr int NT = 256;              // threads: a 16 x 16 grid (ty, tx)
constexpr int TI = 64;               // query rows per tile
constexpr int TJ = 64;               // key rows per tile
constexpr int MAX_P = 64;            // 4 columns per tx
constexpr int MAX_N = 128;           // 8 state rows per ty
constexpr int NR = MAX_N / 16;
static_assert(TI == TJ, "load_rows fills TI rows of every tile");

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;
  float* state;                      // (B, H, P, N) contiguous
  const float* init;                 // (B, H, P, N) contiguous, or null: 0
  int64_t x_sb, x_sl, x_sh;          // element strides; last dim contiguous
  int64_t dt_sb, dt_sl, dt_sh;
  int64_t b_sb, b_sl, b_sg;           // B/C (batch, seq, group) strides
  int64_t c_sb, c_sl, c_sg;
  int hpg;                           // heads per group: head h reads group h / hpg
  int64_t y_sb, y_sl, y_sh;
  int L, H, P, N, Q;
  // the bf16 body's scratch (null for fp32), all written before read:
  float* seg;                        // (B, H, L) inclusive chunk cumsum of dt a
  float* dtt;                        // (B, H, L) dt, head-major
  float* cw;                         // (B, H, L) e^{seg_end - seg} dt
  float* cstate;                     // (B, nc, H, P, N) each chunk's own state
  __nv_bfloat16* prev_hi;            // (B, nc, H, P, N) the state before each
  __nv_bfloat16* prev_lo;            // chunk, split into two bf16 parts
  int nc;                            // chunks: ceil(L / Q)
  int vec;                           // rows 16-byte aligned: cp.async copies
};

// rows [r0, r0 + TI) of a (L, width) slice with row stride rs into a (TI, ld)
// fp32 tile; rows at or past `valid` load as 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t rs, int r0, int valid,
                                          int width) {
  for (int idx = threadIdx.x; idx < TI * width; idx += NT) {
    const int r = idx / width;
    const int c = idx - r * width;
    dst[r * ld + c] = r0 + r < valid ? to_f(src[(int64_t)(r0 + r) * rs + c]) : 0.f;
  }
}

size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P + 2 * (size_t)TI * (N + 4) + (size_t)TJ * P +
         (size_t)TI * TJ + 4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_fwd(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int N = p.N, P = p.P, Q = p.Q, L = p.L;
  const int ldc = N + 4;             // C/B tile row stride: float4-aligned,
                                     // rows 4 banks apart
  float* S = sm;                     // (N, P)
  float* Cs = S + N * P;             // (TI, ldc)
  float* Bs = Cs + TI * ldc;         // (TJ, ldc)
  float* Xs = Bs + TJ * ldc;         // (TJ, P)
  float* Ms = Xs + TJ * P;           // (TI, TJ) masked scores
  float* dtv = Ms + TI * TJ;         // (Q,) dt
  float* seg = dtv + Q;              // (Q,) inclusive cumsum of dt a
  float* eseg = seg + Q;             // (Q,) e^{seg_i}
  float* wend = eseg + Q;            // (Q,) e^{seg_last - seg_j} dt_j

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = tx * 4;             // this thread's 4 columns of P
  const bool pact = p0 < P;
  const float ah = p.a[h];

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + (h / p.hpg) * p.b_sg;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + (h / p.hpg) * p.c_sg;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  const float* ig = p.init ? p.init + ((int64_t)b * p.H + h) * P * N : nullptr;
  for (int idx = tid; idx < N * P; idx += NT) {
    const int pp = idx / N;
    S[(idx - pp * N) * P + pp] = ig ? ig[idx] : 0.f;
  }

  for (int base = 0; base < L; base += Q) {
    const int qn = min(Q, L - base);  // valid rows of this chunk
    __syncthreads();                  // the previous chunk is done with dtv
    for (int i = tid; i < qn; i += NT) dtv[i] = dtg[(int64_t)(base + i) * p.dt_sl];
    __syncthreads();
    if (tid < 32) {                   // warp-wide inclusive scan of dt a
      float carry = 0.f;
      for (int i0 = 0; i0 < qn; i0 += 32) {
        const int i = i0 + tid;
        float v = i < qn ? dtv[i] * ah : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        if (i < qn) seg[i] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float seg_last = seg[qn - 1];
    for (int i = tid; i < qn; i += NT) {
      eseg[i] = expf(seg[i]);
      wend[i] = expf(seg_last - seg[i]) * dtv[i];
    }

    // ---- outputs, one query tile at a time
    for (int i0 = 0; i0 < qn; i0 += TI) {
      __syncthreads();                // Cs free, eseg/wend written
      load_rows<T>(Cs, ldc, cg, p.c_sl, base + i0, base + qn, N);
      __syncthreads();
      float acc[4][4];
      // inter-chunk term e^{seg_i} C_i . S_prev; rows ty + 16 r, cols p0 + c
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (pact) {
        for (int n = 0; n < N; ++n) {
          const float4 sv = *reinterpret_cast<const float4*>(&S[n * P + p0]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cv = Cs[(ty + 16 * r) * ldc + n];
            acc[r][0] += cv * sv.x;
            acc[r][1] += cv * sv.y;
            acc[r][2] += cv * sv.z;
            acc[r][3] += cv * sv.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < qn ? eseg[i] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      // intra-chunk term over the key tiles at or before this query tile
      for (int j0 = 0; j0 <= i0; j0 += TJ) {
        __syncthreads();              // Bs, Xs, Ms free
        load_rows<T>(Bs, ldc, bg, p.b_sl, base + j0, base + qn, N);
        load_rows<T>(Xs, P, xg, p.x_sl, base + j0, base + qn, P);
        __syncthreads();
        // scores C_i . B_j for rows i = ty + 16 r, keys j = tx + 16 c
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * r) * ldc + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * c) * ldc + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              g[r][c] += cv[r].x * bv[c].x + cv[r].y * bv[c].y +
                         cv[r].z * bv[c].z + cv[r].w * bv[c].w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // the decay only where j <= i: never e^{positive}
            Ms[(ty + 16 * r) * TJ + tx + 16 * c] =
                (j <= i && i < qn) ? g[r][c] * expf(seg[i] - seg[j]) * dtv[j]
                                   : 0.f;
          }
        }
        __syncthreads();
        if (pact) {
          for (int j = 0; j < TJ; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * P + p0]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float mv = Ms[(ty + 16 * r) * TJ + j];
              acc[r][0] += mv * xv.x;
              acc[r][1] += mv * xv.y;
              acc[r][2] += mv * xv.z;
              acc[r][3] += mv * xv.w;
            }
          }
        }
      }
      if (pact) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i < qn) {
            T* yr = yg + (int64_t)(base + i) * p.y_sl + p0;
#pragma unroll
            for (int c = 0; c < 4; ++c) yr[c] = from_f<T>(acc[r][c]);
          }
        }
      }
    }

    // ---- state carry: S = e^{seg_last} S + sum_j wend_j x_j (x) B_j, for
    // this thread's rows n = ty + 16 r and columns p0 + c
    float st[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] = 0.f;
    for (int j0 = 0; j0 < qn; j0 += TJ) {
      __syncthreads();                // every read of S and the tiles is done
      load_rows<T>(Bs, ldc, bg, p.b_sl, base + j0, base + qn, N);
      load_rows<T>(Xs, P, xg, p.x_sl, base + j0, base + qn, P);
      __syncthreads();
      if (pact) {
        const int jn = min(TJ, qn - j0);
        for (int j = 0; j < jn; ++j) {
          const float w = wend[j0 + j];
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * P + p0]);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const int n = ty + 16 * r;
            if (n < N) {
              const float bw = Bs[j * ldc + n] * w;
              st[r][0] += bw * xv.x;
              st[r][1] += bw * xv.y;
              st[r][2] += bw * xv.z;
              st[r][3] += bw * xv.w;
            }
          }
        }
      }
    }
    const float tot = expf(seg_last);
    if (pact) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int n = ty + 16 * r;
        if (n < N) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            S[n * P + p0 + c] = tot * S[n * P + p0 + c] + st[r][c];
        }
      }
    }
  }

  __syncthreads();
  float* sg = p.state + ((int64_t)b * p.H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT) {
    const int pp = idx / N;
    const int n = idx - pp * N;
    sg[idx] = S[n * P + pp];
  }
}

// The fp32 body, the first version (see the note at the top).
cudaError_t launch_simt(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<float><<<dim3(p.H, batch), NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tensor cores
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;             // tile rows (positions); P padded to one atom
constexpr int NTHREADS = 128;        // one warpgroup
constexpr int SEG_H = 32;            // ssd_seg: heads per block
constexpr int SEG_THREADS = 256;     // 8 warps, 4 heads each
constexpr int MAX_TILES = 4096 / TILE;  // tiles of the largest chunk
constexpr int PASS_THREADS = 256;    // ssd_pass: 4 state entries a thread

// Bytes of a tile of TILE rows and W (a multiple of 64) columns.
template <int W>
__host__ __device__ constexpr int tile_bytes() { return TILE * W * 2; }

// Rows r0 .. r0+TILE of a (rows, width) bf16 slice with row stride rs (in
// elements) into the swizzled TILE x W tile at shared address dst; rows at or
// past `valid` and columns at or past `width` are zero. With vec (16-byte
// aligned rows, width % 8 == 0) each 16-byte piece is one cp.async
// (source size 0 for the zeros): consecutive threads copy consecutive
// pieces of a row, eight of them fill one 128-byte row of the tile.
// Otherwise each piece is gathered element by element and stored.
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          int64_t rs, int r0, int valid,
                                          int width, bool vec) {
  constexpr int CH = W / 8;          // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < TILE * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool row_ok = r0 + r < valid;
    const uint32_t d = dst + swizzled<TILE>(r, c);
    if (vec) {
      const bool ok = row_ok && 8 * c < width;
      const bf16* src = ok ? g + (int64_t)(r0 + r) * rs + 8 * c : g;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
    } else {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          row_ok ? g + (int64_t)(r0 + r) * rs : g);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * e;
        const uint32_t lo = row_ok && col < width ? src[col] : 0u;
        const uint32_t hi = row_ok && col + 1 < width ? src[col + 1] : 0u;
        w[e] = lo | hi << 16;
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(d), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  }
}

// The 1024-byte aligned start of a block's dynamic shared memory (the
// swizzle pattern repeats every 1024 bytes), as a generic pointer.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}

// The chunk a block works on: its first position, its valid rows.
struct Chunk {
  int base, qn;
  __device__ Chunk(const Params& p, int c)
      : base(c * p.Q), qn(min(p.Q, p.L - c * p.Q)) {}
};

// Phase A. For 32 heads of one (chunk, batch), head-major: seg (the
// inclusive cumsum of dt a within the chunk), dt, and cw = e^{seg_end -
// seg} dt, seg_end the last seg of the position's tile (TILE positions
// from the chunk's start, or fewer where the chunk ends), so that
// e^{seg_i - seg_j} dt_j = e^{seg_i - seg_end} cw_j with both exponents
// <= 0 wherever the tile lies wholly at or before i. dt is read as slabs of
// TILE positions x 32 heads, coalesced along the heads; warp w scans heads
// w, w + 8, w + 16, w + 24, two positions a lane, carrying the sum from
// slab to slab.
__global__ void __launch_bounds__(SEG_THREADS) ssd_seg(const Params p) {
  __shared__ float slab[TILE][SEG_H + 1];
  constexpr int PER_WARP = SEG_H / (SEG_THREADS / 32);
  const int h0 = blockIdx.x * SEG_H, b = blockIdx.z;
  const Chunk ch(p, blockIdx.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* dtg = p.dt + b * p.dt_sb;
  float carry[PER_WARP], ah[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int h = h0 + warp + 8 * k;
    carry[k] = 0.f;
    ah[k] = h < p.H ? p.a[h] : 0.f;
  }
  for (int t0 = 0; t0 < ch.qn; t0 += TILE) {
    __syncthreads();                 // the previous slab is scanned
    for (int idx = threadIdx.x; idx < TILE * SEG_H; idx += SEG_THREADS) {
      const int r = idx / SEG_H, hh = idx % SEG_H, h = h0 + hh;
      slab[r][hh] = t0 + r < ch.qn && h < p.H
          ? dtg[(int64_t)(ch.base + t0 + r) * p.dt_sl + h * p.dt_sh] : 0.f;
    }
    __syncthreads();
    const int last = min(TILE, ch.qn - t0) - 1;  // the tile's last row
#pragma unroll
    for (int k = 0; k < PER_WARP; ++k) {
      const int hh = warp + 8 * k, h = h0 + hh;
      if (h >= p.H) break;           // warp-uniform
      const float d0 = slab[2 * lane][hh], d1 = slab[2 * lane + 1][hh];
      const float v0 = d0 * ah[k];
      float incl = v0 + d1 * ah[k];  // the lane's pair, then the scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float s0 = carry[k] + (excl + v0), s1 = carry[k] + incl;
      const float send = __shfl_sync(0xffffffffu, last & 1 ? s1 : s0, last >> 1);
      const int64_t o = ((int64_t)b * p.H + h) * p.L + ch.base + t0 + 2 * lane;
      if (2 * lane <= last) {
        p.seg[o] = s0;
        p.dtt[o] = d0;
        p.cw[o] = expf(send - s0) * d0;
      }
      if (2 * lane + 1 <= last) {
        p.seg[o + 1] = s1;
        p.dtt[o + 1] = d1;
        p.cw[o + 1] = expf(send - s1) * d1;
      }
      carry[k] += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// Phase B. The chunk's own state S_c = x^T (w ⊙ B) (P x N, fp32) of one
// (head, chunk, batch), w_j = e^{seg_last - seg_j} dt_j = f_t cw_j with
// f_t = e^{seg_last - seg_end} per tile. Tiles of 64 positions of x
// (64 x 64), B (64 x W) and cw stream through a two-stage ring; per tile
// w ⊙ B is formed in fp32 and split into bf16 hi and lo tiles of B's
// layout, and acc += x^T hi + x^T lo by wgmma m64nWk16, both operands
// MN-major (the positions are K). acc's rows are p, its columns n.
template <int W>
__global__ void __launch_bounds__(NTHREADS) ssd_states(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float cwk[2][TILE];     // cw of each stage's rows
  __shared__ float f_tile[MAX_TILES];  // e^{seg_last - seg_end} per tile
  constexpr int XB = tile_bytes<TILE>(), BB = tile_bytes<W>(), STAGE = XB + BB;
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(sm);
  const uint32_t u_hi = s0 + 2 * STAGE, u_lo = u_hi + BB;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const Chunk ch(p, c);
  const int end = ch.base + ch.qn;
  const int64_t bh = (int64_t)b * p.H + h;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb + (h / p.hpg) * p.b_sg;
  const float* segg = p.seg + bh * p.L + ch.base;
  const float* cwg = p.cw + bh * p.L + ch.base;
  const int nt = (ch.qn + TILE - 1) / TILE;
  // the tile's rows of x, B and cw into ring stage st
  auto load_rows = [&](int st, int j0) {
    const uint32_t xs = s0 + st * STAGE;
    load_tile<TILE>(xs, xg, p.x_sl, ch.base + j0, end, p.P, p.vec);
    load_tile<W>(xs + XB, bg, p.b_sl, ch.base + j0, end, p.N, p.vec);
    if (threadIdx.x < TILE) {
      const int j = j0 + threadIdx.x;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(&cwk[st][threadIdx.x])),
                      "l"(cwg + (j < ch.qn ? j : 0)), "r"(j < ch.qn ? 4 : 0));
    }
  };
  load_rows(0, 0);
  cp_async_commit();
  for (int t = threadIdx.x; t < nt; t += NTHREADS)
    f_tile[t] = expf(segg[ch.qn - 1] - segg[min(t * TILE + TILE, ch.qn) - 1]);

  float acc[W / 2];
  for (int t = 0; t < nt; ++t) {
    const uint32_t xs = s0 + (t & 1) * STAGE, bs = xs + XB;
    cp_async_wait_all();
    __syncthreads();                 // tile t landed; tile t-1's products done
    if (t + 1 < nt) load_rows((t + 1) & 1, (t + 1) * TILE);
    cp_async_commit();
    // w ⊙ B, split: each thread rescales 16-byte pieces of the B tile and
    // writes them to the same place of the hi and lo tiles
    const float ft = f_tile[t];
    for (int idx = threadIdx.x; idx < TILE * W / 8; idx += NTHREADS) {
      const int r = idx / (W / 8);
      const float w = ft * cwk[t & 1][r];  // 0 past the chunk's end
      const uint32_t off = swizzled<TILE>(r, idx - r * (W / 8));
      uint32_t v[4], hi[4], lo[4];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                   : "r"(bs + off));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[e]));
        const float fx = f.x * w, fy = f.y * w;
        hi[e] = pack_bf16(fx, fy);
        const float2 fh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[e]));
        lo[e] = pack_bf16(fx - fh.x, fy - fh.y);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(u_hi + off), "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]));
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(u_lo + off), "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                 // hi and lo written, visible to wgmma
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_ss_mn<W>(acc, desc_mn_major<TILE>(xs) + 128 * kk,
                     desc_mn_major<TILE>(u_hi) + 128 * kk, t > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_ss_mn<W>(acc, desc_mn_major<TILE>(xs) + 128 * kk,
                     desc_mn_major<TILE>(u_lo) + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }

  // value 4 j + 2 hh + e: row p = 16 warp + lane / 4 + 8 hh, column
  // n = 8 j + 2 (lane % 4) + e
  float* out = p.cstate + (((int64_t)b * p.nc + c) * p.H + h) * p.P * p.N;
  const int lane = threadIdx.x & 31, row0 = 16 * (threadIdx.x >> 5) + lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pr = row0 + 8 * hh;
    if (pr >= p.P) continue;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);
      if (n < p.N)
        *reinterpret_cast<float2*>(out + pr * p.N + n) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// Stores 4 floats as bf16 hi = bf16(v) at hi and lo = bf16(v - hi) at lo.
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, float4 v) {
  const uint32_t h01 = pack_bf16(v.x, v.y), h23 = pack_bf16(v.z, v.w);
  const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h01));
  const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h23));
  *reinterpret_cast<uint2*>(hi) = make_uint2(h01, h23);
  *reinterpret_cast<uint2*>(lo) = make_uint2(pack_bf16(v.x - f01.x, v.y - f01.y),
                                             pack_bf16(v.z - f23.x, v.w - f23.y));
}

// Phase C. The scan over chunks for 4 state entries a thread of one (head,
// batch): S_prev[c] before each chunk (split into bf16 hi and lo), then
// the final state (fp32).
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass(const Params p) {
  const int pn = p.P * p.N;
  const int i = 4 * (blockIdx.y * PASS_THREADS + threadIdx.x);
  if (i >= pn) return;
  const int h = blockIdx.x, b = blockIdx.z;
  const int64_t bh = (int64_t)b * p.H + h;
  float4 s = p.init ? *reinterpret_cast<const float4*>(p.init + bh * pn + i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < p.nc; ++c) {
    const int64_t o = (((int64_t)b * p.nc + c) * p.H + h) * pn + i;
    store_split(p.prev_hi + o, p.prev_lo + o, s);
    const float decay = expf(p.seg[bh * p.L + min((c + 1) * p.Q, p.L) - 1]);
    const float4 u = *reinterpret_cast<const float4*>(p.cstate + o);
    s = make_float4(decay * s.x + u.x, decay * s.y + u.y, decay * s.z + u.z,
                    decay * s.w + u.w);
  }
  *reinterpret_cast<float4*>(p.state + bh * pn + i) = s;
}

// The bytes of ssd_out's ring: stage 0 holds a key tile (x, then B);
// stage 1 holds a key tile, or first S_prev's hi and lo tiles.
template <int W>
constexpr int out_ring_bytes() {
  return tile_bytes<TILE>() + tile_bytes<W>() +
         (tile_bytes<TILE>() + tile_bytes<W>() > 2 * tile_bytes<W>()
              ? tile_bytes<TILE>() + tile_bytes<W>() : 2 * tile_bytes<W>());
}

// Phase D. y for 64 query rows of one (chunk, head, batch): the C tile
// (64 x W) is copied once, and S_prev's hi and lo tiles (P x W, rows p)
// into ring stage 1 for the first product; key tiles of x and B (and
// their seg, dt and cw) stream through the two-stage ring, from the
// chunk's start to the query tile. y starts as e^{seg_i} (C . hi^T +
// C . lo^T); per key tile G = C . B^T (both K-major: the state dim is K),
// the decay and the causal mask turn G into M on the fragment, split into
// bf16 hi and lo, and y += M_hi . x + M_lo . x with M as the register A
// operand (the fp32 accumulator fragment and the bf16 A fragment order
// their elements alike) and x MN-major. On a key tile wholly before the
// query tile the decay factors: M_ij = G_ij e^{seg_i - seg_end} cw_j, two
// exponentials a thread; on the diagonal tile each entry j <= i takes its
// own.
template <int W>
__global__ void __launch_bounds__(NTHREADS) ssd_out(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float keys[2][3][TILE];   // per stage: seg, dt, cw of the keys
  constexpr int XB = tile_bytes<TILE>(), BB = tile_bytes<W>(), STAGE = XB + BB;
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t c_s = smem_addr(sm), ring = c_s + BB;
  const uint32_t s_hi = ring + STAGE, s_lo = s_hi + BB;

  const int nqt = (p.Q + TILE - 1) / TILE;
  const int flat = gridDim.y - 1 - blockIdx.y;   // the longest tiles first
  const int c = flat / nqt, qt = flat - c * nqt;
  const int h = blockIdx.x, b = blockIdx.z;
  const Chunk ch(p, c);
  const int i0 = qt * TILE, end = ch.base + ch.qn;
  if (i0 >= ch.qn) return;           // past the ragged last chunk's end
  const int64_t bh = (int64_t)b * p.H + h;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb + (h / p.hpg) * p.b_sg;
  const bf16* cg = static_cast<const bf16*>(p.cm) + b * p.c_sb + (h / p.hpg) * p.c_sg;
  const int64_t so = (((int64_t)b * p.nc + c) * p.H + h) * p.P * p.N;
  const float* segg = p.seg + bh * p.L + ch.base;
  const float* dtg = p.dtt + bh * p.L + ch.base;
  const float* cwg = p.cw + bh * p.L + ch.base;

  // the key tile at chunk position j0 into ring stage st: x and B rows,
  // and seg, dt and cw (4-byte copies, 0 past the chunk's end)
  auto load_keys = [&](int st, int j0) {
    const uint32_t xs = ring + st * STAGE;
    load_tile<TILE>(xs, xg, p.x_sl, ch.base + j0, end, p.P, p.vec);
    load_tile<W>(xs + XB, bg, p.b_sl, ch.base + j0, end, p.N, p.vec);
    for (int idx = threadIdx.x; idx < 3 * TILE; idx += NTHREADS) {
      const int arr = idx / TILE, k = idx - arr * TILE, j = j0 + k;
      const float* src = arr == 0 ? segg : arr == 1 ? dtg : cwg;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(&keys[st][arr][k])),
                      "l"(src + (j < ch.qn ? j : 0)), "r"(j < ch.qn ? 4 : 0));
    }
  };
  load_tile<W>(c_s, cg, p.c_sl, ch.base + i0, end, p.N, p.vec);
  load_tile<W>(s_hi, p.prev_hi + so, p.N, 0, p.P, p.N, p.vec);
  load_tile<W>(s_lo, p.prev_lo + so, p.N, 0, p.P, p.N, p.vec);
  load_keys(0, 0);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int row0 = i0 + 16 * (threadIdx.x >> 5) + lane / 4;  // rows row0, row0 + 8
  float seg_i[2], e_i[2];            // 0 past the chunk's end
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool ok = row0 + 8 * hh < ch.qn;
    seg_i[hh] = ok ? segg[row0 + 8 * hh] : 0.f;
    e_i[hh] = ok ? expf(seg_i[hh]) : 0.f;
  }
  const uint64_t dc = desc_k_major(c_s);

  float y[32], g[32];
  for (int t = 0; t <= qt; ++t) {
    const int st = t & 1, j0 = t * TILE;
    const uint32_t xs = ring + st * STAGE;
    cp_async_wait_all();
    __syncthreads();                 // tile t landed; tile t-1 is consumed
    if (t == 0) {                    // y = e^{seg_i} C . S_prev^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss_n64(y, dc + k_step<TILE>(kk), desc_k_major(s_hi) + k_step<TILE>(kk), kk);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss_n64(y, dc + k_step<TILE>(kk), desc_k_major(s_lo) + k_step<TILE>(kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(y);
#pragma unroll
      for (int v = 0; v < 32; ++v) y[v] *= e_i[(v >> 1) & 1];
      __syncthreads();               // S_prev is read: stage 1 is free
    }
    if (t < qt) load_keys(st ^ 1, j0 + TILE);
    cp_async_commit();
    wgmma_fence();                   // G = C . B^T
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_ss_n64(g, dc + k_step<TILE>(kk), desc_k_major(xs + XB) + k_step<TILE>(kk), kk);
    wgmma_commit();
    // the row factors of an off-diagonal tile while G runs: e^{seg_i -
    // seg_end} (the tile's end lies before every row), 0 past the end
    const float* segk = keys[st][0];
    const float* dtk = keys[st][1];
    const float* cwk = keys[st][2];
    const bool diag = t == qt;
    float rf[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rf[hh] = !diag && row0 + 8 * hh < ch.qn ? expf(seg_i[hh] - segk[TILE - 1]) : 0.f;
    wgmma_wait();
    fence_regs(g);
    // M = G e^{seg_i - seg_j} dt_j where j <= i < qn, else 0: value v is
    // row row0 + 8 ((v >> 1) & 1), key j0 + 8 (v >> 2) + 2 (lane % 4) + (v & 1)
    uint32_t m_hi[TILE / 16][4], m_lo[TILE / 16][4];
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int hh = (v >> 1) & 1, r = row0 + 8 * hh;
      const int k = 8 * (v >> 2) + 2 * (lane & 3);
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        m[e] = !diag ? g[v + e] * rf[hh] * cwk[k + e]
             : j0 + k + e <= r && r < ch.qn
                 ? g[v + e] * expf(seg_i[hh] - segk[k + e]) * dtk[k + e] : 0.f;
      // the A fragment of k-step v / 8: register (v % 8) / 2
      const uint32_t hi = pack_bf16(m[0], m[1]);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
      m_hi[v >> 3][(v & 7) >> 1] = hi;
      m_lo[v >> 3][(v & 7) >> 1] = pack_bf16(m[0] - f.x, m[1] - f.y);
    }
    fence_regs(y);
    wgmma_fence();                   // y += M . x
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<64>(y, m_hi[kk], desc_mn_major<TILE>(xs) + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<64>(y, m_lo[kk], desc_mn_major<TILE>(xs) + 128 * kk);
    wgmma_commit();
    wgmma_wait();
    fence_regs(y);
  }

  bf16* yg = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= ch.qn) continue;
    bf16* yr = yg + (int64_t)(ch.base + r) * p.y_sl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < p.P)
        *reinterpret_cast<__nv_bfloat162*>(yr + col) =
            __floats2bfloat162_rn(y[4 * j + 2 * hh], y[4 * j + 2 * hh + 1]);
    }
  }
}

// Dynamic shared memory (plus 1 KB of alignment slack): ssd_states two
// stages of x and B and the hi and lo tiles; ssd_out the C tile and its
// ring.
template <int W>
constexpr int states_smem() {
  return 2 * (tile_bytes<TILE>() + tile_bytes<W>()) + 2 * tile_bytes<W>() + 1024;
}
template <int W>
constexpr int out_smem() {
  return tile_bytes<W>() + out_ring_bytes<W>() + 1024;
}

template <int W>
cudaError_t launch_w(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, states_smem<W>());
  if (err != cudaSuccess) return err;
  ssd_states<W><<<dim3(p.H, p.nc, batch), NTHREADS, states_smem<W>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pass_blocks = (p.P * p.N / 4 + PASS_THREADS - 1) / PASS_THREADS;
  ssd_pass<<<dim3(p.H, pass_blocks, batch), PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_out<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem<W>());
  if (err != cudaSuccess) return err;
  const int nqt = (p.Q + TILE - 1) / TILE;
  ssd_out<W><<<dim3(p.H, p.nc * nqt, batch), NTHREADS, out_smem<W>(), stream>>>(p);
  return cudaGetLastError();
}

// The four phases in order on one stream. Returns the first CUDA error.
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  const void* ptrs[5] = {p.x, p.bm, p.cm, p.prev_hi, p.prev_lo};
  bool vec = p.P % 8 == 0 && p.N % 8 == 0;
  for (const void* ptr : ptrs) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const int64_t strides[9] = {p.x_sb, p.x_sl, p.x_sh, p.b_sb, p.b_sl, p.b_sg,
                              p.c_sb, p.c_sl, p.c_sg};
  for (int64_t s : strides) vec = vec && s % 8 == 0;
  p.vec = vec;
  ssd_seg<<<dim3((p.H + SEG_H - 1) / SEG_H, p.nc, batch), SEG_THREADS, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return p.N <= 64 ? launch_w<64>(p, batch, stream) : launch_w<128>(p, batch, stream);
}

}  // namespace tc
}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the four
// tensor-core phases) for x, B, C and y; dt and a are float32, the state
// is written float32 (B, H, P, N) contiguous, starting from init_state
// (the same layout) or, where it is null, from 0. Strides are in elements:
// x/y (batch, seq, head), dt (batch, seq, head), B/C (batch, seq, group);
// the last dim of each is contiguous; G groups divide the H heads. keys (3, B, H, L) fp32 (seg, dt, cw per
// position), cstate (B, nc, H, P, N) fp32 and prev (2, B, nc, H, P, N)
// bf16 (the hi and lo parts of the state before each chunk) are the bf16
// body's scratch, nc = ceil(L / Q); null for fp32. Needs P % 4 == 0, P <= 64,
// N % 4 == 0, N <= 128 (the wrapper checks). Returns the first CUDA error
// of the attribute calls and the launches.
cudaError_t ssd_scan_fwd_launch(
    const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, void* y, float* state, const float* init_state,
    float* keys, float* cstate, void* prev,
    int dtype, int batch, int L, int H, int P, int N, int G, int Q,
    const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* b_strides, const int64_t* c_strides,
    const int64_t* y_strides, cudaStream_t stream) {
  if (P % 4 || P > MAX_P || N % 4 || N > MAX_N || Q < 1 || L < 1 || G < 1 ||
      H % G)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.bm = bm; p.cm = cm; p.y = y; p.state = state;
  p.init = init_state;
  p.x_sb = x_strides[0]; p.x_sl = x_strides[1]; p.x_sh = x_strides[2];
  p.dt_sb = dt_strides[0]; p.dt_sl = dt_strides[1]; p.dt_sh = dt_strides[2];
  // one group: its (size-1) group stride is never used
  p.b_sb = b_strides[0]; p.b_sl = b_strides[1]; p.b_sg = G > 1 ? b_strides[2] : 0;
  p.c_sb = c_strides[0]; p.c_sl = c_strides[1]; p.c_sg = G > 1 ? c_strides[2] : 0;
  p.hpg = H / G;
  p.y_sb = y_strides[0]; p.y_sl = y_strides[1]; p.y_sh = y_strides[2];
  p.L = L; p.H = H; p.P = P; p.N = N; p.Q = Q;
  const int64_t bhl = (int64_t)batch * H * L;
  p.seg = keys;
  p.dtt = keys ? keys + bhl : nullptr;
  p.cw = keys ? keys + 2 * bhl : nullptr;
  p.cstate = cstate;
  p.nc = (L + Q - 1) / Q;
  p.prev_hi = static_cast<__nv_bfloat16*>(prev);
  p.prev_lo = p.prev_hi ? p.prev_hi + (int64_t)batch * p.nc * H * P * N : nullptr;
  p.vec = 0;
  if (dtype == 0) return launch_simt(p, batch, stream);
  if (dtype == 1) {
    if (!keys || !cstate || !prev) return cudaErrorInvalidValue;
    return tc::launch(p, batch, stream);
  }
  return cudaErrorInvalidValue;
}
