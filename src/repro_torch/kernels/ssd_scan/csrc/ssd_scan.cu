// Mamba2 SSD chunked scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_tpu (src/repro/kernels/ssd_scan/
// kernel.py). For x (B, L, H, P), dt (B, L, H) (post-softplus), a (H,) < 0
// and B/C (B, L, N), per chunk of Q tokens (Dao & Gu 2024):
//   seg_i = cumsum_{k<=i} dt_k a                          (inclusive)
//   y_i   = sum_{j<=i} (C_i . B_j) e^{seg_i - seg_j} dt_j x_j
//           + e^{seg_i} C_i . S_prev
//   S     = e^{seg_last} S_prev + sum_j e^{seg_last - seg_j} dt_j x_j (x) B_j
// and returns y (B, L, H, P) in x's dtype and the final state (B, H, P, N)
// in fp32. S_prev of the first chunk is a given initial state (B, H, P, N)
// fp32, or 0, so a prefill can continue a scan (ssd_tpu starts at 0).
//
// Grid and carry: the TPU kernel walks the chunks as a sequential grid axis
// with S in VMEM scratch; Hopper blocks run in no order, so one block per
// (head, batch) loops over the chunks itself and carries S (N x P, fp32) in
// shared memory.
//
// Shared memory: a whole chunk of x, B and C in fp32 does not fit (192 KB at
// N = 64, 352 KB at N = 128, Q = 256), so a chunk is walked in tiles of
// TI = 64 query rows, each streaming the key tiles of TJ = 64 rows at or
// before it; per block S, one C tile, one B tile, one x tile, the masked
// (TI x TJ) score tile and four per-position vectors of the chunk: 85 KB at
// N = P = 64, 134 KB at N = 128, opted into with cudaFuncSetAttribute.
//
// Causal decay without NaN: e^{seg_i - seg_j} is evaluated only where
// j <= i (there the exponent is <= 0); for j > i it would overflow to inf
// and inf * 0 is NaN, so the masked entries are set to 0, never multiplied.
// e^{seg_i} and e^{seg_last - seg_j} have exponents <= 0 as well.
//
// No padding and no transposes: positions past L are masked (their rows
// load as 0 and a chunk's loops stop at its last valid position, which is
// the TPU kernel's dt = 0 identity update), and every input is read through
// its strides, so mamba_block's column slices of one (B, L, di + 2n) tensor
// are read in place.
//
// What bounds it on this card: at zamba2's prefill shape the kernel must
// move ~248 MB (x and y dominate) for ~30 GFLOP, 0.074 ms of bytes against
// 0.031 ms of tensor-core operations, so bytes bound it. This first version
// is simple and exact: fp32 multiply-adds on the CUDA cores in 4x4
// register blocks, C.B^T recomputed per head, each chunk's x read from
// device memory (or L2) once per query tile that needs it. The
// chunk-parallel three-phase design and tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/dtype.cuh"

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
  int64_t b_sb, b_sl;
  int64_t c_sb, c_sl;
  int64_t y_sb, y_sl, y_sh;
  int L, H, P, N, Q;
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
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb;
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

template <typename T>
cudaError_t launch_typed(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<dim3(p.H, batch), NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and a are float32,
// the state is written float32 (B, H, P, N) contiguous, starting from
// init_state (the same layout) or, where it is null, from 0. Strides are in
// elements: x/y (batch, seq, head), dt (batch, seq, head), B/C (batch, seq);
// the last dim of each is contiguous. Needs P % 4 == 0, P <= 64,
// N % 4 == 0, N <= 128 (the wrapper checks). Returns the first CUDA error
// of the attribute call or the launch.
cudaError_t ssd_scan_fwd_launch(
    const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, void* y, float* state, const float* init_state,
    int dtype, int batch, int L, int H, int P, int N, int Q,
    const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* b_strides, const int64_t* c_strides,
    const int64_t* y_strides, cudaStream_t stream) {
  if (P % 4 || P > MAX_P || N % 4 || N > MAX_N || Q < 1 || L < 1)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.bm = bm; p.cm = cm; p.y = y; p.state = state;
  p.init = init_state;
  p.x_sb = x_strides[0]; p.x_sl = x_strides[1]; p.x_sh = x_strides[2];
  p.dt_sb = dt_strides[0]; p.dt_sl = dt_strides[1]; p.dt_sh = dt_strides[2];
  p.b_sb = b_strides[0]; p.b_sl = b_strides[1];
  p.c_sb = c_strides[0]; p.c_sl = c_strides[1];
  p.y_sb = y_strides[0]; p.y_sl = y_strides[1]; p.y_sh = y_strides[2];
  p.L = L; p.H = H; p.P = P; p.N = N; p.Q = Q;
  if (dtype == 0) return launch_typed<float>(p, batch, stream);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, batch, stream);
  return cudaErrorInvalidValue;
}
