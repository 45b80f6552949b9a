// Mamba2's one-token decode update for Hopper (sm_90a), the fp32 state
// updated in place in the cache: for each (lane, head) with its group g,
//   s' = s * exp(dt A) + (dt x) B_g^T,   y[p] = sum_n C_g[n] s'[p, n].
//
// It replaces no TPU kernel: the reference writes the decode update in plain
// JAX (src/repro/models/ssm.py:79 ssd_decode_step) and XLA fuses it. Eager
// PyTorch ran it as five passes over the state (the decay's product, the
// outer product written out, their sum, C's contraction as a batched GEMV,
// and the copy of the new state back into the cache).
//
// What bounds it on this card: 5 flops per state element against 8 bytes of
// it read and written, far below the H100's ~295 flops/byte balance point,
// so HBM bytes: the state read once and written once, 2 x B x H x P x N x 4
// bytes, is the least it can move (x, dt, B, C and y are ~1 % beside it).
// The design streams the state once:
//   - one block of 128 threads a (lane, head) tile of P x N fp32; N / 4
//     threads share a row, each one 16-byte float4 of it, neighbouring
//     threads on neighbouring addresses;
//   - each thread loads ROWS rows' float4s before it computes any, so that
//     ROWS x 16 bytes a thread are in flight;
//   - loads and stores carry the evict-first hint (__ldcs / __stcs): the
//     state (14.3 GB at zamba2's 96 lanes) never fits the 50 MB L2, and
//     nothing reads it again within the step;
//   - each row's y is summed over the threads that hold it by warp
//     shuffles; B_g and C_g are read once a thread (its 4 columns), x, dt
//     and them through their strides, so the model's column views of one
//     projection need no copy;
//   - the update is in place: each thread reads its own float4 before it
//     writes it, and no two blocks share a tile.
// The state is bit-identical to the plain ops (kernels/ssd_scan/ref.py
// ssd_decode_step): every product and sum rounded as they round it, with
// __fmul_rn / __fadd_rn where nvcc could otherwise contract them into an
// FMA, and expf of the rounded dt * A, as torch.exp computes it. Only y's
// sum over N is taken in another order.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 8;  // rows' float4s a thread keeps in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace

template <int N, typename T>
__global__ void __launch_bounds__(THREADS) ssd_decode_update(
    float* __restrict__ state, float* __restrict__ y,
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, int H, int P, int heads_per_group,
    int64_t xb, int64_t xh, int64_t dtb, int64_t dth, int64_t bb,
    int64_t bg, int64_t cb, int64_t cg) {
  constexpr int TPR = N / 4;           // threads a row, a float4 each
  constexpr int RPP = THREADS / TPR;   // rows the block covers in one pass
  const int64_t tile = blockIdx.x;     // lane * H + head
  const int lane = static_cast<int>(tile / H);
  const int h = static_cast<int>(tile - static_cast<int64_t>(lane) * H);
  const int g = h / heads_per_group;
  const int col = threadIdx.x % TPR, row0 = threadIdx.x / TPR;

  const float d = dt[lane * dtb + h * dth];
  const float decay = expf(__fmul_rn(d, a[h]));
  float bv[4], cv[4];
  const T* brow = bm + lane * bb + g * bg + 4 * col;
  const T* crow = cm + lane * cb + g * cg + 4 * col;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = to_float(brow[j]);
    cv[j] = to_float(crow[j]);
  }
  float4* s = reinterpret_cast<float4*>(state + tile * P * N) + col;
  const T* xr = x + lane * xb + h * xh;
  float* yr = y + tile * P;

  // block-uniform bounds, so that every thread of a warp reaches the
  // shuffles
  for (int base = 0; base < P; base += RPP * ROWS) {
    float4 v[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = base + row0 + i * RPP;
      if (r < P) v[i] = __ldcs(s + r * TPR);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = base + row0 + i * RPP;
      float acc = 0.f;
      if (r < P) {
        const float u = __fmul_rn(d, to_float(xr[r]));
        v[i].x = __fadd_rn(__fmul_rn(v[i].x, decay), __fmul_rn(u, bv[0]));
        v[i].y = __fadd_rn(__fmul_rn(v[i].y, decay), __fmul_rn(u, bv[1]));
        v[i].z = __fadd_rn(__fmul_rn(v[i].z, decay), __fmul_rn(u, bv[2]));
        v[i].w = __fadd_rn(__fmul_rn(v[i].w, decay), __fmul_rn(u, bv[3]));
        __stcs(s + r * TPR, v[i]);
        acc = cv[0] * v[i].x + cv[1] * v[i].y + cv[2] * v[i].z
            + cv[3] * v[i].w;
      }
#pragma unroll
      for (int o = TPR / 2; o; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (r < P && col == 0) yr[r] = acc;
    }
  }
}

template <int N, typename T>
static cudaError_t launch_n(float* state, float* y, const void* x,
                            const float* dt, const float* a, const void* bm,
                            const void* cm, int batch, int H, int P, int G,
                            const int64_t* xs, const int64_t* dts,
                            const int64_t* bs, const int64_t* cs,
                            cudaStream_t stream) {
  const int64_t tiles = static_cast<int64_t>(batch) * H;
  ssd_decode_update<N, T><<<static_cast<unsigned>(tiles), THREADS, 0,
                            stream>>>(
      state, y, static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), H, P, H / G, xs[0], xs[1], dts[0], dts[1],
      bs[0], bs[1], cs[0], cs[1]);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_t(float* state, float* y, const void* x,
                            const float* dt, const float* a, const void* bm,
                            const void* cm, int batch, int H, int P, int N,
                            int G, const int64_t* xs, const int64_t* dts,
                            const int64_t* bs, const int64_t* cs,
                            cudaStream_t stream) {
  switch (N) {
    case 16: return launch_n<16, T>(state, y, x, dt, a, bm, cm, batch, H, P,
                                    G, xs, dts, bs, cs, stream);
    case 64: return launch_n<64, T>(state, y, x, dt, a, bm, cm, batch, H, P,
                                    G, xs, dts, bs, cs, stream);
    case 128: return launch_n<128, T>(state, y, x, dt, a, bm, cm, batch, H,
                                      P, G, xs, dts, bs, cs, stream);
    default: return cudaErrorInvalidValue;
  }
}

// state (B, H, P, N) fp32 contiguous, updated in place; y (B, H, P) fp32
// contiguous; x (B, H, P), dt (B, H), B and C (B, G, N) read through their
// (batch, head or group) strides, last dims contiguous; x, B and C fp32
// (dtype 0) or bf16 (dtype 1). The Python wrapper has checked them.
cudaError_t ssd_decode_update_launch(
    float* state, float* y, const void* x, const float* dt, const float* a,
    const void* bm, const void* cm, int dtype, int batch, int H, int P,
    int N, int G, const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* b_strides, const int64_t* c_strides,
    cudaStream_t stream) {
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(state, y, x, dt, a, bm, cm, batch, H, P,
                                   N, G, x_strides, dt_strides, b_strides,
                                   c_strides, stream);
  return launch_t<float>(state, y, x, dt, a, bm, cm, batch, H, P, N, G,
                         x_strides, dt_strides, b_strides, c_strides,
                         stream);
}
