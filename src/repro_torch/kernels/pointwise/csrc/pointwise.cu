// The sequence forward's pointwise ops for Hopper (sm_90a), bf16 in and out:
// RMSNorm, the attention's residual add fused with the next RMSNorm, RoPE on
// q and k, and SwiGLU's gate.
//
// They replace no TPU kernel: the reference writes these ops in plain JAX
// (src/repro/models/layers.py rms_norm, apply_rope, swiglu) and XLA fuses
// them. Eager PyTorch runs each as several passes over device memory, with
// fp32 copies of the activations in between. Each kernel here reads its bf16
// inputs once and writes its bf16 outputs once; the fp32 math stays in
// registers.
//
// What bounds them on this card: a few flops per byte, far below the
// H100's ~295 flops/byte balance point, so they are bound by HBM bytes.
// Every load and store is 16 bytes a thread (8 bf16 values), neighbouring
// threads on neighbouring addresses.
//
// The math is the plain ops' (models/layers.py), in the same order and with
// the same roundings, so that RoPE, SwiGLU and the residual sum are
// bit-identical to them and a norm differs only by the order of its fp32
// sum. Products and sums are written with the _rn intrinsics where nvcc
// could otherwise contract them into an FMA that the plain ops do not do.
//   - rms_norm_fwd: one block a row, the row in registers (VPT vectors a
//     thread); h = (x * rsqrt(mean(x^2) + eps)) * (1 + scale). With ADD it
//     first forms x + y, rounds it to bf16, writes it, and normalises the
//     rounded sum, as the plain bf16 add followed by the norm does.
//   - rope_qk_fwd: one block a (batch, position); each thread rotates 8
//     pairs (x1, x2) of one head of q or k in place:
//     (x1 cos - x2 sin, x2 cos + x1 sin), the fp32 tables read through their
//     strides ((S, D/2) or (B, S, D/2)).
//   - swiglu_gate_fwd: silu(g) rounded to bf16, as F.silu's bf16 output is,
//     times u; silu is x / (1 + expf(-x)), the formula of PyTorch's CUDA
//     silu.
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 8;  // bf16 values in one 16-byte access

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void load8(const float* s, float (&f)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* s,
                                      float (&f)[VEC]) {
  unpack(*reinterpret_cast<const uint4*>(s), f);
}

// The sum of v over the block, the same in every thread; blockDim.x is a
// multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace

template <int VPT, bool ADD, typename S>
__global__ void __launch_bounds__(256) rms_norm_fwd(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ sum, __nv_bfloat16* __restrict__ h,
    const S* __restrict__ scale, int d, float inv_d, float eps) {
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  const int nvec = d / VEC;
  float v[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      unpack(reinterpret_cast<const uint4*>(x + off)[c], v[i]);
      if (ADD) {
        float w[VEC];
        unpack(reinterpret_cast<const uint4*>(y + off)[c], w);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[i][j] = __fadd_rn(v[i][j], w[j]);
        const uint4 s = pack(v[i]);
        reinterpret_cast<uint4*>(sum + off)[c] = s;
        unpack(s, v[i]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = fmaf(v[i][j], v[i][j], ss);
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), inv_d), eps));
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float sc[VEC];
      load8(scale + c * VEC, sc);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[i][j] = __fmul_rn(__fmul_rn(v[i][j], r), __fadd_rn(1.f, sc[j]));
      reinterpret_cast<uint4*>(h + off)[c] = pack(v[i]);
    }
  }
}

__global__ void __launch_bounds__(256) rope_qk_fwd(
    __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
    const float* __restrict__ sn, const float* __restrict__ cs, int seq,
    int hq, int hkv, int half, int64_t qb, int64_t qs, int64_t qh,
    int64_t kb, int64_t ks, int64_t kh, int64_t tb, int64_t ts) {
  const int b = blockIdx.x / seq, s = blockIdx.x % seq;
  const int chunks = half / VEC;
  const int64_t t = b * tb + s * ts;
  __nv_bfloat16* const qrow = q + b * qb + s * qs;
  __nv_bfloat16* const krow = k + b * kb + s * ks;
  for (int i = threadIdx.x; i < (hq + hkv) * chunks; i += blockDim.x) {
    const int head = i / chunks, c = (i - head * chunks) * VEC;
    __nv_bfloat16* const row =
        head < hq ? qrow + head * qh : krow + (head - hq) * kh;
    float x1[VEC], x2[VEC], sv[VEC], cv[VEC], o1[VEC], o2[VEC];
    unpack(*reinterpret_cast<const uint4*>(row + c), x1);
    unpack(*reinterpret_cast<const uint4*>(row + half + c), x2);
    load8(sn + t + c, sv);
    load8(cs + t + c, cv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      o1[j] = __fsub_rn(__fmul_rn(x1[j], cv[j]), __fmul_rn(x2[j], sv[j]));
      o2[j] = __fadd_rn(__fmul_rn(x2[j], cv[j]), __fmul_rn(x1[j], sv[j]));
    }
    *reinterpret_cast<uint4*>(row + c) = pack(o1);
    *reinterpret_cast<uint4*>(row + half + c) = pack(o2);
  }
}

__global__ void __launch_bounds__(256) swiglu_gate_fwd(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ u,
    __nv_bfloat16* __restrict__ out, int64_t nvec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (i >= nvec) return;
  float gv[VEC], uv[VEC];
  unpack(reinterpret_cast<const uint4*>(g)[i], gv);
  unpack(reinterpret_cast<const uint4*>(u)[i], uv);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float silu = __fdiv_rn(gv[j], __fadd_rn(1.f, expf(-gv[j])));
    gv[j] = __fmul_rn(__bfloat162float(__float2bfloat16(silu)), uv[j]);
  }
  reinterpret_cast<uint4*>(out)[i] = pack(gv);
}

namespace {

template <int VPT, bool ADD, typename S>
void launch_norm(const void* x, const void* y, void* sum, void* h,
                 const void* scale, int64_t rows, int d, int threads,
                 float eps, cudaStream_t stream) {
  rms_norm_fwd<VPT, ADD, S><<<static_cast<unsigned>(rows), threads, 0,
                              stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(sum), static_cast<__nv_bfloat16*>(h),
      static_cast<const S*>(scale), d, 1.f / static_cast<float>(d), eps);
}

template <bool ADD, typename S>
cudaError_t launch_norm_vpt(const void* x, const void* y, void* sum,
                            void* h, const void* scale, int64_t rows, int d,
                            float eps, cudaStream_t stream) {
  // the fewest vectors a thread that keep a row within 128 threads, or
  // 8 a thread and up to 256 threads for the widest rows (d <= 16384)
  const int nvec = d / VEC;
  int vpt = 8;
  for (int c : {1, 2, 4})
    if (nvec <= 128 * c) { vpt = c; break; }
  const int threads = ((nvec + vpt - 1) / vpt + 31) / 32 * 32;
  if (threads > 256) return cudaErrorInvalidValue;
  switch (vpt) {
    case 1: launch_norm<1, ADD, S>(x, y, sum, h, scale, rows, d, threads, eps, stream); break;
    case 2: launch_norm<2, ADD, S>(x, y, sum, h, scale, rows, d, threads, eps, stream); break;
    case 4: launch_norm<4, ADD, S>(x, y, sum, h, scale, rows, d, threads, eps, stream); break;
    default: launch_norm<8, ADD, S>(x, y, sum, h, scale, rows, d, threads, eps, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y, sum, h: (rows, d) bf16, contiguous, 16-byte aligned; d a multiple of
// 8; scale (d,) bf16 (scale_bf16 1) or fp32 (0). y and sum are null for the
// plain norm, else sum = bf16(x + y) and h = norm(sum).
cudaError_t rms_norm_fwd_launch(const void* x, const void* y, void* sum,
                                void* h, const void* scale, int scale_bf16,
                                int64_t rows, int d, float eps,
                                cudaStream_t stream) {
  if (rows < 1 || d < VEC || d % VEC) return cudaErrorInvalidValue;
  if (y != nullptr)
    return scale_bf16
        ? launch_norm_vpt<true, __nv_bfloat16>(x, y, sum, h, scale, rows, d, eps, stream)
        : launch_norm_vpt<true, float>(x, y, sum, h, scale, rows, d, eps, stream);
  return scale_bf16
      ? launch_norm_vpt<false, __nv_bfloat16>(x, y, sum, h, scale, rows, d, eps, stream)
      : launch_norm_vpt<false, float>(x, y, sum, h, scale, rows, d, eps, stream);
}

// q (B, S, Hq, D), k (B, S, Hkv, D) bf16, rotated in place; sin, cos fp32
// (B, S, D/2) read through their (batch, position) strides, 0 for a table
// shared by the batch. Strides in elements, (batch, position, head); the
// last dims contiguous and every row 16-byte aligned; D/2 a multiple of 8.
cudaError_t rope_qk_fwd_launch(void* q, void* k, const float* sn,
                               const float* cs, int batch, int seq, int hq,
                               int hkv, int hd, const int64_t* q_strides,
                               const int64_t* k_strides,
                               const int64_t* t_strides,
                               cudaStream_t stream) {
  const int half = hd / 2;
  if (batch < 1 || seq < 1 || half % VEC
      || static_cast<int64_t>(batch) * seq > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int items = (hq + hkv) * (half / VEC);
  const int threads = items >= 256 ? 256 : (items + 31) / 32 * 32;
  rope_qk_fwd<<<batch * seq, threads, 0, stream>>>(
      static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k), sn, cs,
      seq, hq, hkv, half, q_strides[0], q_strides[1], q_strides[2],
      k_strides[0], k_strides[1], k_strides[2], t_strides[0], t_strides[1]);
  return cudaGetLastError();
}

// g, u, out: n bf16 values each, contiguous, 16-byte aligned; n a multiple
// of 8.
cudaError_t swiglu_gate_fwd_launch(const void* g, const void* u, void* out,
                                   int64_t n, cudaStream_t stream) {
  if (n < VEC || n % VEC) return cudaErrorInvalidValue;
  const int64_t nvec = n / VEC;
  const int64_t blocks = (nvec + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  swiglu_gate_fwd<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(u),
      static_cast<__nv_bfloat16*>(out), nvec);
  return cudaGetLastError();
}
