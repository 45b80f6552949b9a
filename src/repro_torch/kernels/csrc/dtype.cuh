// Element conversions shared by the port's CUDA kernels (flash attention,
// chunked two-pass attention, the SSD scan): every kernel loads fp32 or
// bf16 inputs, computes in fp32 and stores in the input's dtype.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
