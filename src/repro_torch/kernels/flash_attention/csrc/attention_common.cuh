// Definitions shared by the two attention kernels of the port
// (flash_attention.cu: one pass, online softmax; chunked_attention.cu: two
// passes, lazy softmax): tile sizes, the parameter block and the head-dim
// dispatch. Both compute softmax(q k^T / sqrt(d) + mask) v for
// q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), causal and/or sliding window,
// GQA, on the same grid: one block per (q tile of BQ rows, q head, batch),
// TPR threads per query row, each owning an interleaved D/TPR slice of the
// head dim (dims i*4*TPR + part*4 + c), so K/V rows are read from shared
// memory as conflict-free float4s and a row's dot product is finished with
// two warp shuffles. Inputs are read through element strides in the
// (B, S, H, D) layout with the last dim contiguous; ragged tails are load
// and store masks, not padding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/dtype.cuh"

namespace attn {

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 32;               // kv rows per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int NTHREADS = BQ * TPR;   // 128
constexpr float NEG = -1e30f;

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
  float scale;
};

inline Params make_params(const void* q, const void* k, const void* v,
                          void* o, int sq, int skv, int hq, int hkv,
                          const int64_t* q_strides, const int64_t* k_strides,
                          const int64_t* v_strides, const int64_t* o_strides,
                          int causal, int window, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_strides[0]; p.q_ss = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.o_sb = o_strides[0]; p.o_ss = o_strides[1]; p.o_sh = o_strides[2];
  p.sq = sq; p.skv = skv; p.group = hq / hkv;
  p.causal = causal; p.window = window; p.scale = scale;
  return p;
}

// Launch kernel<T, D> for the head dims both kernels instantiate.
#define ATTN_DISPATCH_D(KERNEL, T, d, grid, stream, p)                      \
  switch (d) {                                                              \
    case 32: KERNEL<T, 32><<<grid, attn::NTHREADS, 0, stream>>>(p); break;  \
    case 64: KERNEL<T, 64><<<grid, attn::NTHREADS, 0, stream>>>(p); break;  \
    case 112: KERNEL<T, 112><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    case 128: KERNEL<T, 128><<<grid, attn::NTHREADS, 0, stream>>>(p); break; \
    default: return cudaErrorInvalidValue;                                  \
  }

}  // namespace attn
