// Python binding of the port's CUDA kernels. The only source that includes
// PyTorch's headers: the kernels themselves (*/csrc/*.cu) expose plain C++
// launchers, so nvcc compiles them in seconds.
#include <array>

#include <torch/extension.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

cudaError_t flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int hq, int hkv, int d,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides,
    int causal, int window, int q_off, float scale, cudaStream_t stream);

cudaError_t chunked_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int hq, int hkv, int d,
    const int64_t* q_strides, const int64_t* k_strides,
    const int64_t* v_strides, const int64_t* o_strides,
    int causal, int window, int q_off, float scale, cudaStream_t stream);

cudaError_t ssd_scan_fwd_launch(
    const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, void* y, float* state, const float* init_state,
    float* keys, float* cstate, void* prev,
    int dtype, int batch, int L, int H, int P, int N, int G, int Q,
    const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* b_strides, const int64_t* c_strides,
    const int64_t* y_strides, cudaStream_t stream);

cudaError_t ssd_decode_update_launch(
    float* state, float* y, const void* x, const float* dt, const float* a,
    const void* bm, const void* cm, int dtype, int batch, int H, int P,
    int N, int G, const int64_t* x_strides, const int64_t* dt_strides,
    const int64_t* b_strides, const int64_t* c_strides,
    cudaStream_t stream);

cudaError_t rms_norm_fwd_launch(const void* x, const void* y, void* sum,
                                void* h, const void* scale, int scale_bf16,
                                int64_t rows, int d, float eps,
                                cudaStream_t stream);

cudaError_t rope_qk_fwd_launch(void* q, void* k, const float* sn,
                               const float* cs, int batch, int seq, int hq,
                               int hkv, int hd, const int64_t* q_strides,
                               const int64_t* k_strides,
                               const int64_t* t_strides,
                               cudaStream_t stream);

cudaError_t swiglu_gate_fwd_launch(const void* g, const void* u, void* out,
                                   int64_t n, cudaStream_t stream);

namespace {

using AttnLaunch = decltype(&flash_attention_fwd_launch);

// (batch, seq, head) element strides of a logical (B, H, S, D) tensor.
std::array<int64_t, 3> bsh_strides(const torch::Tensor& t) {
  return {t.stride(0), t.stride(2), t.stride(1)};
}

// q/o (B, Hq, S, D) and k/v (B, Hkv, S, D) in logical order, any strides
// with the last dim contiguous; the Python wrapper has checked them.
void attention_fwd(AttnLaunch launch, const char* name,
                   const torch::Tensor& q, const torch::Tensor& k,
                   const torch::Tensor& v, const torch::Tensor& o,
                   bool causal, int64_t window, double scale,
                   int64_t q_offset) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto qs = bsh_strides(q), ks = bsh_strides(k), vs = bsh_strides(v),
             os = bsh_strides(o);
  const int dtype = q.scalar_type() == torch::kBFloat16 ? 1 : 0;
  const cudaError_t err = launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dtype,
      q.size(0), q.size(2), k.size(2), q.size(1), k.size(1), q.size(3),
      qs.data(), ks.data(), vs.data(), os.data(), causal, window,
      static_cast<int>(q_offset), static_cast<float>(scale),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, name, " kernel launch failed: ",
              cudaGetErrorString(err));
}

void flash_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         bool causal, int64_t window, double scale,
                         int64_t q_offset) {
  attention_fwd(&flash_attention_fwd_launch, "flash_attention", q, k, v, o,
                causal, window, scale, q_offset);
}

void chunked_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                           const torch::Tensor& v, const torch::Tensor& o,
                           bool causal, int64_t window, double scale,
                           int64_t q_offset) {
  attention_fwd(&chunked_attention_fwd_launch, "chunked_attention", q, k, v,
                o, causal, window, scale, q_offset);
}

// Data pointer of a float32 tensor, or null where it is empty.
float* f32_or_null(const torch::Tensor& t) {
  return t.numel() ? t.data_ptr<float>() : nullptr;
}

// x/y (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, G, N), state and
// init_state (B, H, P, N) contiguous, init_state empty for a zero start;
// last dims contiguous. keys (3, B, H, L) fp32, cstate (B, nc, H, P, N)
// fp32 and prev (2, B, nc, H, P, N) bf16 are the bf16 body's scratch,
// contiguous, empty for fp32. The Python wrapper has checked them.
void ssd_scan_fwd(const torch::Tensor& x, const torch::Tensor& dt,
                  const torch::Tensor& a, const torch::Tensor& bm,
                  const torch::Tensor& cm, const torch::Tensor& y,
                  const torch::Tensor& state, const torch::Tensor& init_state,
                  const torch::Tensor& keys, const torch::Tensor& cstate,
                  const torch::Tensor& prev,
                  int64_t chunk) {
  const c10::cuda::CUDAGuard guard(x.device());
  const std::array<int64_t, 3> xs{x.stride(0), x.stride(1), x.stride(2)},
      dts{dt.stride(0), dt.stride(1), dt.stride(2)},
      ys{y.stride(0), y.stride(1), y.stride(2)};
  const std::array<int64_t, 3> bs{bm.stride(0), bm.stride(1), bm.stride(2)},
      cs{cm.stride(0), cm.stride(1), cm.stride(2)};
  const int dtype = x.scalar_type() == torch::kBFloat16 ? 1 : 0;
  const cudaError_t err = ssd_scan_fwd_launch(
      x.data_ptr(), dt.data_ptr<float>(), a.data_ptr<float>(), bm.data_ptr(),
      cm.data_ptr(), y.data_ptr(), state.data_ptr<float>(),
      f32_or_null(init_state), f32_or_null(keys), f32_or_null(cstate),
      prev.numel() ? prev.data_ptr() : nullptr, dtype,
      x.size(0), x.size(1), x.size(2), x.size(3), bm.size(3), bm.size(2),
      chunk,
      xs.data(), dts.data(), bs.data(), cs.data(), ys.data(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "ssd_scan kernel launch failed: ",
              cudaGetErrorString(err));
}

// state (B, H, P, N) fp32 contiguous, updated in place; y (B, H, P) fp32
// contiguous; x (B, H, P), dt (B, H), B and C (B, G, N), last dims
// contiguous. The Python wrapper has checked them.
void ssd_decode_update(const torch::Tensor& state, const torch::Tensor& y,
                       const torch::Tensor& x, const torch::Tensor& dt,
                       const torch::Tensor& a, const torch::Tensor& bm,
                       const torch::Tensor& cm) {
  const c10::cuda::CUDAGuard guard(state.device());
  const std::array<int64_t, 2> xs{x.stride(0), x.stride(1)},
      dts{dt.stride(0), dt.stride(1)}, bs{bm.stride(0), bm.stride(1)},
      cs{cm.stride(0), cm.stride(1)};
  const cudaError_t err = ssd_decode_update_launch(
      state.data_ptr<float>(), y.data_ptr<float>(), x.data_ptr(),
      dt.data_ptr<float>(), a.data_ptr<float>(), bm.data_ptr(),
      cm.data_ptr(), x.scalar_type() == torch::kBFloat16 ? 1 : 0,
      state.size(0), state.size(1), state.size(2), state.size(3),
      bm.size(1), xs.data(), dts.data(), bs.data(), cs.data(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "ssd_decode_update kernel launch failed: ",
              cudaGetErrorString(err));
}

// x, h (..., D) bf16 contiguous, scale (D,) bf16 or fp32; y and sum
// empty for the plain norm, else like x: sum = x + y, h = norm(sum). The
// Python wrapper has checked them.
void rms_norm_fwd(const torch::Tensor& x, const torch::Tensor& y,
                  const torch::Tensor& sum, const torch::Tensor& h,
                  const torch::Tensor& scale, double eps) {
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t d = x.size(-1);
  const cudaError_t err = rms_norm_fwd_launch(
      x.data_ptr(), y.numel() ? y.data_ptr() : nullptr,
      sum.numel() ? sum.data_ptr() : nullptr, h.data_ptr(),
      scale.data_ptr(), scale.scalar_type() == torch::kBFloat16 ? 1 : 0,
      x.numel() / d, static_cast<int>(d), static_cast<float>(eps),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "rms_norm kernel launch failed: ",
              cudaGetErrorString(err));
}

// q (B, S, Hq, D), k (B, S, Hkv, D) bf16, head dims contiguous, rotated in
// place; sin/cos fp32 (S, D/2) or (B, S, D/2), last dim contiguous. The
// Python wrapper has checked them.
void rope_qk_fwd(const torch::Tensor& q, const torch::Tensor& k,
                 const torch::Tensor& sn, const torch::Tensor& cs) {
  const c10::cuda::CUDAGuard guard(q.device());
  const std::array<int64_t, 3> qs{q.stride(0), q.stride(1), q.stride(2)},
      ks{k.stride(0), k.stride(1), k.stride(2)};
  const bool batched = sn.dim() == 3;
  const std::array<int64_t, 2> ts{batched ? sn.stride(0) : 0,
                                  sn.stride(batched ? 1 : 0)};
  const cudaError_t err = rope_qk_fwd_launch(
      q.data_ptr(), k.data_ptr(), sn.data_ptr<float>(), cs.data_ptr<float>(),
      q.size(0), q.size(1), q.size(2), k.size(2), q.size(3), qs.data(),
      ks.data(), ts.data(), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "rope_qk kernel launch failed: ",
              cudaGetErrorString(err));
}

// g, u, out bf16 contiguous, of one shape. The Python wrapper has checked
// them.
void swiglu_gate_fwd(const torch::Tensor& g, const torch::Tensor& u,
                     const torch::Tensor& out) {
  const c10::cuda::CUDAGuard guard(g.device());
  const cudaError_t err = swiglu_gate_fwd_launch(
      g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "swiglu_gate kernel launch failed: ",
              cudaGetErrorString(err));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention_fwd", &flash_attention_fwd);
  m.def("chunked_attention_fwd", &chunked_attention_fwd);
  m.def("ssd_scan_fwd", &ssd_scan_fwd);
  m.def("ssd_decode_update", &ssd_decode_update);
  m.def("rms_norm_fwd", &rms_norm_fwd);
  m.def("rope_qk_fwd", &rope_qk_fwd);
  m.def("swiglu_gate_fwd", &swiglu_gate_fwd);
}
