// Python binding of the port's CUDA kernels. The only source that includes
// PyTorch's headers: the kernels themselves (*.cu) expose plain C++
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
    int causal, int window, float scale, cudaStream_t stream);

// q/o (B, Hq, S, D) and k/v (B, Hkv, S, D) in logical order, any strides
// with the last dim contiguous; the Python wrapper has checked them.
void flash_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         bool causal, int64_t window, double scale) {
  const c10::cuda::CUDAGuard guard(q.device());
  auto strides = [](const torch::Tensor& t) {
    return std::array<int64_t, 3>{t.stride(0), t.stride(2), t.stride(1)};
  };
  const auto qs = strides(q), ks = strides(k), vs = strides(v), os = strides(o);
  const int dtype = q.scalar_type() == torch::kBFloat16 ? 1 : 0;
  const cudaError_t err = flash_attention_fwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dtype,
      q.size(0), q.size(2), k.size(2), q.size(1), k.size(1), q.size(3),
      qs.data(), ks.data(), vs.data(), os.data(), causal, window,
      static_cast<float>(scale), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "flash_attention kernel launch failed: ",
              cudaGetErrorString(err));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention_fwd", &flash_attention_fwd);
}
