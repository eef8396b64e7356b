// PyTorch binding of the deblock kernels (deblock.cu). The only file of
// the extension that includes torch/extension.h: the .cu source has a
// plain C++ interface, so nvcc never compiles PyTorch's headers.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

void launch_deblock_luma_wave(uint8_t* Y, int stride, const int32_t* qp,
                              const int32_t* disable, const int32_t* a_off,
                              const int32_t* b_off, const int32_t* slice_id,
                              const int32_t* t8, const int8_t* bs_v,
                              const int8_t* bs_h, int mb_w, int mb_h, int w,
                              cudaStream_t stream);
void launch_deblock_chroma_wave(uint8_t* U, uint8_t* V, int stride,
                                const int32_t* qp, const int32_t* disable,
                                const int32_t* a_off, const int32_t* b_off,
                                const int32_t* slice_id, const int32_t* t8,
                                const int8_t* bs_v, const int8_t* bs_h,
                                const int32_t* qpc_cb, const int32_t* qpc_cr,
                                int mb_w, int mb_h, int w,
                                cudaStream_t stream);

namespace {

void check(const torch::Tensor& t, torch::ScalarType dtype, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

int n_waves(int mb_w, int mb_h) {
  return mb_h > 1 ? mb_w + 2 * (mb_h - 1) : mb_w;
}

}  // namespace

// Filters Y (16 mb_h, 16 mb_w) uint8 in place; returns the launch count.
int64_t deblock_luma(torch::Tensor Y, torch::Tensor bs_v, torch::Tensor bs_h,
                     torch::Tensor qp, torch::Tensor disable,
                     torch::Tensor a_off, torch::Tensor b_off,
                     torch::Tensor slice_id, torch::Tensor t8, int64_t mb_w,
                     int64_t mb_h) {
  check(Y, torch::kUInt8, "Y");
  for (auto* t : {&bs_v, &bs_h}) check(*t, torch::kInt8, "bs");
  for (auto* t : {&qp, &disable, &a_off, &b_off, &slice_id, &t8})
    check(*t, torch::kInt32, "per-MB parameter");
  const c10::cuda::CUDAGuard guard(Y.device());
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  int nw = n_waves(mb_w, mb_h);
  for (int w = 0; w < nw; ++w) {
    launch_deblock_luma_wave(
        Y.data_ptr<uint8_t>(), (int)Y.stride(0), qp.data_ptr<int32_t>(),
        disable.data_ptr<int32_t>(), a_off.data_ptr<int32_t>(),
        b_off.data_ptr<int32_t>(), slice_id.data_ptr<int32_t>(),
        t8.data_ptr<int32_t>(), bs_v.data_ptr<int8_t>(),
        bs_h.data_ptr<int8_t>(), (int)mb_w, (int)mb_h, w, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  return nw;
}

// Filters U and V (8 mb_h, 8 mb_w) uint8 in place; returns the launch count.
int64_t deblock_chroma(torch::Tensor U, torch::Tensor V, torch::Tensor bs_v,
                       torch::Tensor bs_h, torch::Tensor qp,
                       torch::Tensor disable, torch::Tensor a_off,
                       torch::Tensor b_off, torch::Tensor slice_id,
                       torch::Tensor t8, torch::Tensor qpc_cb,
                       torch::Tensor qpc_cr, int64_t mb_w, int64_t mb_h) {
  check(U, torch::kUInt8, "U");
  check(V, torch::kUInt8, "V");
  TORCH_CHECK(U.stride(0) == V.stride(0), "U and V strides differ");
  for (auto* t : {&bs_v, &bs_h}) check(*t, torch::kInt8, "bs");
  for (auto* t : {&qp, &disable, &a_off, &b_off, &slice_id, &t8, &qpc_cb,
                  &qpc_cr})
    check(*t, torch::kInt32, "per-MB parameter");
  const c10::cuda::CUDAGuard guard(U.device());
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  int nw = n_waves(mb_w, mb_h);
  for (int w = 0; w < nw; ++w) {
    launch_deblock_chroma_wave(
        U.data_ptr<uint8_t>(), V.data_ptr<uint8_t>(), (int)U.stride(0),
        qp.data_ptr<int32_t>(), disable.data_ptr<int32_t>(),
        a_off.data_ptr<int32_t>(), b_off.data_ptr<int32_t>(),
        slice_id.data_ptr<int32_t>(), t8.data_ptr<int32_t>(),
        bs_v.data_ptr<int8_t>(), bs_h.data_ptr<int8_t>(),
        qpc_cb.data_ptr<int32_t>(), qpc_cr.data_ptr<int32_t>(), (int)mb_w,
        (int)mb_h, w, stream);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
  return nw;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("deblock_luma", &deblock_luma, "K1: luma deblock, in place");
  m.def("deblock_chroma", &deblock_chroma, "K2: chroma deblock, in place");
}
