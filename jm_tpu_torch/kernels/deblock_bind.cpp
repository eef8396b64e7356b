// PyTorch binding of the deblock kernels (deblock.cu): the 8-bit K1 / K2 /
// K2-422 on uint8 planes and their >8-bit variants on int16 planes. The only file of
// the extension that includes torch/extension.h: the .cu source has a
// plain C++ interface, so nvcc never compiles PyTorch's headers.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>

void launch_deblock_luma(const uint8_t* in, uint8_t* out, int stride,
                         const int32_t* qp, const int32_t* disable,
                         const int32_t* a_off, const int32_t* b_off,
                         const int32_t* slice_id, const int32_t* t8,
                         const int8_t* bs_v, const int8_t* bs_h,
                         int* scratch, int mb_w, int mb_h, int grid,
                         cudaStream_t stream);
void launch_deblock_chroma(const uint8_t* in_u, const uint8_t* in_v,
                           uint8_t* out_u, uint8_t* out_v, int stride,
                           const int32_t* qp, const int32_t* disable,
                           const int32_t* a_off, const int32_t* b_off,
                           const int32_t* slice_id, const int32_t* t8,
                           const int8_t* bs_v, const int8_t* bs_h,
                           const int32_t* qpc_cb, const int32_t* qpc_cr,
                           int* scratch, int mb_w, int mb_h, int rows,
                           int grid, cudaStream_t stream);
void launch_deblock_luma16(const int16_t* in, int16_t* out, int stride,
                           const int32_t* qp, const int32_t* disable,
                           const int32_t* a_off, const int32_t* b_off,
                           const int32_t* slice_id, const int32_t* t8,
                           const int8_t* bs_v, const int8_t* bs_h,
                           int* scratch, int mb_w, int mb_h, int bd,
                           int grid, cudaStream_t stream);
void launch_deblock_chroma16(const int16_t* in_u, const int16_t* in_v,
                             int16_t* out_u, int16_t* out_v, int stride,
                             const int32_t* qp, const int32_t* disable,
                             const int32_t* a_off, const int32_t* b_off,
                             const int32_t* slice_id, const int32_t* t8,
                             const int8_t* bs_v, const int8_t* bs_h,
                             const int32_t* qpc_cb, const int32_t* qpc_cr,
                             int* scratch, int mb_w, int mb_h, int rows,
                             int bd, int qoff, int grid,
                             cudaStream_t stream);

namespace {

void check(const torch::Tensor& t, torch::ScalarType dtype, const char* name,
           int64_t align = 1) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has the wrong dtype");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % align == 0, name,
              " must be ", align, "-byte aligned");
}

void check_mb_args(const torch::Tensor& bs_v, const torch::Tensor& bs_h,
                   std::initializer_list<const torch::Tensor*> per_mb,
                   const torch::Tensor& scratch, int64_t mb_h) {
  // bS rows are read 4 entries (one 32-bit word) at a time
  check(bs_v, torch::kInt8, "bs_v", 4);
  check(bs_h, torch::kInt8, "bs_h");
  for (auto* t : per_mb) check(*t, torch::kInt32, "per-MB parameter");
  check(scratch, torch::kInt32, "scratch");
  TORCH_CHECK(scratch.numel() == 1 + mb_h, "scratch must hold 1 + mb_h");
}

// One CTA per MB row, at most one per SM: a CTA that finishes its row
// takes the next unclaimed one.
int grid_size(int64_t mb_h) {
  return (int)std::min<int64_t>(
      mb_h, at::cuda::getCurrentDeviceProperties()->multiProcessorCount);
}

}  // namespace

// K1: filters Y (16 mb_h, 16 mb_w) uint8 into Y_out; scratch is
// (1 + mb_h,) int32 zeros. Returns the launch count (1).
int64_t deblock_luma(torch::Tensor Y, torch::Tensor Y_out,
                     torch::Tensor scratch, torch::Tensor bs_v,
                     torch::Tensor bs_h, torch::Tensor qp,
                     torch::Tensor disable, torch::Tensor a_off,
                     torch::Tensor b_off, torch::Tensor slice_id,
                     torch::Tensor t8, int64_t mb_w, int64_t mb_h) {
  // the interior of each MB row is read as 16-byte vectors
  check(Y, torch::kUInt8, "Y", 16);
  check(Y_out, torch::kUInt8, "Y_out");
  TORCH_CHECK(Y.sizes() == Y_out.sizes(), "Y and Y_out shapes differ");
  check_mb_args(bs_v, bs_h, {&qp, &disable, &a_off, &b_off, &slice_id, &t8},
                scratch, mb_h);
  const c10::cuda::CUDAGuard guard(Y.device());
  launch_deblock_luma(
      Y.data_ptr<uint8_t>(), Y_out.data_ptr<uint8_t>(), (int)Y.stride(0),
      qp.data_ptr<int32_t>(), disable.data_ptr<int32_t>(),
      a_off.data_ptr<int32_t>(), b_off.data_ptr<int32_t>(),
      slice_id.data_ptr<int32_t>(), t8.data_ptr<int32_t>(),
      bs_v.data_ptr<int8_t>(), bs_h.data_ptr<int8_t>(),
      scratch.data_ptr<int32_t>(), (int)mb_w, (int)mb_h, grid_size(mb_h),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return 1;
}

// K2 (rows 8, 4:2:0) and K2-422 (rows 16, 4:2:2): filters U and V
// (rows mb_h, 8 mb_w) uint8 into U_out and V_out; scratch is (1 + mb_h,)
// int32 zeros. Returns the launch count (1).
int64_t deblock_chroma(torch::Tensor U, torch::Tensor V, torch::Tensor U_out,
                       torch::Tensor V_out, torch::Tensor scratch,
                       torch::Tensor bs_v, torch::Tensor bs_h,
                       torch::Tensor qp, torch::Tensor disable,
                       torch::Tensor a_off, torch::Tensor b_off,
                       torch::Tensor slice_id, torch::Tensor t8,
                       torch::Tensor qpc_cb, torch::Tensor qpc_cr,
                       int64_t mb_w, int64_t mb_h, int64_t rows) {
  TORCH_CHECK(rows == 8 || rows == 16, "chroma rows per MB: 8 or 16");
  TORCH_CHECK(U.size(0) == rows * mb_h && U.size(1) == 8 * mb_w,
              "U must be (rows mb_h, 8 mb_w)");
  // the interior of each MB row is read as 8-byte vectors
  check(U, torch::kUInt8, "U", 8);
  check(V, torch::kUInt8, "V", 8);
  check(U_out, torch::kUInt8, "U_out");
  check(V_out, torch::kUInt8, "V_out");
  for (auto* t : {&V, &U_out, &V_out})
    TORCH_CHECK(t->sizes() == U.sizes(), "chroma plane shapes differ");
  check_mb_args(bs_v, bs_h,
                {&qp, &disable, &a_off, &b_off, &slice_id, &t8, &qpc_cb,
                 &qpc_cr},
                scratch, mb_h);
  const c10::cuda::CUDAGuard guard(U.device());
  launch_deblock_chroma(
      U.data_ptr<uint8_t>(), V.data_ptr<uint8_t>(),
      U_out.data_ptr<uint8_t>(), V_out.data_ptr<uint8_t>(),
      (int)U.stride(0), qp.data_ptr<int32_t>(), disable.data_ptr<int32_t>(),
      a_off.data_ptr<int32_t>(), b_off.data_ptr<int32_t>(),
      slice_id.data_ptr<int32_t>(), t8.data_ptr<int32_t>(),
      bs_v.data_ptr<int8_t>(), bs_h.data_ptr<int8_t>(),
      qpc_cb.data_ptr<int32_t>(), qpc_cr.data_ptr<int32_t>(),
      scratch.data_ptr<int32_t>(), (int)mb_w, (int)mb_h, (int)rows,
      grid_size(mb_h), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return 1;
}

// K1-HBD: filters Y (16 mb_h, 16 mb_w) int16 samples of bd bits (8-14)
// into Y_out. Returns the launch count (1).
int64_t deblock_luma16(torch::Tensor Y, torch::Tensor Y_out,
                       torch::Tensor scratch, torch::Tensor bs_v,
                       torch::Tensor bs_h, torch::Tensor qp,
                       torch::Tensor disable, torch::Tensor a_off,
                       torch::Tensor b_off, torch::Tensor slice_id,
                       torch::Tensor t8, int64_t mb_w, int64_t mb_h,
                       int64_t bd) {
  TORCH_CHECK(bd >= 8 && bd <= 14, "bit depth 8..14");
  // the interior of each MB row is read as two 16-byte vectors
  check(Y, torch::kInt16, "Y", 16);
  check(Y_out, torch::kInt16, "Y_out");
  TORCH_CHECK(Y.sizes() == Y_out.sizes(), "Y and Y_out shapes differ");
  TORCH_CHECK(Y.size(0) == 16 * mb_h && Y.size(1) == 16 * mb_w,
              "Y must be (16 mb_h, 16 mb_w)");
  check_mb_args(bs_v, bs_h, {&qp, &disable, &a_off, &b_off, &slice_id, &t8},
                scratch, mb_h);
  const c10::cuda::CUDAGuard guard(Y.device());
  launch_deblock_luma16(
      Y.data_ptr<int16_t>(), Y_out.data_ptr<int16_t>(), (int)Y.stride(0),
      qp.data_ptr<int32_t>(), disable.data_ptr<int32_t>(),
      a_off.data_ptr<int32_t>(), b_off.data_ptr<int32_t>(),
      slice_id.data_ptr<int32_t>(), t8.data_ptr<int32_t>(),
      bs_v.data_ptr<int8_t>(), bs_h.data_ptr<int8_t>(),
      scratch.data_ptr<int32_t>(), (int)mb_w, (int)mb_h, (int)bd,
      grid_size(mb_h), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return 1;
}

// K2-HBD (rows 8) and K2-422-HBD (rows 16): filters U and V (rows mb_h,
// 8 mb_w) int16 samples of bd bits; qpc_cb / qpc_cr hold 52 + QpBdOffsetY
// entries, from QPY -QpBdOffsetY. Returns the launch count (1).
int64_t deblock_chroma16(torch::Tensor U, torch::Tensor V,
                         torch::Tensor U_out, torch::Tensor V_out,
                         torch::Tensor scratch, torch::Tensor bs_v,
                         torch::Tensor bs_h, torch::Tensor qp,
                         torch::Tensor disable, torch::Tensor a_off,
                         torch::Tensor b_off, torch::Tensor slice_id,
                         torch::Tensor t8, torch::Tensor qpc_cb,
                         torch::Tensor qpc_cr, int64_t mb_w, int64_t mb_h,
                         int64_t rows, int64_t bd) {
  TORCH_CHECK(rows == 8 || rows == 16, "chroma rows per MB: 8 or 16");
  TORCH_CHECK(bd >= 8 && bd <= 14, "bit depth 8..14");
  TORCH_CHECK(U.size(0) == rows * mb_h && U.size(1) == 8 * mb_w,
              "U must be (rows mb_h, 8 mb_w)");
  const int64_t qoff = qpc_cb.numel() - 52;
  TORCH_CHECK(qoff >= 0 && qoff <= 36 && qoff % 6 == 0 &&
                  qpc_cr.numel() == qpc_cb.numel(),
              "QPc tables of 52 + QpBdOffsetY entries");
  // the interior of each MB row is read as one 16-byte vector
  check(U, torch::kInt16, "U", 16);
  check(V, torch::kInt16, "V", 16);
  check(U_out, torch::kInt16, "U_out");
  check(V_out, torch::kInt16, "V_out");
  for (auto* t : {&V, &U_out, &V_out})
    TORCH_CHECK(t->sizes() == U.sizes(), "chroma plane shapes differ");
  check_mb_args(bs_v, bs_h,
                {&qp, &disable, &a_off, &b_off, &slice_id, &t8, &qpc_cb,
                 &qpc_cr},
                scratch, mb_h);
  const c10::cuda::CUDAGuard guard(U.device());
  launch_deblock_chroma16(
      U.data_ptr<int16_t>(), V.data_ptr<int16_t>(),
      U_out.data_ptr<int16_t>(), V_out.data_ptr<int16_t>(),
      (int)U.stride(0), qp.data_ptr<int32_t>(), disable.data_ptr<int32_t>(),
      a_off.data_ptr<int32_t>(), b_off.data_ptr<int32_t>(),
      slice_id.data_ptr<int32_t>(), t8.data_ptr<int32_t>(),
      bs_v.data_ptr<int8_t>(), bs_h.data_ptr<int8_t>(),
      qpc_cb.data_ptr<int32_t>(), qpc_cr.data_ptr<int32_t>(),
      scratch.data_ptr<int32_t>(), (int)mb_w, (int)mb_h, (int)rows, (int)bd,
      (int)qoff, grid_size(mb_h), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return 1;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("deblock_luma", &deblock_luma,
        "K1: luma deblock, one persistent launch");
  m.def("deblock_chroma", &deblock_chroma,
        "K2 / K2-422: chroma deblock, one persistent launch");
  m.def("deblock_luma16", &deblock_luma16,
        "K1-HBD: >8-bit luma deblock, one persistent launch");
  m.def("deblock_chroma16", &deblock_chroma16,
        "K2-HBD / K2-422-HBD: >8-bit chroma deblock, one persistent "
        "launch");
}
