// The GEMM cores of common.cuh on their own, for their tests: out (m, n)
// f32 = A . B, A and B in one of the layouts the kernels use, at a given
// tile width; and the half-layer routes (forward: A bf16 row-major, B the
// f32 master (n, k); data gradient: the f32 master (k, n); weight
// gradient: A stored (k, m) and B (k, n), both bf16, with A's column sums).
// Built on demand (ops/_cuda.py); the port's paths never call it.
#include "common.cuh"

namespace {

template <typename T, int AL, int BL>
cudaError_t run(const tgfr::GemmArgs& p, cudaStream_t s) {
  const auto kernel = tgfr::gemm_kernel<T, tgfr::kEpiF32, AL, BL>;
  const size_t smem = tgfr::gemm_smem_bytes<T>(p.bn);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<tgfr::gemm_tiles(p), tgfr::kGemmThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const tgfr::GemmArgs& p, int al, int bl,
                     cudaStream_t s) {
  using namespace tgfr;
  if (al == kARowMajor && bl == kBWeightNK)
    return run<T, kARowMajor, kBWeightNK>(p, s);
  if (al == kARowMajor && bl == kBWeightKN)
    return run<T, kARowMajor, kBWeightKN>(p, s);
  if (al == kARowMajor && bl == kBActNK)
    return run<T, kARowMajor, kBActNK>(p, s);
  if (al == kARowMajor && bl == kBActKN)
    return run<T, kARowMajor, kBActKN>(p, s);
  if (al == kATransposed && bl == kBActKN)
    return run<T, kATransposed, kBActKN>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// al, bl: common.cuh ALayout / BLayout; bn: the tile width (bf16: one of
// the widths wg_width, 0 for gemm_width's choice; f32: 64).
TGFR_API int tgfr_gemm(const void* a, const void* b, void* out, int m,
                         int n, int k, int al, int bl, int bn, int dtype,
                         void* stream) {
  tgfr::GemmArgs p = tgfr::gemm_args(a, b, out, m, n, k);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tgfr::kBF16) {
    if (bn != 0 && bn != tgfr::wg_width(0) && bn != tgfr::wg_width(1))
      return static_cast<int>(cudaErrorInvalidValue);
    p.bn = bn ? bn : tgfr::gemm_width<__nv_bfloat16>(m, n);
    return static_cast<int>(dispatch<__nv_bfloat16>(p, al, bl, s));
  }
  if (dtype == tgfr::kF32) {
    p.bn = tgfr::gemm_width<float>(m, n);
    return static_cast<int>(dispatch<float>(p, al, bl, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The half-layer route (common.cuh hl_gemm_kernel): out (m, n) f32 =
// A . W^T, A (m, k) bf16 row-major, W (n, k) f32 row-major; bn one of 128,
// 96, 48, or 0 for hl_width's choice.
TGFR_API int tgfr_hl_gemm(const void* a, const void* w, void* out, int m,
                            int n, int k, int bn, void* stream) {
  tgfr::GemmArgs p = tgfr::gemm_args(a, w, out, m, n, k);
  p.bn = bn ? bn : tgfr::hl_width(m, n);
  return static_cast<int>(tgfr::launch_hl_gemm<tgfr::kEpiF32>(
      p, static_cast<cudaStream_t>(stream)));
}

// The backward route (common.cuh hl_bwd_gemm_kernel): mode 1, out (m, n)
// f32 = A . W, A (m, k) bf16 row-major, W (k, n) f32 row-major, bn 48 or 0
// (kHlDgradWidth); mode 2, out (m, n) f32 = G^T . X, G (k, m) and X (k, n)
// bf16 row-major, and colsum (m) f32 = the column sums of G where given,
// bn 128, 64 or 0 (hl_wgrad_width).
TGFR_API int tgfr_hl_bwd_gemm(const void* a, const void* b, void* out,
                                void* colsum, int m, int n, int k, int mode,
                                int bn, void* stream) {
  tgfr::GemmArgs p = tgfr::gemm_args(a, b, out, m, n, k);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == tgfr::kHlDgrad) {
    p.bn = bn ? bn : tgfr::kHlDgradWidth;
    return static_cast<int>(
        tgfr::launch_hl_bwd_gemm<tgfr::kHlDgrad, tgfr::kEpiF32>(p, nullptr,
                                                                 s));
  }
  if (mode == tgfr::kHlWgrad) {
    p.bn = bn ? bn : tgfr::hl_wgrad_width(m, n);
    return static_cast<int>(
        tgfr::launch_hl_bwd_gemm<tgfr::kHlWgrad, tgfr::kEpiF32>(
            p, static_cast<float*>(colsum), s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
