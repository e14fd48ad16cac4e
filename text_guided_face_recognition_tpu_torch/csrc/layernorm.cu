// LayerNorm forward over the last axis (K1 of the port).
//
// Replaces: text_guided_face_recognition_tpu/ops/layernorm_pallas.py,
// `_fwd_kernel` reached through `_fwd_call` / `layernorm_fused` (row blocks
// of up to 256 tokens per grid step on the TPU).
//
// Bound on the H100: memory. The work is ~8 flops per element against 4
// bytes moved per bf16 element (read x, write y), far below the ~295
// flops/byte at which the tensor cores, not HBM, become the limit.
// Design: one warp per row, 8 rows per 256-thread block; the row is read
// once into registers (h <= 1024, 32 values a lane), statistics in f32 with
// warp-shuffle reductions (mean, then the centred variance). x is read from
// device memory once and y written once.
#include "common.cuh"

extern "C" int tgfr_layernorm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int rows, int h,
                                  float eps, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  cudaError_t err;
  if (dtype == tgfr::kBF16) {
    err = tgfr::launch_layernorm_rows<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(y), rows, h, eps, s);
  } else if (dtype == tgfr::kF32) {
    err = tgfr::launch_layernorm_rows<float, false>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), rows, h,
        eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
