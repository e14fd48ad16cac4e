// Post-LN FFN half-layer forward (K3 of the port):
//   z = LN(x + (W2 . gelu(W1 . x + c1) + c2))          (serving: no dropout)
//
// Replaces: text_guided_face_recognition_tpu/ops/block_pallas.py,
// `_ffn_fwd_kernel` reached through `_ffn_fwd` / `ffn_block`.
//
// Bound on the H100: operations. At R = 768 token rows, H = 768, I = 3072
// the two GEMMs are 7.25 GFLOP against ~21 MB of f32 master weights and
// activations, so the tensor cores are the limit.
// Design: the TPU kernel carries an f32 accumulator across a sequential grid
// over I; CUDA blocks run in parallel and in no order, so the sum over I
// becomes the K loop of the second GEMM instead, in three launches:
//   (a) act = gelu(x . W1 + c1), rounded to the activation type, into a
//       (R, I) scratch buffer (4.7 MB in bf16, L2-resident on the card);
//   (b) r = x + (act . W2 + c2), the residual fused into the GEMM epilogue;
//   (c) z = LN(r), one warp per row.
// The serving forward writes none of the residuals the backward needs.
#include "common.cuh"

namespace {

template <typename T>
int run(const void* x, const float* w1, const float* c1, const float* w2,
        const float* c2, const float* gamma,
        const float* beta, void* act, void* resid, void* z, int rows, int h,
        int inter, float eps, cudaStream_t s) {
  tgfr::GemmArgs up{x, w1, c1, nullptr, act, rows, inter, h};
  cudaError_t err = tgfr::launch_gemm<T, tgfr::kEpiBiasGelu>(up, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tgfr::GemmArgs down{act, w2, c2, x, resid, rows, h, inter};
  err = tgfr::launch_gemm<T, tgfr::kEpiBiasResidual>(down, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tgfr::launch_layernorm_rows<T, true>(static_cast<const T*>(resid),
                                             gamma, beta, static_cast<T*>(z),
                                             rows, h, eps, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int tgfr_ffn_block_fwd(const void* x, const void* w1,
                                  const void* c1, const void* w2,
                                  const void* c2, const void* gamma,
                                  const void* beta, void* act, void* resid,
                                  void* z, int rows, int h, int inter,
                                  float eps, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fc1 = static_cast<const float*>(c1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fc2 = static_cast<const float*>(c2);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  if (dtype == tgfr::kBF16)
    return run<__nv_bfloat16>(x, fw1, fc1, fw2, fc2, g, b, act, resid, z,
                              rows, h, inter, eps, s);
  if (dtype == tgfr::kF32)
    return run<float>(x, fw1, fc1, fw2, fc2, g, b, act, resid, z, rows, h,
                      inter, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
