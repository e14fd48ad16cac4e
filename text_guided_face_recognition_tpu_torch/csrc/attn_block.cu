// Post-LN self-attention half-layer forward (K5 of the port):
//   y = LN(x + (Wo . MHSA(x) + bo))                     (serving: no dropout)
//
// Replaces: text_guided_face_recognition_tpu/ops/block_pallas.py,
// `_attn_fwd_kernel` with its helper `_attn_heads_fwd`, reached through
// `_attn_fwd` / `attn_block`.
//
// Bound on the H100: operations. At R = 768 token rows (B = 32, T = 24),
// H = 768, 12 heads of 64: the QKV GEMM is 2.72 GFLOP, scores and P.V 0.057,
// the Wo GEMM 0.91, against ~12 MB moved.
// Design, in four launches:
//   (a) qkv = x . Wqkv + bqkv, q|k|v packed on the output axis, head-major
//       within each, into a (R, 3H) scratch buffer;
//   (b) one block per (batch row, head): q, k, v of that head staged in
//       shared memory as f32, scores q.k^T / sqrt(64) plus the additive key
//       mask (finfo(float32).min on padded keys), an f32 softmax with one
//       warp per query row, probabilities rounded to the activation type
//       before P.V, the context rounded into a (R, H) buffer. At T = 24 the
//       whole head fits one block;
//   (c) r = x + (ctx . Wo + bo), the residual fused into the GEMM epilogue;
//   (d) y = LN(r), one warp per row.
// The serving forward writes none of the residuals the backward needs.
#include "common.cuh"

namespace {

constexpr int kDHead = 64;
constexpr int kQkvLd = kDHead + 1;  // pad: score loop walks k rows
constexpr int kAttnThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_core_kernel(const T* __restrict__ qkv, const int* __restrict__ mask,
                      T* __restrict__ ctx, int t, int h, float inv) {
  extern __shared__ float sm[];
  float* q = sm;
  float* k = q + t * kQkvLd;
  float* v = k + t * kQkvLd;
  float* s = v + t * kQkvLd;  // (t, t)
  const int b = blockIdx.x, head = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * t;

  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    const T* src = qkv + (row0 + r) * 3 * h + head * kDHead + d;
    q[r * kQkvLd + d] = tgfr::to_f32(src[0]);
    k[r * kQkvLd + d] = tgfr::to_f32(src[h]);
    v[r * kQkvLd + d] = tgfr::to_f32(src[2 * h]);
  }
  __syncthreads();

  for (int i = tid; i < t * t; i += kAttnThreads) {
    const int qi = i / t, kj = i % t;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kDHead; ++d)
      acc = fmaf(q[qi * kQkvLd + d], k[kj * kQkvLd + d], acc);
    s[i] = acc * inv + (mask[row0 + kj] != 0 ? 0.f : -FLT_MAX);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < t; r += kAttnThreads / 32) {
    float* sr = s + r * t;
    float mx = -FLT_MAX;
    for (int j = lane; j < t; j += 32) mx = fmaxf(mx, sr[j]);
    mx = tgfr::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    sum = tgfr::warp_sum(sum);
    for (int j = lane; j < t; j += 32) sr[j] = tgfr::round_to<T>(sr[j] / sum);
  }
  __syncthreads();

  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc = fmaf(s[r * t + j], v[j * kQkvLd + d], acc);
    ctx[(row0 + r) * h + head * kDHead + d] = tgfr::from_f32<T>(acc);
  }
}

template <typename T>
int run(const void* x, const int* mask, const float* wqkv, const float* bqkv,
        const float* wo, const float* bo,
        const float* gamma, const float* beta, void* qkv, void* ctx,
        void* resid, void* y, int b, int t, int h, int heads, float eps,
        cudaStream_t s) {
  const int rows = b * t;
  tgfr::GemmArgs proj{x, wqkv, bqkv, nullptr, qkv, rows, 3 * h, h};
  cudaError_t err = tgfr::launch_gemm<T, tgfr::kEpiBias>(proj, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = (size_t)(3 * t * kQkvLd + t * t) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_core_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_core_kernel<T><<<dim3(b, heads), kAttnThreads, smem, s>>>(
      static_cast<const T*>(qkv), mask, static_cast<T*>(ctx), t, h,
      1.0f / sqrtf(static_cast<float>(kDHead)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  tgfr::GemmArgs out{ctx, wo, bo, x, resid, rows, h, h};
  err = tgfr::launch_gemm<T, tgfr::kEpiBiasResidual>(out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tgfr::launch_layernorm_rows<T, true>(static_cast<const T*>(resid),
                                             gamma, beta, static_cast<T*>(y),
                                             rows, h, eps, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int tgfr_attn_block_fwd(const void* x, const void* mask,
                                   const void* wqkv, const void* bqkv,
                                   const void* wo, const void* bo,
                                   const void* gamma,
                                   const void* beta, void* qkv, void* ctx,
                                   void* resid, void* y, int b, int t, int h,
                                   int heads, float eps, int dtype,
                                   void* stream) {
  if (h != heads * kDHead) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(mask);
  const auto* fwqkv = static_cast<const float*>(wqkv);
  const auto* fbqkv = static_cast<const float*>(bqkv);
  const auto* fwo = static_cast<const float*>(wo);
  const auto* fbo = static_cast<const float*>(bo);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  if (dtype == tgfr::kBF16)
    return run<__nv_bfloat16>(x, m, fwqkv, fbqkv, fwo, fbo, g, bt, qkv, ctx,
                              resid, y, b, t, h, heads, eps, s);
  if (dtype == tgfr::kF32)
    return run<float>(x, m, fwqkv, fbqkv, fwo, fbo, g, bt, qkv, ctx, resid, y,
                      b, t, h, heads, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
