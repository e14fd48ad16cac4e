// Post-LN self-attention half-layer, forward (K5 of the port) and backward
// (K6):
//   y = LN(x + drop(Wo . MHSA(x) + bo)),  probabilities dropped before P.V
//
// Replaces: text_guided_face_recognition_tpu/ops/block_pallas.py,
// `_attn_fwd_kernel` with its helper `_attn_heads_fwd`, reached through
// `_attn_fwd` (K5), and `_attn_bwd_kernel` with `_attn_heads_bwd`, reached
// through `_attn_bwd` (K6): the custom VJP of `attn_block`.
//
// Forward. Bound on the H100: operations. At R = 768 token rows (B = 32,
// T = 24), H = 768, 12 heads of 64: the QKV GEMM is 2.72 GFLOP, scores and
// P.V 0.057, the Wo GEMM 0.91, against ~12 MB moved.
// Design, in four launches (common.cuh has the notes):
//   (a) qkv = x . Wqkv + bqkv, q|k|v packed on the output axis, head-major
//       within each, into a (R, 3H) buffer: in bf16 the half-layer GEMM
//       route, in f32 the FMA tile;
//   (b) the attention per (caption, head): scores q.k^T / sqrt(64) plus the
//       additive key mask (finfo(float32).min on padded keys), an f32
//       softmax, probabilities rounded to the activation type (and saved,
//       before dropout, as p (heads*B, T, T) when the backward will need
//       them), dropped, then P.V, the context o rounded into a (R, H)
//       buffer. In bf16 without residuals (serving), and with them past
//       t = 128, on tensor cores (attention_mma_kernel: 4 warps a block,
//       2 pairs a block at T <= 32, a warp's 16 query rows against keys in
//       blocks of 64 from shared memory in two passes, the row maxima and
//       sums, then the probabilities (saved when the backward needs them)
//       and P.V), so T goes to 512; with residuals up to t = 128 one block
//       per (caption, head) with q, k, v and the scores in shared memory as
//       f32, the tile the whole-tower kernel K7 runs there, so that the
//       chain of half-layers the training checks hold against K7 adds the
//       same values (K7 with the tensor-core tile ran 18 % slower in all,
//       every phase of it, in development runs on the H100; past t = 128
//       K7 runs the tensor-core tile too); in f32 the strip tile
//       (attention_strip_kernel: one block per (caption, head), queries
//       and keys in strips of 64, f32 FMA), T up to 512 as well;
//   (c) r = x + drop(o . Wo + bo), dropout and the residual fused into the
//       GEMM epilogue.
// Dropout bits: host-drawn (bits_p, bits_h), or (prng mode) the stream of
// the layer seed the wrapper hands over as a device pointer, words
// [0, heads B T^2) for the probabilities and the next R H for the output
// (ops/philox.py), each element computing its own Philox block (4x the ALU
// work of a dump; no bits in device memory). The backward regenerates
// them from the same seed.
//   (d) y = LN(r), common.cuh's vector LayerNorm row kernel (K1's).
// The backward's residuals are x, qkv, p, o and r.
//
// Backward. Bound: bytes: 32 MB with the f32 weight gradients and the
// dropout bits (9.6 us at 3.35 TB/s) against 7.4 GFLOP (7.4 us at
// 989 TFLOP/s), at the shapes above, as chip_smoke.py counts them. Six
// launches, the GEMMs in bf16 on common.cuh's backward route (the core's
// layouts and order of sums), the weight gradients on a second stream
// beside the data path:
//   (1) the LN backward row pass from r (K2's kernel in common.cuh), then
//       the dropout: dr and dh = drop(dr), with dgamma, dbeta and dbo
//       summed over the rows in the same launch, in a fixed order;
//   (2) dWo = dh^T . o, f32 (second stream);  (3) do = r(dh . Wo);
//   (4) the per-head backward: dv = p_drop^T . do, dp = do . v^T with the
//       probability mask, ds = r(p (dp - sum(dp p)) / sqrt(64)),
//       dq = ds . k, dk = ds^T . q, each rounded into dqkv (R, 3H) at the
//       TPU kernel's rounding points: in bf16 on tensor cores
//       (attention_bwd_mma_kernel, keys and queries in blocks of 64, so T
//       goes to 512; the whole-tower kernel K8 runs the same tile), in f32
//       the strip tile (attention_strip_bwd_kernel: one block per (caption,
//       head), queries and keys in strips of 64, p read back from its
//       residual; K8 in f32 runs it too), T up to 512;
//   (5) dWqkv = dqkv^T . x, f32, with dbqkv = the column sums of dqkv in
//       the same launch (second stream);
//   (6) dx = r(dr + r(dqkv . Wqkv)).
// Weight gradients are f32, in nn.Linear's (out, in) layout.
#include "common.cuh"

namespace {

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int run_fwd(const void* x, const int* mask, const float* wqkv,
            const float* bqkv, const float* wo, const float* bo,
            const float* gamma, const float* beta, const tgfr::DropSrc& drop_p,
            const tgfr::DropSrc& drop_h, unsigned thr, float scale, void* qkv,
            void* p, void* ctx, void* resid, void* y, int b, int t, int h,
            int heads, float eps, cudaStream_t s) {
  constexpr bool kRoute = std::is_same<T, __nv_bfloat16>::value;
  const int rows = b * t;
  const float inv = 1.0f / sqrtf(static_cast<float>(tgfr::kDHead));
  if (t > tgfr::kAttnMaxT) return static_cast<int>(cudaErrorInvalidValue);
  tgfr::GemmArgs proj = tgfr::gemm_args(x, wqkv, qkv, rows, 3 * h, h);
  proj.bias = bqkv;
  cudaError_t err = tgfr::launch_forward_gemm<T, tgfr::kEpiBias>(proj, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // bf16: the scalar tile with residuals up to t = 128 (training, which
  // the whole-tower kernel's chain must equal); the tensor-core tile
  // without them (serving) and with them past 128. f32: the strip tile.
  if constexpr (kRoute) {
    if (p && t <= tgfr::kAttnScalarT) {
      const size_t smem = tgfr::attn_fwd_smem_bytes(t);
      err = set_smem(tgfr::attention_core_kernel<T>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      tgfr::attention_core_kernel<T>
          <<<dim3(b, heads), tgfr::kAttnThreads, smem, s>>>(
          static_cast<const T*>(qkv), mask, drop_p, thr, scale,
          static_cast<T*>(p), static_cast<T*>(ctx), b, t, h, inv);
    } else {
      const int pairs = tgfr::attn_pairs_per_block(t);
      const size_t smem = tgfr::attn_mma_smem_bytes(t, pairs);
      const auto kernel = p ? tgfr::attention_mma_kernel<true>
                            : tgfr::attention_mma_kernel<false>;
      err = set_smem(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<(b * heads + pairs - 1) / pairs, tgfr::kAttnThreads, smem,
               s>>>(static_cast<const T*>(qkv), mask, drop_p, thr, scale,
                    static_cast<T*>(p), static_cast<T*>(ctx), b, t, h, inv,
                    pairs);
    }
  } else {
    const size_t smem = tgfr::attn_strip_fwd_smem_bytes();
    err = set_smem(tgfr::attention_strip_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tgfr::attention_strip_kernel<<<dim3(b, heads), tgfr::kAttnThreads, smem,
                                   s>>>(
        static_cast<const float*>(qkv), mask, drop_p, thr, scale,
        static_cast<float*>(p), static_cast<float*>(ctx), b, t, h, inv);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  tgfr::GemmArgs out = tgfr::gemm_args(ctx, wo, resid, rows, h, h);
  out.bias = bo;
  out.resid = x;
  out.drop = drop_h;
  out.thr = thr;
  out.scale = scale;
  err = tgfr::launch_forward_gemm<T, tgfr::kEpiBiasResidual>(out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tgfr::launch_layernorm_rows<T, true>(static_cast<const T*>(resid),
                                             gamma, beta, static_cast<T*>(y),
                                             rows, h, eps, s);
  return static_cast<int>(err);
}

// The per-head backward: bf16 on tensor cores (attention_bwd_mma_kernel),
// f32 the strip tile, t up to 512 either way.
template <typename T>
cudaError_t launch_attention_bwd(const T* qkv, const T* p, const T* dout,
                                 const tgfr::DropSrc& drop_p, unsigned thr,
                                 float scale, T* dqkv, int b, int t, int h,
                                 cudaStream_t s) {
  const float inv = 1.0f / sqrtf(static_cast<float>(tgfr::kDHead));
  const int heads = h / tgfr::kDHead;
  if (t > tgfr::kAttnMaxT) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int pairs = tgfr::attn_bwd_pairs_per_block(t);
    const size_t smem = tgfr::attn_bwd_mma_smem_bytes(t, pairs);
    err = set_smem(tgfr::attention_bwd_mma_kernel, smem);
    if (err != cudaSuccess) return err;
    tgfr::attention_bwd_mma_kernel<<<(b * heads + pairs - 1) / pairs,
                                     tgfr::kAttnThreads, smem, s>>>(
        qkv, p, dout, drop_p, thr, scale, dqkv, b, t, h, inv, pairs);
  } else {
    const size_t smem = tgfr::attn_strip_bwd_smem_bytes(t);
    err = set_smem(tgfr::attention_strip_bwd_kernel, smem);
    if (err != cudaSuccess) return err;
    tgfr::attention_strip_bwd_kernel<<<dim3(b, heads), tgfr::kAttnThreads,
                                       smem, s>>>(
        qkv, p, dout, drop_p, thr, scale, dqkv, b, t, h, inv);
  }
  return cudaGetLastError();
}

template <typename T>
int run_bwd(const void* dy, const void* x, const void* qkv, const void* p,
            const void* o, const void* r, const float* wqkv, const float* wo,
            const float* gamma, const tgfr::DropSrc& drop_p,
            const tgfr::DropSrc& drop_h, unsigned thr, float scale, void* dx,
            float* dwqkv, float* dbqkv, float* dwo, float* dln, void* dr,
            void* dh, void* dout, void* dqkv, float* part, unsigned* counter,
            int b, int t, int h, int heads, float eps, cudaStream_t s) {
  const int rows = b * t;
  // (1) dr, dh = drop(dr); dln = [dgamma | dbeta | dbo]
  T* dh_t = static_cast<T*>(drop_h.on() ? dh : dr);
  cudaError_t err = tgfr::launch_layernorm_bwd<T, true, 3>(
      static_cast<const T*>(dy), static_cast<const T*>(r), gamma,
      static_cast<T*>(dr), drop_h.on() ? dh_t : nullptr, drop_h, thr, scale,
      part, dln, counter, rows, h, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the weight gradients on the side stream, beside the data gradients
  tgfr::SideStream* side = nullptr;
  err = tgfr::side_stream(&side);
  if (err == cudaSuccess) err = tgfr::side_fork(side, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (2) dWo (h, h) = dh^T . o
  err = tgfr::launch_weight_grad<T>(dh_t, o, dwo, nullptr, h, h, rows,
                                    side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (3) do = r(dh . Wo); Wo is (h, h) = (K, N)
  err = tgfr::launch_data_grad<T, tgfr::kEpiBias>(
      tgfr::gemm_args(dh_t, wo, dout, rows, h, h), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (4) the per-head backward into dqkv
  err = launch_attention_bwd<T>(static_cast<const T*>(qkv),
                                static_cast<const T*>(p),
                                static_cast<const T*>(dout), drop_p, thr,
                                scale, static_cast<T*>(dqkv), b, t, h, s);
  if (err == cudaSuccess) err = tgfr::side_fork(side, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (5) dWqkv (3h, h) = dqkv^T . x, and dbqkv, the column sums of dqkv
  err = tgfr::launch_weight_grad<T>(dqkv, x, dwqkv, dbqkv, 3 * h, h, rows,
                                    side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (6) dx = r(dr + r(dqkv . Wqkv)); Wqkv is (3h, h) = (K, N)
  tgfr::GemmArgs dxa = tgfr::gemm_args(dqkv, wqkv, dx, rows, h, 3 * h);
  dxa.resid = dr;
  err = tgfr::launch_data_grad<T, tgfr::kEpiBiasResidual>(dxa, s);
  if (err == cudaSuccess) err = tgfr::side_join(side, s);
  return static_cast<int>(err);
}

}  // namespace

// Dropout: bits_p (heads*b, t, t) and bits_h (b*t, h) uint32, or seed (1,)
// int32 on the device (the layer's stream), or none of them (no dropout);
// p: (heads*b, t, t) or null (not saved).
TGFR_API int tgfr_attn_block_fwd(const void* x, const void* mask,
                                   const void* wqkv, const void* bqkv,
                                   const void* wo, const void* bo,
                                   const void* gamma, const void* beta,
                                   const void* bits_p, const void* bits_h,
                                   const void* seed, unsigned thr,
                                   float scale, void* qkv,
                                   void* p, void* ctx, void* resid, void* y,
                                   int b, int t, int h, int heads, float eps,
                                   int dtype, void* stream) {
  if (h != heads * tgfr::kDHead)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(mask);
  const auto* fwqkv = static_cast<const float*>(wqkv);
  const auto* fbqkv = static_cast<const float*>(bqkv);
  const auto* fwo = static_cast<const float*>(wo);
  const auto* fbo = static_cast<const float*>(bo);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const tgfr::DropSrc up = tgfr::drop_src(bits_p, seed);
  const tgfr::DropSrc uh = tgfr::drop_src(
      bits_h, seed, 0, static_cast<unsigned long long>(heads) * b * t * t);
  if (dtype == tgfr::kBF16)
    return run_fwd<__nv_bfloat16>(x, m, fwqkv, fbqkv, fwo, fbo, g, bt, up, uh,
                                  thr, scale, qkv, p, ctx, resid, y, b, t, h,
                                  heads, eps, s);
  if (dtype == tgfr::kF32)
    return run_fwd<float>(x, m, fwqkv, fbqkv, fwo, fbo, g, bt, up, uh, thr,
                          scale, qkv, p, ctx, resid, y, b, t, h, heads, eps,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// wqkv: (3h, h), wo: (h, h), nn.Linear layout. Outputs dx (b*t, h); dwqkv
// (3h, h), dbqkv (3h), dwo (h, h), dln (3 h) = [dgamma | dbeta | dbo], all
// f32. Dropout as the forward's. Scratch: dr, dh (b*t, h; dh only with
// dropout), dout (b*t, h), dqkv (b*t, 3h), part (tgfr_ln_bwd_parts(b*t),
// 3 * 1024) f32; counter: the stream's LN arrival counters (layernorm.cu).
TGFR_API int tgfr_attn_block_bwd(const void* dy, const void* x,
                                   const void* qkv, const void* p,
                                   const void* o, const void* r,
                                   const void* wqkv, const void* wo,
                                   const void* gamma, const void* bits_p,
                                   const void* bits_h, const void* seed,
                                   unsigned thr, float scale, void* dx,
                                   void* dwqkv,
                                   void* dbqkv, void* dwo, void* dln,
                                   void* dr, void* dh, void* dout, void* dqkv,
                                   void* part, void* counter, int b, int t,
                                   int h, int heads, float eps, int dtype,
                                   void* stream) {
  if (h != heads * tgfr::kDHead)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fwqkv = static_cast<const float*>(wqkv);
  const auto* fwo = static_cast<const float*>(wo);
  const auto* g = static_cast<const float*>(gamma);
  const tgfr::DropSrc up = tgfr::drop_src(bits_p, seed);
  const tgfr::DropSrc uh = tgfr::drop_src(
      bits_h, seed, 0, static_cast<unsigned long long>(heads) * b * t * t);
  auto* o1 = static_cast<float*>(dwqkv);
  auto* ob = static_cast<float*>(dbqkv);
  auto* o2 = static_cast<float*>(dwo);
  auto* oln = static_cast<float*>(dln);
  auto* pt = static_cast<float*>(part);
  auto* ctr = static_cast<unsigned*>(counter);
  if (dtype == tgfr::kBF16)
    return run_bwd<__nv_bfloat16>(dy, x, qkv, p, o, r, fwqkv, fwo, g, up, uh,
                                  thr, scale, dx, o1, ob, o2, oln, dr, dh,
                                  dout, dqkv, pt, ctr, b, t, h, heads, eps, s);
  if (dtype == tgfr::kF32)
    return run_bwd<float>(dy, x, qkv, p, o, r, fwqkv, fwo, g, up, uh, thr,
                          scale, dx, o1, ob, o2, oln, dr, dh, dout, dqkv, pt,
                          ctr, b, t, h, heads, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
