// Post-LN FFN half-layer, forward (K3 of the port) and backward (K4):
//   z = LN(x + drop(W2 . gelu(W1 . x + c1) + c2))
//
// Replaces: text_guided_face_recognition_tpu/ops/block_pallas.py,
// `_ffn_fwd_kernel` reached through `_ffn_fwd` (K3) and `_ffn_bwd_kernel`
// reached through `_ffn_bwd` (K4), the custom VJP of `ffn_block`.
//
// Forward. Bound on the H100: operations. At R = 768 token rows, H = 768,
// I = 3072 the two GEMMs are 7.25 GFLOP against ~21 MB of f32 master
// weights and activations, so the tensor cores are the limit.
// Design: the TPU kernel carries an f32 accumulator across a sequential grid
// over I; CUDA blocks run in parallel and in no order. In bf16, three
// launches, the two GEMMs on common.cuh's half-layer GEMM route
// (warp-specialised 128-row tiles, a producer warpgroup that rounds the f32
// masters into the stages, mbarrier hand-over; see the note there):
//   (a) f = x . W1 + c1 and act = gelu(f), both rounded to the activation
//       type, into (R, I) buffers (4.7 MB each in bf16, L2-resident); f is
//       written only when the backward will need it;
//   (b) r = x + drop(act . W2 + c2), the whole sum over I in each tile, in
//       the order of the whole-tower kernel's W2 phase, so the chain of
//       half-layers equals K7 (I split into ranges added by the last block
//       to arrive would need K7 to split alike, and its W2 phase ran slower
//       split: measured on the H100, PERF.md), with dropout and the
//       residual fused into the epilogue; the bits are host-drawn, or (prng
//       mode) words [0, R H) of the stream of the seed the wrapper hands
//       over, already the layer seed ^ 0x5BD1E995 (ops/philox.py), and no
//       bits in device memory;
//   (c) z = LN(r), common.cuh's vector LayerNorm row kernel (K1's): a
//       128 x BN tile holds no whole row to normalise.
// f32 runs the FMA tile (common.cuh) in (a) and (b).
// The backward's residuals are x, f, act and r.
//
// Backward. Bound: bytes, narrowly: 49.6 MB with the f32 weight gradients
// and the dropout bits (14.8 us at 3.35 TB/s) against the four GEMMs'
// 14.5 GFLOP (14.7 us at 989 TFLOP/s), at the shapes above, as
// chip_smoke.py counts them. The TPU kernel streams over I with an f32 dx
// accumulator; here it becomes five launches, the GEMMs in bf16 on
// common.cuh's backward route (warp-specialised 128-row tiles, TMA, the
// core's layouts and order of sums), the weight gradients on a second
// stream beside the data gradients:
//   (1) the LN backward row pass from r (statistics recomputed; K2's
//       kernel in common.cuh), then the dropout (the forward's bits, or its
//       stream regenerated from the same seed): dr and dgg = drop(dr),
//       rounded; dgamma, dbeta and dc2 summed over the rows in the same
//       launch, in a fixed order;
//   (2) dW2 = dgg^T . act, f32 (second stream);
//   (3) df = r(r(dgg . W2) * gelu'(f)), the GELU derivative in the epilogue;
//   (4) dW1 = df^T . x, f32, with dc1 = the column sums of df in the same
//       launch (second stream);
//   (5) dx = r(dr + r(df . W1)).
// dW1 and dW2 are written in nn.Linear's (out, in) layout; the weight
// gradients are never rounded to bf16 (the TPU kernel's outputs are in the
// master dtype). f32 runs the FMA tile and a column-sum launch for dc1.
#include "common.cuh"

namespace {

template <typename T>
int run_fwd(const void* x, const float* w1, const float* c1, const float* w2,
            const float* c2, const float* gamma, const float* beta,
            const tgfr::DropSrc& drop, unsigned thr, float scale, void* act,
            void* f, void* resid, void* z, int rows, int h, int inter,
            float eps, cudaStream_t s) {
  tgfr::GemmArgs up = tgfr::gemm_args(x, w1, act, rows, inter, h);
  up.bias = c1;
  up.out2 = f;
  cudaError_t err = tgfr::launch_forward_gemm<T, tgfr::kEpiBiasGelu>(up, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tgfr::GemmArgs down = tgfr::gemm_args(act, w2, resid, rows, h, inter);
  down.bias = c2;
  down.resid = x;
  down.drop = drop;
  down.thr = thr;
  down.scale = scale;
  err = tgfr::launch_forward_gemm<T, tgfr::kEpiBiasResidual>(down, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tgfr::launch_layernorm_rows<T, true>(static_cast<const T*>(resid),
                                             gamma, beta, static_cast<T*>(z),
                                             rows, h, eps, s);
  return static_cast<int>(err);
}

template <typename T>
int run_bwd(const void* dz, const void* x, const void* f, const void* act,
            const void* r, const float* w1, const float* w2,
            const float* gamma, const tgfr::DropSrc& drop, unsigned thr,
            float scale, void* dx, float* dw1, float* dc1, float* dw2,
            float* dln, void* dr, void* dgg, void* df, float* part,
            unsigned* counter, int rows, int h, int inter, float eps,
            cudaStream_t s) {
  // (1) dr, dgg = drop(dr); dln = [dgamma | dbeta | dc2]
  T* dgg_t = static_cast<T*>(drop.on() ? dgg : dr);
  cudaError_t err = tgfr::launch_layernorm_bwd<T, true, 3>(
      static_cast<const T*>(dz), static_cast<const T*>(r), gamma,
      static_cast<T*>(dr), drop.on() ? dgg_t : nullptr, drop, thr, scale,
      part, dln, counter, rows, h, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the weight gradients on the side stream, beside the data gradients
  tgfr::SideStream* side = nullptr;
  err = tgfr::side_stream(&side);
  if (err == cudaSuccess) err = tgfr::side_fork(side, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (2) dW2 (h, inter) = dgg^T . act
  err = tgfr::launch_weight_grad<T>(dgg_t, act, dw2, nullptr, h, inter, rows,
                                    side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (3) df = r(r(dgg . W2) * gelu'(f)); W2 is (h, inter) = (K, N)
  tgfr::GemmArgs da = tgfr::gemm_args(dgg_t, w2, df, rows, inter, h);
  da.aux = f;
  err = tgfr::launch_data_grad<T, tgfr::kEpiDgelu>(da, s);
  if (err == cudaSuccess) err = tgfr::side_fork(side, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (4) dW1 (inter, h) = df^T . x, and dc1, the column sums of df
  err = tgfr::launch_weight_grad<T>(df, x, dw1, dc1, inter, h, rows,
                                    side->stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // (5) dx = r(dr + r(df . W1)); W1 is (inter, h) = (K, N)
  tgfr::GemmArgs dxa = tgfr::gemm_args(df, w1, dx, rows, h, inter);
  dxa.resid = dr;
  err = tgfr::launch_data_grad<T, tgfr::kEpiBiasResidual>(dxa, s);
  if (err == cudaSuccess) err = tgfr::side_join(side, s);
  return static_cast<int>(err);
}

}  // namespace

// Dropout: bits (rows, h) uint32, or seed (1,) int32 on the device (the
// FFN stream's seed), or neither (no dropout); f: (rows, inter) or null.
TGFR_API int tgfr_ffn_block_fwd(const void* x, const void* w1,
                                  const void* c1, const void* w2,
                                  const void* c2, const void* gamma,
                                  const void* beta, const void* bits,
                                  const void* seed, unsigned thr,
                                  float scale, void* act,
                                  void* f, void* resid, void* z, int rows,
                                  int h, int inter, float eps, int dtype,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fc1 = static_cast<const float*>(c1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fc2 = static_cast<const float*>(c2);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const tgfr::DropSrc u = tgfr::drop_src(bits, seed);
  if (dtype == tgfr::kBF16)
    return run_fwd<__nv_bfloat16>(x, fw1, fc1, fw2, fc2, g, b, u, thr, scale,
                                  act, f, resid, z, rows, h, inter, eps, s);
  if (dtype == tgfr::kF32)
    return run_fwd<float>(x, fw1, fc1, fw2, fc2, g, b, u, thr, scale, act, f,
                          resid, z, rows, h, inter, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// w1: (inter, h), w2: (h, inter), nn.Linear layout. Outputs dx (rows, h);
// dw1 (inter, h), dc1 (inter), dw2 (h, inter), dln (3 h) = [dgamma | dbeta
// | dc2], all f32. Dropout as the forward's. Scratch: dr, dgg (rows, h;
// dgg only with dropout), df (rows, inter), part (tgfr_ln_bwd_parts(rows),
// 3 * 1024) f32; counter: the stream's LN arrival counters (layernorm.cu).
TGFR_API int tgfr_ffn_block_bwd(const void* dz, const void* x,
                                  const void* f, const void* act,
                                  const void* r, const void* w1,
                                  const void* w2, const void* gamma,
                                  const void* bits, const void* seed,
                                  unsigned thr, float scale, void* dx,
                                  void* dw1, void* dc1, void* dw2, void* dln,
                                  void* dr, void* dgg, void* df, void* part,
                                  void* counter, int rows, int h, int inter,
                                  float eps, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* g = static_cast<const float*>(gamma);
  const tgfr::DropSrc u = tgfr::drop_src(bits, seed);
  auto* o1 = static_cast<float*>(dw1);
  auto* oc1 = static_cast<float*>(dc1);
  auto* o2 = static_cast<float*>(dw2);
  auto* oln = static_cast<float*>(dln);
  auto* pt = static_cast<float*>(part);
  auto* ctr = static_cast<unsigned*>(counter);
  if (dtype == tgfr::kBF16)
    return run_bwd<__nv_bfloat16>(dz, x, f, act, r, fw1, fw2, g, u, thr,
                                  scale, dx, o1, oc1, o2, oln, dr, dgg, df,
                                  pt, ctr, rows, h, inter, eps, s);
  if (dtype == tgfr::kF32)
    return run_bwd<float>(dz, x, f, act, r, fw1, fw2, g, u, thr, scale, dx,
                          o1, oc1, o2, oln, dr, dgg, df, pt, ctr, rows, h,
                          inter, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
