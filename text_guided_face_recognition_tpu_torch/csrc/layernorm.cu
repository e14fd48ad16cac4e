// LayerNorm over the last axis: forward (K1 of the port) and backward (K2).
//
// Replaces: text_guided_face_recognition_tpu/ops/layernorm_pallas.py,
// `_fwd_kernel` reached through `_fwd_call` (K1) and `_bwd_kernel` reached
// through `_bwd_call` (K2), the custom VJP of `layernorm_fused` (row blocks
// of up to 256 tokens per grid step on the TPU).
//
// Bound on the H100: bytes. The forward does ~8 flops per element against
// 4 bytes moved in bf16 (read x, write y), the backward ~12 against 6 (read
// x and dy, write dx), far below the ~295 flops a byte at which the tensor
// cores, not HBM, become the limit. At R = H = 768 in bf16 the bytes take
// 0.71 us and 1.06 us at 3.35 TB/s, less than a launch: a call costs the
// launch and one warp's chain of latencies over its row.
//
// Design (csrc/common.cuh, "LayerNorm row kernels for Hopper", shared with the
// LN phases of K3-K6): a lane loads, computes and stores whole 16-byte vectors
// of its row, all loads issued before anything waits on them; gamma and beta
// are float4 loads kept in registers; the row sums read the whole-tower
// kernels' LN tiles' layout back from a copy of the row in shared memory and
// add in their order, with their expressions (the earlier K1's and K2's
// arithmetic); one row a warp (K1: two-warp blocks, 384 at R = 768 and 192
// at R = 384 on 132 SMs). K2 is one launch: dx and its column sums dgamma,
// dbeta, which it adds over a block's 8 rows in shared memory, over each of 8
// groups of blocks (by block index mod 8) in the block that takes the group's
// last ticket of an integer arrival counter, and over the groups in the block
// that takes the last group ticket: the earlier kernels' order, deterministic,
// no float atomics, no memset, no second launch. H not a multiple of the
// vector (8 bf16, 4 f32), or a pointer not 16-byte aligned: the same kernels
// element by element.
//
// Times, bf16 at R = H = 768, device time per call from a CUDA graph of 20
// calls, warm / cold L2 (chip_smoke.py; NVIDIA H100 80GB HBM3 at 700 W).
// The earlier warp-per-row scalar design: K1 7.059 / 11.16 us, K2 12.04 /
// 14.74 us in three device operations (the timed call also cast dy),
// against F.layer_norm 4.384 and aten native_layer_norm_backward 7.496 us
// warm in the same run. This design: K1 3.0 / 4.0 us, K2 7.9 / 8.9 us,
// against 4.2 and 7.4 us warm in the same run (PERF.md has the runs).
#include "common.cuh"

// Rows of the `part` scratch that tgfr_layernorm_bwd and the half-layer
// backwards take for `rows` token rows (ops/layernorm.py mirrors it).
TGFR_API int tgfr_ln_bwd_parts(int rows) {
  return tgfr::ln_bwd_parts(rows);
}

TGFR_API int tgfr_layernorm_fwd(const void* x, const void* gamma,
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

// dgb: (2 h) f32 = [dgamma | dbeta], every element written; part:
// (tgfr_ln_bwd_parts(rows), 2 * 1024) f32 scratch; counter: the stream's
// LN arrival counters (16 uint32, 0 between calls).
TGFR_API int tgfr_layernorm_bwd(const void* dy, const void* x,
                                  const void* gamma, void* dx, void* dgb,
                                  void* part, void* counter, int rows, int h,
                                  float eps, int dtype, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  auto* sums = static_cast<float*>(dgb);
  auto* pt = static_cast<float*>(part);
  auto* ctr = static_cast<unsigned*>(counter);
  cudaError_t err;
  if (dtype == tgfr::kBF16) {
    using T = __nv_bfloat16;
    err = tgfr::launch_layernorm_bwd<T, false, 2>(
        static_cast<const T*>(dy), static_cast<const T*>(x), g,
        static_cast<T*>(dx), nullptr, tgfr::DropSrc{}, 0u, 1.f, pt, sums,
        ctr, rows, h, eps, s);
  } else if (dtype == tgfr::kF32) {
    err = tgfr::launch_layernorm_bwd<float, false, 2>(
        static_cast<const float*>(dy), static_cast<const float*>(x), g,
        static_cast<float*>(dx), nullptr, tgfr::DropSrc{}, 0u, 1.f, pt, sums,
        ctr, rows, h, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
