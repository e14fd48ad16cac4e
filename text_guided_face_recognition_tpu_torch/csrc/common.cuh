// Device code shared by the port's hand-written Hopper kernels.
//
// Element helpers for the two supported activation types (float and
// __nv_bfloat16), a tiled GEMM with fused epilogues, the LayerNorm row
// passes (the whole-tower kernels' tiles, and the vector row kernels of
// K1-K6, whose backward adds its column sums in the same launch), a
// deterministic column sum, and the per-(caption, head) attention blocks.
// Each kernel source (layernorm.cu, ffn_block.cu, attn_block.cu,
// tower_block.cu, damsm.cu, philox.cu) includes this header and is built on
// its own into a shared library with a plain C interface (ops/_cuda.py).
//
// The work of every pass is a `__device__` function of a tile index
// (`*_tile`), so that one pass can be a kernel of its own (the `__global__`
// kernels below, one tile per block: K3-K6) or a phase of the persistent
// whole-tower kernels (tower_block.cu: K7, K8), whose blocks loop over the
// tiles of a phase between grid-wide barriers. A tile function uses the
// shared memory it is handed and ends without a barrier: a block that runs
// several tiles puts __syncthreads() between them.
//
// Rounding contract (the one the JAX package's Pallas kernels and flax's
// nn.Dense(dtype=...) follow): a GEMM accumulates in f32, its result is
// rounded to the activation type, and only then is the bias (itself
// rounded from the f32 master) added, with the sum rounded again.
//
// Dropout (block_pallas.py `_drop`, models/text_bert.py `_DropPlan`): keep
// iff the uint32 bit >= thr, thr = min(round(rate 2^32), 2^32 - 1); a kept
// value v becomes r(v * r(scale)), scale = 1 / (1 - rate), a dropped one 0.
// A site's bits come from a `DropSrc`: host-drawn bits in device memory, or
// the in-kernel Philox stream of a seed read through a device pointer (the
// stream contract is written out in ops/philox.py).
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace tgfr {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision, returned as f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Dropout of a value held in T: r(v * r(scale)) where kept, else 0.
template <typename T>
__device__ __forceinline__ float drop_to(float v, unsigned bit, unsigned thr,
                                         float scale) {
  return bit >= thr ? round_to<T>(v * round_to<T>(scale)) : 0.f;
}

// Philox4x32-10 (Random123's philox4x32, 10 rounds) of counter c, key
// (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Word i of the stream `key`: word i & 3 of the block of counter
// (lo32(i >> 2), hi32(i >> 2), 0, 0) under the key (key, 0). Each element
// computes its own block and keeps one of its four words: 4x the ALU work
// of a dump, in exchange for no state shared between threads.
__device__ __forceinline__ unsigned philox_word(unsigned key,
                                                unsigned long long i) {
  const unsigned long long q = i >> 2;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<unsigned>(q), static_cast<unsigned>(q >> 32),
                 0u, 0u), key, 0u);
  switch (i & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// The dropout bits of one site, element i of the site's row-major layout:
// bits[i] when the host drew them, else word base + i of the stream
// *seed + key_add (the tower's layer j adds j). Neither: no dropout.
struct DropSrc {
  const unsigned* bits;
  const int* seed;
  unsigned key_add;
  unsigned long long base;

  __host__ __device__ bool on() const { return bits || seed; }
  __device__ unsigned bit(size_t i) const {
    return bits ? bits[i]
                : philox_word(static_cast<unsigned>(__ldg(seed)) + key_add,
                              base + i);
  }
};

// Exactly one of bits and seed, or neither (no dropout).
inline __host__ __device__ DropSrc drop_src(const void* bits, const void* seed,
                                            unsigned key_add = 0,
                                            unsigned long long base = 0) {
  DropSrc d;
  d.bits = static_cast<const unsigned*>(bits);
  d.seed = bits ? nullptr : static_cast<const int*>(seed);
  d.key_add = key_add;
  d.base = base;
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact (erf) GELU. The TPU kernel approximates erf (Abramowitz-Stegun
// 7.1.26, max error 7.2e-7); the card has erff.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// Its analytic derivative Phi(x) + x phi(x), as the TPU backward uses it.
__device__ __forceinline__ float dgelu_erf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * expf(-0.5f * x * x) * 0.39894228040143268f;
}

// ---------------------------------------------------------------------------
// LayerNorm tiles of the whole-tower kernels (tower_block.cu: K7, K8), over
// rows of width h <= kLnMaxWidth: one warp per row, the row read once into
// registers (lane i holds elements i, i + 32, ...), f32 statistics (mean,
// then the centred sum of squares), y = (x - mean) * rsqrt(var + eps) *
// gamma + beta. ROUND_AFFINE rounds gamma/beta to T first, as the
// half-layer kernels do (block_pallas.py casts them to the caller dtype),
// while the stand-alone LayerNorm uses them as they are. K1-K6 run the
// vector row kernels further down (after the column sum).
// ---------------------------------------------------------------------------

constexpr int kLnPerLane = 32;
constexpr int kLnMaxWidth = 32 * kLnPerLane;

// Rows tile * WARPS .. tile * WARPS + WARPS - 1, one warp each. G is the type
// of gamma and beta: f32 masters, or T where the caller holds them rounded.
template <typename T, typename G, bool ROUND_AFFINE, int WARPS>
__device__ __forceinline__ void
layernorm_rows_tile(const T* x, const G* __restrict__ gamma,
                    const G* __restrict__ beta, T* y, int rows, int h,
                    float eps, int tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * h;
  T* yr = y + (size_t)row * h;
  float v[kLnPerLane];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kLnPerLane; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < h ? to_f32(xr[i]) : 0.f;
    s += v[j];
  }
  const float mean = warp_sum(s) / h;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kLnPerLane; ++j) {
    const float d = lane + 32 * j < h ? v[j] - mean : 0.f;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / h + eps);
#pragma unroll
  for (int j = 0; j < kLnPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i >= h) break;
    float g = to_f32(gamma[i]), b = to_f32(beta[i]);
    if (ROUND_AFFINE) {
      g = round_to<T>(g);
      b = round_to<T>(b);
    }
    yr[i] = from_f32<T>((v[j] - mean) * rs * g + b);
  }
}

// ---------------------------------------------------------------------------
// LayerNorm backward over rows (block_pallas.py `_ln_bwd_f32`,
// layernorm_pallas.py `_bwd_kernel`), statistics recomputed from the saved
// pre-LN input x:
//   xhat = (x - mean) rs,  dxhat = dy g,
//   dx = rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat))   (f32)
// stored rounded to T. With `dxd` (the half-layers with dropout), also
// dxd = drop(r(dx)), its bits from `drop`. The whole-tower tile below
// writes its column sums [dy xhat | dy | (nq == 3) f32(dxd or dx)] as
// per-tile partials, f32, part (tiles, nq h), which colsum_tile reduces in
// a fixed order; K2, K4 and K6 run `layernorm_bwd_kernel` further down.
// ---------------------------------------------------------------------------

// Rows tile * WARPS .. + WARPS - 1; `red` is WARPS * kLnMaxWidth floats of
// shared memory; the tile's partial sums go to row `tile` of part.
template <typename T, typename G, bool ROUND_GAMMA, int WARPS>
__device__ __forceinline__ void
layernorm_bwd_rows_tile(const T* dy, const T* x, const G* __restrict__ gamma,
                        T* dx, T* dxd, const DropSrc& drop, unsigned thr,
                        float scale, float* part, int nq, int rows, int h,
                        float eps, int tile, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  const bool live = row < rows;
  float v[kLnPerLane], d[kLnPerLane], o[kLnPerLane];
  if (live) {
    const T* xr = x + (size_t)row * h;
    const T* dr = dy + (size_t)row * h;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPerLane; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < h ? to_f32(xr[i]) : 0.f;
      d[j] = i < h ? to_f32(dr[i]) : 0.f;
      s += v[j];
    }
    const float mean = warp_sum(s) / h;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPerLane; ++j) {
      v[j] = lane + 32 * j < h ? v[j] - mean : 0.f;
      q += v[j] * v[j];
    }
    const float rs = rsqrtf(warp_sum(q) / h + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kLnPerLane; ++j) {
      const int i = lane + 32 * j;
      v[j] *= rs;                                   // xhat
      float g = i < h ? to_f32(gamma[i]) : 0.f;
      if (ROUND_GAMMA) g = round_to<T>(g);
      o[j] = d[j] * g;                              // dxhat
      m1 += o[j];
      m2 += o[j] * v[j];
    }
    m1 = warp_sum(m1) / h;
    m2 = warp_sum(m2) / h;
    T* xo = dx + (size_t)row * h;
    T* xdo = dxd ? dxd + (size_t)row * h : nullptr;
    const size_t r0 = (size_t)row * h;
#pragma unroll
    for (int j = 0; j < kLnPerLane; ++j) {
      const int i = lane + 32 * j;
      if (i >= h) break;
      float r = round_to<T>(rs * (o[j] - m1 - v[j] * m2));
      xo[i] = from_f32<T>(r);
      if (xdo) {
        if (drop.on()) r = drop_to<T>(r, drop.bit(r0 + i), thr, scale);
        xdo[i] = from_f32<T>(r);
      }
      o[j] = r;                                     // what the 3rd sum adds
    }
  }
  for (int qi = 0; qi < nq; ++qi) {
#pragma unroll
    for (int j = 0; j < kLnPerLane; ++j) {
      const int i = lane + 32 * j;
      if (i < h) {
        float c = 0.f;
        if (live) c = qi == 0 ? d[j] * v[j] : (qi == 1 ? d[j] : o[j]);
        red[warp * kLnMaxWidth + i] = c;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < h; i += WARPS * 32) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * kLnMaxWidth + i];
      part[(size_t)tile * nq * h + qi * h + i] = s;
    }
    __syncthreads();
  }
}

// out[c] = sum over rows of f32(in[row, c]), (rows, cols) row-major. A block
// sums 32 columns; its 8 warps take every 8th row and are combined in a
// fixed order, so the result does not depend on scheduling.
constexpr int kSumCols = 32, kSumRowGroups = 8;

// Columns c0 .. c0 + 31 of `in` (rows, cols), summed into out[0 .. 31] as
// TOut; thread (tx, ty) of 32 x GROUPS; `red` is GROUPS * 32 floats.
template <typename TIn, typename TOut, int GROUPS>
__device__ __forceinline__ void
colsum_tile(const TIn* in, int rows, int cols, int c0, TOut* out, int tx,
            int ty, float* red) {
  const int c = c0 + tx;
  float s = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int r = ty; r < rows; r += GROUPS)
      s += to_f32(in[(size_t)r * cols + c]);
  }
  red[ty * kSumCols + tx] = s;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) t += red[g * kSumCols + tx];
    out[tx] = from_f32<TOut>(t);
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kSumCols * kSumRowGroups)
colsum_kernel(const TIn* __restrict__ in, int rows, int cols,
              float* __restrict__ out) {
  __shared__ float red[kSumRowGroups * kSumCols];
  colsum_tile<TIn, float, kSumRowGroups>(in, rows, cols,
                                         blockIdx.x * kSumCols,
                                         out + blockIdx.x * kSumCols,
                                         threadIdx.x, threadIdx.y, red);
}

template <typename TIn>
cudaError_t launch_colsum(const TIn* in, int rows, int cols, float* out,
                          cudaStream_t stream) {
  colsum_kernel<TIn><<<(cols + kSumCols - 1) / kSumCols,
                       dim3(kSumCols, kSumRowGroups), 0, stream>>>(
      in, rows, cols, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm row kernels for Hopper: the forward (K1, and the last phase of
// K3 and K5) and the backward with its column sums (K2, and the first phase
// of K4 and K6), one launch each.
//
// Replace: layernorm_pallas.py `_fwd_kernel` and `_bwd_kernel` (reached
// through `_fwd_call` :103 and `_bwd_call` :120), and the LN epilogue and
// prologue of block_pallas.py's four half-layer kernels.
//
// Bound on the H100: bytes, and below that the launch. At R = H = 768 in
// bf16 the forward moves 2.4 MB (0.71 us at 3.35 TB/s) and the backward
// 3.5 MB (1.06 us); both sit below the cost of a launch, so what a call
// costs is the launch, one warp's chain of latencies over its row (loads,
// two rounds of shuffles, stores) and, in the backward, the steps that add
// the column sums across blocks.
//
// What held the earlier warp-per-row design back (K1 7.06 us, K2 12.04 us
// with a cast of dy in the timed call, against F.layer_norm 4.38 us and
// aten native_layer_norm_backward 7.50 us, bf16 at R = H = 768, NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py): every
// element was its own 2-byte load (24 a lane at H = 768); gamma and beta
// were f32 scalar loads issued only after the statistics, a second memory
// round trip in every row; 8 rows a 256-thread block gave 96 blocks at
// R = 768 on 132 SMs; and the backward was three device operations (a
// memset of its output, the row pass with two __syncthreads round trips
// through 24 KB of shared memory per partial sum, and a second launch that
// added 96 partial rows).
//
// This design:
// - Device memory moves as 16-byte vectors (8 bf16 or 4 f32): lane l loads
//   vectors l, l + 32, ... of its warp's row (VPL of them, a template
//   argument the launcher picks from h: 3 uint4 a lane for bf16 at
//   H = 768), all issued before anything waits on them, and computes and
//   stores its outputs in that layout. Where h is not a multiple of the
//   vector or a pointer is not 16-byte aligned, the kernel runs with
//   VEC = 1: element by element, 32 a lane (h <= 1024).
// - The row sums are the whole-tower kernels' tiles' (above), in their
//   order: lane l adds elements l, l + 32, ..., read back from a copy of
//   the row in a staging buffer in shared memory (no bank conflicts), the
//   mean first, then the centred variance (the backward then sum dxhat and
//   sum dxhat xhat), and each output is the tile's expression, rounded
//   once: the arithmetic of K7 and K8 (chip_smoke.py holds the K5/K3
//   chain against K7: equal bit for bit) and of the earlier K1 and K2.
//   Adding in another order would move bf16 outputs by a rounding step
//   here and there, and the chains apart from the towers.
// - gamma and beta are read as float4 (rounded to T first with
//   ROUND_AFFINE / ROUND_GAMMA), issued beside the row's loads; the
//   forward keeps them in registers across every row its warp walks, the
//   backward (one row a warp) also reads the tiles' layout of gamma.
// - Forward grid: two warps (64 threads) a block, one row a warp, a
//   grid-stride loop past kLnFwdMaxBlocks blocks: R = 768 gives 384 blocks
//   and R = 384 192, both more than the 132 SMs.
// - The backward's column sums come in the same launch, deterministic, with no
//   float atomics, and in the earlier kernels' order (there: 8-row blocks'
//   partial rows, then a column-sum launch adding them in 8 groups by block
//   index mod 8, each group in block order, then the groups in order). Blocks
//   are the earlier kernels' (8 warps, a row each: 96 at R = 768, 48 at R =
//   384); each adds its warps' rows in warp order through shared memory once
//   (lane-minor slots: no bank conflicts) into its partial row in `part`. Then
//   two levels of tickets on integer arrival counters (acquire-release, one a
//   block): the block that takes its group's last ticket adds the group's rows
//   in block order into the group's row, and the group block that takes the
//   last of the 8 group tickets adds the group rows in order into the sums;
//   each resets its counter to 0. Both read with 16-byte loads, a whole
//   group's rows in flight. So the sums add in the earlier kernels' order,
//   and training reads as before. (With the blocks' rows added in another
//   order, cluster by cluster, the 22 training steps before chip_smoke.py's
//   f32 kernels on/off comparison ended on other weights, and that comparison
//   failed in the text head, which routes gradients through maxima.)
// - The counters (a device's 16 words, 0 between calls; ops/layernorm.py
//   makes them) are shared by every LN backward launch on the device:
//   concurrent LN backward calls (K2, K4, K6) on two streams of one device
//   are not supported.
//
// Times of this design (bf16, R = H = 768, warm / cold L2, CUDA graph of
// 20 calls, chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): K1 3.0 / 4.0
// us against F.layer_norm 4.2 us warm; K2 7.9 / 8.9 us against
// native_layer_norm_backward 7.4 us warm (PERF.md has the runs).
// ---------------------------------------------------------------------------

constexpr int kLnFwdWarps = 2, kLnFwdThreads = 32 * kLnFwdWarps;
constexpr int kLnFwdMaxBlocks = 1024;
constexpr int kLnBwdWarps = 8, kLnBwdThreads = 32 * kLnBwdWarps;
constexpr int kLnGroups = 8;

inline int ln_fwd_blocks(int rows) {
  const int b = (rows + kLnFwdWarps - 1) / kLnFwdWarps;
  return b < kLnFwdMaxBlocks ? b : kLnFwdMaxBlocks;
}

// The backward's blocks: the earlier kernels', 8 rows each, one a warp.
inline int ln_bwd_blocks(int rows) {
  return (rows + kLnBwdWarps - 1) / kLnBwdWarps;
}

// Rows of the backward's `part` scratch: one a block, then one a group of
// blocks (by block index mod kLnGroups) (ops/layernorm.py `ln_bwd_parts`
// mirrors this).
inline int ln_bwd_parts(int rows) { return ln_bwd_blocks(rows) + kLnGroups; }

// The backward's sums a warp holds: NQ sums of VPL vectors of VEC
// columns a lane, lane-minor (conflict-free in shared memory). At most
// NQ kLnMaxWidth: `part` rows are that wide.
template <int NQ, int VPL, int VEC>
__host__ __device__ constexpr int ln_bwd_slots() {
  return NQ * VPL * VEC * 32;
}

// The VEC elements of T in the 16-byte vector u, as f32.
template <int VEC, typename T>
__device__ __forceinline__ void unpack_vec(const uint4& u, float (&v)[VEC]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, float>::value) {
      v[j] = __uint_as_float(w[j]);
    } else {                     // bf16: the high half of an f32, low first
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

// v rounded to T and stored at p: one 16-byte store where VEC elements
// fill 16 bytes (p 16-byte aligned), else VEC scalar ones.
template <int VEC, typename T>
__device__ __forceinline__ void st_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        w[j] = __float_as_uint(v[j]);
      } else {
        w[j] = static_cast<unsigned>(
                   __bfloat16_as_ushort(__float2bfloat16(v[2 * j]))) |
               static_cast<unsigned>(
                   __bfloat16_as_ushort(__float2bfloat16(v[2 * j + 1])))
                   << 16;
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f32<T>(v[j]);
  }
}

// VEC f32 values at p (an affine parameter), rounded to T with ROUND: as
// float4 loads where VEC is a multiple of 4 (p 16-byte aligned).
template <int VEC, typename T, bool ROUND>
__device__ __forceinline__ void ld_param(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + j));
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __ldg(p + j);
  }
  if (ROUND) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = round_to<T>(v[j]);
  }
}

// Lane l's share of a row: vectors l, l + 32, ... (VPL of them, those
// below nv live; VEC elements each). ln_fetch issues the loads (16-byte
// vectors into u; with VEC = 1 the elements straight into v, 0 where not
// live); ln_put then stores the vectors into the warp's staging buffer in
// shared memory, from which the statistics read the tiles' layout, and
// unpacks them into v (the caller syncs the warp before and after).
template <int VEC, int VPL, typename T>
__device__ __forceinline__ void ln_fetch(const T* row, uint4 (&u)[VPL],
                                         float (&v)[VPL][VEC], int lane,
                                         int nv) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (lane + 32 * k) * VEC;
    if constexpr (VEC > 1) {
      if (lane + 32 * k < nv) u[k] = *reinterpret_cast<const uint4*>(row + c);
    } else {
      v[k][0] = lane + 32 * k < nv ? to_f32(row[c]) : 0.f;
    }
  }
}

template <int VEC, int VPL, typename T>
__device__ __forceinline__ void ln_put(T* buf, const uint4 (&u)[VPL],
                                       float (&v)[VPL][VEC], int lane,
                                       int nv) {
  if constexpr (VEC > 1) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int c = (lane + 32 * k) * VEC;
      if (lane + 32 * k < nv) {
        *reinterpret_cast<uint4*>(buf + c) = u[k];
        unpack_vec<VEC, T>(u[k], v[k]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
      }
    }
  }
}

// Element j of lane l in the tiles' layout (element l + 32 j of the row,
// 0 past h): from the staging buffer, or from v where the two layouts are
// one (VEC = 1).
template <int VEC, int VPL, typename T>
__device__ __forceinline__ float ln_tile(const T* buf,
                                         const float (&v)[VPL][VEC], int j,
                                         int lane, int h) {
  if constexpr (VEC > 1) {
    const int i = lane + 32 * j;
    return i < h ? to_f32(buf[i]) : 0.f;
  } else {
    return v[j][0];
  }
}

// K1's kernel. Device memory moves as 16-byte vectors (lane l: vectors l,
// l + 32, ...); the row statistics are layernorm_rows_tile's sums, in its
// order (lane l adds elements l, l + 32, ... read back from the staging
// buffer), and y is its expression.
template <typename T, bool ROUND_AFFINE, int VEC, int VPL>
__global__ void __launch_bounds__(kLnFwdThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     int rows, int h, float eps) {
  constexpr int J = VEC * VPL;
  __shared__ __align__(16) T stage[kLnFwdWarps][32 * J];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nv = h / VEC;
  float g[VPL][VEC], b[VPL][VEC];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + 32 * k < nv) {
      ld_param<VEC, T, ROUND_AFFINE>(gamma + (lane + 32 * k) * VEC, g[k]);
      ld_param<VEC, T, ROUND_AFFINE>(beta + (lane + 32 * k) * VEC, b[k]);
    }
  }
  T* buf = stage[warp];
  for (int row = blockIdx.x * kLnFwdWarps + warp; row < rows;
       row += gridDim.x * kLnFwdWarps) {
    float v[VPL][VEC];
    uint4 u[VPL];
    ln_fetch<VEC, VPL>(x + (size_t)row * h, u, v, lane, nv);
    __syncwarp();
    ln_put<VEC, VPL>(buf, u, v, lane, nv);
    __syncwarp();
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) s += ln_tile<VEC, VPL>(buf, v, j, lane, h);
    const float mean = warp_sum(s) / h;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float d = lane + 32 * j < h
                          ? ln_tile<VEC, VPL>(buf, v, j, lane, h) - mean
                          : 0.f;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / h + eps);
    T* yr = y + (size_t)row * h;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nv) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = (v[k][j] - mean) * rs * g[k][j] + b[k][j];
        st_vec<VEC>(yr + (lane + 32 * k) * VEC, o);
      }
    }
  }
}

// K2's kernel (block_pallas.py `_ln_bwd_f32`, layernorm_pallas.py
// `_bwd_kernel`), statistics recomputed from the pre-LN input x:
//   xhat = (x - mean) rs,  dxhat = dy g,
//   dx = rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat))   (f32)
// stored rounded to T; with `dxd` (the half-layers with dropout) also
// dxd = drop(r(dx)), the bit of element (row, i) being drop.bit(row h + i).
// As in K1's kernel, the four row sums are layernorm_bwd_rows_tile's, in
// its order, and dx is its expression. sums (NQ h) f32 = [sum dy xhat |
// sum dy | (NQ == 3) sum f32(dxd or dx)] over the rows, by way of part
// (ln_bwd_parts(rows), NQ kLnMaxWidth) f32 and the arrival counters (see
// the section note); 4 kLnBwdWarps ln_bwd_slots<NQ, VPL, VEC>() bytes of
// dynamic shared memory, a row a warp: its staging buffers, then its
// row's sums.
template <typename T, bool ROUND_GAMMA, int VEC, int VPL, int NQ>
__global__ void __launch_bounds__(kLnBwdThreads)
layernorm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ gamma, T* __restrict__ dx,
                     T* __restrict__ dxd, DropSrc drop, unsigned thr,
                     float scale, float* __restrict__ part,
                     float* __restrict__ sums, unsigned* counter, int rows,
                     int h, float eps) {
  constexpr int J = VEC * VPL, n = ln_bwd_slots<NQ, VPL, VEC>();
  extern __shared__ __align__(16) float red[];
  __shared__ unsigned ticket;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nv = h / VEC;
  const int b = blockIdx.x, row = b * kLnBwdWarps + warp;
  const int nb = gridDim.x, grp = b % kLnGroups;
  float* mine = red + warp * n;                 // this warp's row
  T* xbuf = reinterpret_cast<T*>(mine);
  T* dbuf = xbuf + 32 * J;
  if (row < rows) {
    const size_t r0 = (size_t)row * h;
    float v[VPL][VEC], d[VPL][VEC];
    uint4 ux[VPL], ud[VPL];
    ln_fetch<VEC, VPL>(x + r0, ux, v, lane, nv);
    ln_fetch<VEC, VPL>(dy + r0, ud, d, lane, nv);
    ln_put<VEC, VPL>(xbuf, ux, v, lane, nv);
    ln_put<VEC, VPL>(dbuf, ud, d, lane, nv);
    __syncwarp();
    // the tile's sums, in its order and with its expressions: (sum x,
    // sum dxhat), sum (x - mean)^2, sum dxhat xhat
    float xt[J], ot[J], s = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = lane + 32 * j;
      float g = i < h ? __ldg(gamma + i) : 0.f;
      if (ROUND_GAMMA) g = round_to<T>(g);
      xt[j] = ln_tile<VEC, VPL>(xbuf, v, j, lane, h);
      ot[j] = ln_tile<VEC, VPL>(dbuf, d, j, lane, h) * g;    // dxhat
      s += xt[j];
      m1 += ot[j];
    }
    const float mean = warp_sum(s) / h;
    m1 = warp_sum(m1) / h;
    float q2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xt[j] = lane + 32 * j < h ? xt[j] - mean : 0.f;
      q2 += xt[j] * xt[j];
    }
    const float rs = rsqrtf(warp_sum(q2) / h + eps);
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) m2 += ot[j] * (xt[j] * rs);
    m2 = warp_sum(m2) / h;        // the warp's staging reads are done
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int col = (lane + 32 * k) * VEC;
      const bool live = lane + 32 * k < nv;
      float g[VEC], r[VEC];
      if (live) ld_param<VEC, T, ROUND_GAMMA>(gamma + col, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (v[k][j] - mean) * rs;
        r[j] = live ? round_to<T>(rs * (d[k][j] * g[j] - m1 - xh * m2))
                    : 0.f;
        mine[((0 * VPL + k) * VEC + j) * 32 + lane] = live ? d[k][j] * xh
                                                           : 0.f;
        mine[((1 * VPL + k) * VEC + j) * 32 + lane] = live ? d[k][j] : 0.f;
      }
      if (live) {
        st_vec<VEC>(dx + r0 + col, r);
        if (dxd) {
          if (drop.on()) {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              r[j] = drop_to<T>(r[j], drop.bit(r0 + col + j), thr, scale);
          }
          st_vec<VEC>(dxd + r0 + col, r);
        }
      }
      if constexpr (NQ == 3) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          mine[((2 * VPL + k) * VEC + j) * 32 + lane] = r[j];
      }
    }
  } else {
    for (int p = lane; p < n; p += 32) mine[p] = 0.f;
  }
  // (1) the block's row of sums, slot ((q VPL + k) VEC + j) 32 + lane
  // holding column (lane + 32 k) VEC + j of sum q: the warps added in warp
  // order, into part's row b
  constexpr size_t ld = (size_t)NQ * kLnMaxWidth;   // a row of part
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += kLnBwdThreads) {
    float t = red[p];
#pragma unroll
    for (int w = 1; w < kLnBwdWarps; ++w) t += red[w * n + p];
    part[b * ld + p] = t;
  }
  // (2) the group's row: the block that takes its group's last ticket
  // (acquire-release, one a block) adds the group's block rows b % 8 = grp
  // in block order into part's row nb + grp
  __syncthreads();
  const int members = (nb - grp + kLnGroups - 1) / kLnGroups;
  if (threadIdx.x == 0)
    ticket = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(
                 counter[1 + grp]).fetch_add(1u, cuda::memory_order_acq_rel);
  __syncthreads();
  if (ticket != static_cast<unsigned>(members - 1)) return;
  if (threadIdx.x == 0) counter[1 + grp] = 0u;
  const float4* rows4 = reinterpret_cast<const float4*>(part);
  constexpr int ld4 = static_cast<int>(ld / 4);
  for (int p4 = threadIdx.x; p4 < n / 4; p4 += kLnBwdThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < members; j0 += 16) {      // 16 loads in flight
      float4 t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        t[i] = j0 + i < members
                   ? __ldcg(rows4 + (size_t)(kLnGroups * (j0 + i) + grp) *
                                        ld4 + p4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sum.x += t[i].x;
        sum.y += t[i].y;
        sum.z += t[i].z;
        sum.w += t[i].w;
      }
    }
    reinterpret_cast<float4*>(part)[(size_t)(nb + grp) * ld4 + p4] = sum;
  }
  // (3) the sums: the group block that takes the last ticket of the
  // groups adds the group rows in group order and writes them
  __syncthreads();
  const int groups = nb < kLnGroups ? nb : kLnGroups;
  if (threadIdx.x == 0)
    ticket = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(
                 counter[0]).fetch_add(1u, cuda::memory_order_acq_rel);
  __syncthreads();
  if (ticket != static_cast<unsigned>(groups - 1)) return;
  if (threadIdx.x == 0) counter[0] = 0u;
  for (int p4 = threadIdx.x; p4 < n / 4; p4 += kLnBwdThreads) {
    float4 t[kLnGroups];
#pragma unroll
    for (int g = 0; g < kLnGroups; ++g)
      t[g] = g < groups ? __ldcg(rows4 + (size_t)(nb + g) * ld4 + p4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int g = 0; g < kLnGroups; ++g) {
      sum[0] += t[g].x;
      sum[1] += t[g].y;
      sum[2] += t[g].z;
      sum[3] += t[g].w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * p4 + e;                      // slot p's column
      const int col = (p % 32 + 32 * (p / 32 / VEC % VPL)) * VEC +
                      p / 32 % VEC;
      if (col < h) sums[p / (32 * J) * h + col] = sum[e];
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Calls f(VEC, VPL) (as std::integral_constant) for the vectors per lane
// that cover h: VEC = 16 / sizeof(T) where `vec` holds, else the scalar
// path VEC = 1, VPL = kLnPerLane.
template <int V, int N, typename F>
cudaError_t ln_dispatch_vpl(int vpl, F& f) {
  if constexpr (N * 32 * V > kLnMaxWidth) {
    return cudaErrorInvalidValue;
  } else {
    if (vpl == N)
      return f(std::integral_constant<int, V>{},
               std::integral_constant<int, N>{});
    return ln_dispatch_vpl<V, N + 1>(vpl, f);
  }
}

template <typename T, typename F>
cudaError_t ln_dispatch(int h, bool vec, F&& f) {
  constexpr int V = 16 / sizeof(T);
  if (h < 1 || h > kLnMaxWidth) return cudaErrorInvalidValue;
  if (vec && h % V == 0)
    return ln_dispatch_vpl<V, 1>((h / V + 31) / 32, f);
  return f(std::integral_constant<int, 1>{},
           std::integral_constant<int, kLnPerLane>{});
}

template <typename T, bool ROUND_AFFINE>
cudaError_t launch_layernorm_rows(const T* x, const float* gamma,
                                  const float* beta, T* y, int rows, int h,
                                  float eps, cudaStream_t stream) {
  const bool vec = aligned16(x) && aligned16(y) && aligned16(gamma) &&
                   aligned16(beta);
  return ln_dispatch<T>(h, vec, [&](auto v, auto n) {
    layernorm_fwd_kernel<T, ROUND_AFFINE, decltype(v)::value,
                         decltype(n)::value>
        <<<ln_fwd_blocks(rows), kLnFwdThreads, 0, stream>>>(x, gamma, beta,
                                                            y, rows, h, eps);
    return cudaGetLastError();
  });
}

// The LayerNorm backward row pass with its NQ column sums into sums (NQ h
// f32), in one launch. part: (ln_bwd_parts(rows), NQ kLnMaxWidth) f32
// scratch;
// counter: the device's arrival counter, 0 on entry and on exit.
template <typename T, bool ROUND_GAMMA, int NQ>
cudaError_t launch_layernorm_bwd(const T* dy, const T* x, const float* gamma,
                                 T* dx, T* dxd, const DropSrc& drop,
                                 unsigned thr, float scale, float* part,
                                 float* sums, unsigned* counter, int rows,
                                 int h, float eps, cudaStream_t stream) {
  const bool vec = aligned16(dy) && aligned16(x) && aligned16(gamma) &&
                   aligned16(dx) && aligned16(dxd);
  return ln_dispatch<T>(h, vec, [&](auto v, auto n) {
    constexpr int VEC = decltype(v)::value, VPL = decltype(n)::value;
    const auto kernel = layernorm_bwd_kernel<T, ROUND_GAMMA, VEC, VPL, NQ>;
    const size_t smem =
        sizeof(float) * kLnBwdWarps * ln_bwd_slots<NQ, VPL, VEC>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<ln_bwd_blocks(rows), kLnBwdThreads, smem, stream>>>(
        dy, x, gamma, dx, dxd, drop, thr, scale, part, sums, counter, rows, h,
        eps);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// Tiled GEMM: out(M, N) = epilogue(A . B), A (M, K), B (K, N).
//
// Operand layouts (the forward uses the first of each; the backward the
// others):
//   A  kARowMajor    (M, K) row-major, type T: an activation;
//      kATransposed  stored (K, M) row-major, type T: A is the transpose of
//                    an activation, for the weight gradients dW = G^T X
//                    that contract over token rows;
//   B  kBWeightNK    f32 master stored (N, K) row-major, as nn.Linear keeps
//                    its weight (out = A . W^T, the forward);
//      kBWeightKN    f32 master stored (K, N) row-major (out = A . W, the
//                    backward's dX = dY . W);
//      kBActKN       stored (K, N) row-major, type T: an activation, or a
//                    weight the caller holds rounded to T (the tower);
//      kBActNK       stored (N, K) row-major, type T: such a weight in
//                    nn.Linear's layout (the tower's forward).
// An f32 weight tile is rounded to T as it is staged in shared memory, so no
// rounded weight copy ever exists in device memory. 64x64 output tile per
// block, K in steps of 32, 4 warps. For bf16 each warp runs 2x2 wmma
// 16x16x16 tiles with f32 accumulators; for f32 every thread runs an 8x4
// FMA micro-tile (full f32, no TF32), which keeps the f32 variant usable
// for tight checks. Tiles move as 16-byte vectors, and the next K-tile is
// loaded into registers while the current one is multiplied. Shapes: N a
// multiple of 64; M a multiple of 64 for kATransposed; K a multiple of 32
// for kARowMajor (the wrappers check); K may be ragged for the operands
// stored (K, .), whose rows past K load as zeros.
// ---------------------------------------------------------------------------

enum Epilogue {
  kEpiBias = 0,          // out = r(r(acc) + r(bias)); no bias: r(acc)
  kEpiBiasGelu = 1,      // f = r(r(acc) + r(bias)); out = r(gelu(f));
                         //   out2 = f when given
  kEpiBiasResidual = 2,  // g = r(r(acc) + r(bias)), dropped with `drop`
                         //   when on; out = r(resid + g)
  kEpiDgelu = 3,         // out = r(r(acc) * gelu'(aux))
  kEpiF32 = 4,           // out (f32) = acc
};

enum ALayout { kARowMajor = 0, kATransposed = 1 };
enum BLayout { kBWeightNK = 0, kBWeightKN = 1, kBActKN = 2, kBActNK = 3 };

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;
constexpr int kALd = kBK + 8;  // padded leading dims (wmma wants multiples
constexpr int kBLd = kBN + 8;  // of 8 elements and 32-byte aligned rows)
constexpr int kCLd = kBN + 4;

// Shared memory of one GEMM tile: As | Bs | Cs.
template <typename T>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (kBM * kALd + kBK * kBLd) * sizeof(T) + kBM * kCLd * sizeof(float);
}

struct GemmArgs {
  const void* a;          // see ALayout, type T
  const void* b;          // see BLayout
  const float* bias;      // (N,) f32 master or null
  const void* bias_t;     // (N,) type T, read when bias is null, or null
  const void* resid;      // (M, N) type T: kEpiBiasResidual
  const void* aux;        // (M, N) type T: kEpiDgelu's pre-activation
  DropSrc drop;           // (M, N) dropout of kEpiBiasResidual, or off
  void* out;              // (M, N) type T, f32 for kEpiF32
  void* out2;             // (M, N) type T: kEpiBiasGelu's f, or null
  int m, n, k;
  unsigned thr;           // keep iff bit >= thr
  float scale;            // 1 / (1 - rate)
};

inline __host__ __device__ GemmArgs gemm_args(const void* a, const void* b, void* out, int m,
                          int n, int k) {
  GemmArgs p{};
  p.a = a;
  p.b = b;
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  return p;
}

template <typename T> struct TileMma;

template <> struct TileMma<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }

  __device__ void run(const __nv_bfloat16* As, const __nv_bfloat16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kBLd + wn + 16 * j, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }

  __device__ void store(float* Cs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * kCLd + wn + 16 * j,
                                c[i][j], kCLd, wmma::mem_row_major);
  }
};

template <> struct TileMma<float> {
  // thread (tr, tc) owns rows tr + 8 i (i < 8) and columns 4 tc + j (j < 4)
  float c[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  __device__ void run(const float* As, const float* Bs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr + 8 * i) * kALd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kBLd + 4 * tc + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ void store(float* Cs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr + 8 * i) * kCLd + 4 * tc + j] = c[i][j];
  }
};

inline __host__ __device__ int gemm_tiles(const GemmArgs& p) {
  return ((p.m + kBM - 1) / kBM) * ((p.n + kBN - 1) / kBN);
}

// Output tile `tile` (row-major over the (M / 64, N / 64) tile grid) of the
// GEMM p, by the kGemmThreads threads of a block; smem: gemm_smem_bytes<T>()
// bytes, 32-byte aligned.
template <typename T, int EPI, int AL, int BL>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, int tile,
                                          unsigned char* smem) {
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * kALd;
  float* Cs = reinterpret_cast<float*>(Bs + kBK * kBLd);
  const T* A = static_cast<const T*>(p.a);
  const int tiles_n = (p.n + kBN - 1) / kBN;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int tid = threadIdx.x;

  // per thread and K-tile: kAVecs 16-byte vectors of A, kBVecs of B
  constexpr int kVec = 16 / sizeof(T);                   // T per vector
  constexpr int kAVecs = kBM * kBK / kVec / kGemmThreads;
  constexpr bool kBIsT = BL == kBActKN || BL == kBActNK;
  constexpr int kBPer = kBIsT ? kVec : 4;                // elements / vector
  constexpr int kBVecs = kBK * kBN / kBPer / kGemmThreads;
  uint4 a_reg[kAVecs];
  uint4 b_reg[kBVecs];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (AL == kARowMajor) {    // vectors along k
        const int r = idx / (kBK / kVec), c = (idx % (kBK / kVec)) * kVec;
        const int gm = m0 + r;
        a_reg[l] = gm < p.m ? *reinterpret_cast<const uint4*>(
                                  A + (size_t)gm * p.k + k0 + c)
                            : zero4;
      } else {                   // stored (K, M): vectors along m
        const int r = idx / (kBM / kVec), c = (idx % (kBM / kVec)) * kVec;
        const int gk = k0 + r;
        a_reg[l] = gk < p.k ? *reinterpret_cast<const uint4*>(
                                  A + (size_t)gk * p.m + m0 + c)
                            : zero4;
      }
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (BL == kBWeightNK) {    // 4 consecutive k of one n
        const float* W = static_cast<const float*>(p.b);
        const int c = idx / (kBK / 4), r = (idx % (kBK / 4)) * 4;
        b_reg[l] = *reinterpret_cast<const uint4*>(
            W + (size_t)(n0 + c) * p.k + k0 + r);
      } else if (BL == kBActNK) {  // kVec consecutive k of one n
        const T* W = static_cast<const T*>(p.b);
        const int c = idx / (kBK / kVec), r = (idx % (kBK / kVec)) * kVec;
        b_reg[l] = *reinterpret_cast<const uint4*>(
            W + (size_t)(n0 + c) * p.k + k0 + r);
      } else {                   // stored (K, N): vectors along n
        const int r = idx / (kBN / kBPer), c = (idx % (kBN / kBPer)) * kBPer;
        const int gk = k0 + r;
        const char* base = static_cast<const char*>(p.b);
        const size_t es = kBIsT ? sizeof(T) : sizeof(float);
        b_reg[l] = gk < p.k ? *reinterpret_cast<const uint4*>(
                                  base + ((size_t)gk * p.n + n0 + c) * es)
                            : zero4;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (AL == kARowMajor) {
        const int r = idx / (kBK / kVec), c = (idx % (kBK / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&As[r * kALd + c]) = a_reg[l];
      } else {                   // transposed into As (m, k)
        const int r = idx / (kBM / kVec), c = (idx % (kBM / kVec)) * kVec;
        const T* e = reinterpret_cast<const T*>(&a_reg[l]);
#pragma unroll
        for (int q = 0; q < kVec; ++q) As[(c + q) * kALd + r] = e[q];
      }
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (BL == kBWeightNK) {    // transposed into Bs (k, n)
        const int c = idx / (kBK / 4), r = (idx % (kBK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(&b_reg[l]);
        Bs[(r + 0) * kBLd + c] = from_f32<T>(v.x);
        Bs[(r + 1) * kBLd + c] = from_f32<T>(v.y);
        Bs[(r + 2) * kBLd + c] = from_f32<T>(v.z);
        Bs[(r + 3) * kBLd + c] = from_f32<T>(v.w);
      } else if (BL == kBActNK) {  // transposed into Bs (k, n)
        const int c = idx / (kBK / kVec), r = (idx % (kBK / kVec)) * kVec;
        const T* e = reinterpret_cast<const T*>(&b_reg[l]);
#pragma unroll
        for (int q = 0; q < kVec; ++q) Bs[(r + q) * kBLd + c] = e[q];
      } else if (BL == kBWeightKN) {
        const int r = idx / (kBN / 4), c = (idx % (kBN / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(&b_reg[l]);
        Bs[r * kBLd + c + 0] = from_f32<T>(v.x);
        Bs[r * kBLd + c + 1] = from_f32<T>(v.y);
        Bs[r * kBLd + c + 2] = from_f32<T>(v.z);
        Bs[r * kBLd + c + 3] = from_f32<T>(v.w);
      } else {
        const int r = idx / (kBN / kVec), c = (idx % (kBN / kVec)) * kVec;
        *reinterpret_cast<uint4*>(&Bs[r * kBLd + c]) = b_reg[l];
      }
    }
  };

  TileMma<T> acc;
  acc.zero();
  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    const bool more = k0 + kBK < p.k;
    if (more) load(k0 + kBK);  // in flight while the tile below multiplies
    acc.run(As, Bs);
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
  acc.store(Cs);
  __syncthreads();

  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= p.m || gn >= p.n) continue;
    const size_t o = (size_t)gm * p.n + gn;
    const float a = Cs[r * kCLd + c];
    if constexpr (EPI == kEpiF32) {
      static_cast<float*>(p.out)[o] = a;
    } else {
      T* out = static_cast<T*>(p.out);
      float v = round_to<T>(a);
      if constexpr (EPI == kEpiDgelu) {
        v *= dgelu_erf(to_f32(static_cast<const T*>(p.aux)[o]));
      } else {
        if (p.bias)
          v = round_to<T>(v + round_to<T>(p.bias[gn]));
        else if (p.bias_t)
          v = round_to<T>(v + to_f32(static_cast<const T*>(p.bias_t)[gn]));
        if constexpr (EPI == kEpiBiasGelu) {
          if (p.out2) static_cast<T*>(p.out2)[o] = from_f32<T>(v);
          v = gelu_erf(v);
        }
        if constexpr (EPI == kEpiBiasResidual) {
          if (p.drop.on()) v = drop_to<T>(v, p.drop.bit(o), p.thr, p.scale);
          v = to_f32(static_cast<const T*>(p.resid)[o]) + v;
        }
      }
      out[o] = from_f32<T>(v);
    }
  }
}

template <typename T, int EPI, int AL, int BL>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs p) {
  __shared__ __align__(32) unsigned char smem[gemm_smem_bytes<T>()];
  gemm_tile<T, EPI, AL, BL>(p, blockIdx.y * gridDim.x + blockIdx.x, smem);
}

template <typename T, int EPI, int AL = kARowMajor, int BL = kBWeightNK>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM);
  gemm_kernel<T, EPI, AL, BL><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// dW (M, N) f32 = G^T X: G stored (K, M), X stored (K, N), both type T; the
// weight gradient of a Linear with output G and input X in nn.Linear's
// (out, in) layout, contracting over the K token rows.
template <typename T>
cudaError_t launch_weight_grad(const void* g, const void* x, float* dw, int m,
                               int n, int k, cudaStream_t stream) {
  return launch_gemm<T, kEpiF32, kATransposed, kBActKN>(
      gemm_args(g, x, dw, m, n, k), stream);
}

// ---------------------------------------------------------------------------
// Multi-head self-attention, one block of work per (caption, head), heads of
// width 64, everything of the head in shared memory as f32 (block_pallas.py
// `_attn_heads_fwd`, `_attn_heads_bwd`). qkv is (B t, 3 h) with q | k | v
// packed on the output axis, head-major within each; probabilities and their
// dropout bits are (heads * B, t, t).
// ---------------------------------------------------------------------------

constexpr int kDHead = 64;
constexpr int kQkvLd = kDHead + 1;  // pad: the score loops walk rows
constexpr int kAttnThreads = 128;

// Shared memory of the forward block: q, k, v (t, 65) and scores (t, t), f32.
inline __host__ __device__ size_t attn_fwd_smem_bytes(int t) {
  return (size_t)(3 * t * kQkvLd + t * t) * sizeof(float);
}

// Caption b, head `head`: scores, softmax, the probabilities' dropout (bits
// of `drop_p`, element [head*B + b, i, j]) and P.V, by kAttnThreads
// threads.
template <typename T>
__device__ __forceinline__ void
attention_core_tile(const T* qkv, const int* __restrict__ mask,
                    const DropSrc& drop_p, unsigned thr, float scale,
                    T* p_out, T* ctx, int nb, int t, int h, float inv, int b,
                    int head, float* sm) {
  float* q = sm;
  float* k = q + t * kQkvLd;
  float* v = k + t * kQkvLd;
  float* s = v + t * kQkvLd;  // (t, t)
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * t;
  const size_t pofs = ((size_t)head * nb + b) * t * t;  // [head*B + b]

  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    const T* src = qkv + (row0 + r) * 3 * h + head * kDHead + d;
    q[r * kQkvLd + d] = to_f32(src[0]);
    k[r * kQkvLd + d] = to_f32(src[h]);
    v[r * kQkvLd + d] = to_f32(src[2 * h]);
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
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < t; j += 32) {
      float pj = round_to<T>(sr[j] / sum);
      if (p_out) p_out[pofs + r * t + j] = from_f32<T>(pj);
      if (drop_p.on())
        pj = drop_to<T>(pj, drop_p.bit(pofs + r * t + j), thr, scale);
      sr[j] = pj;
    }
  }
  __syncthreads();

  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc = fmaf(s[r * t + j], v[j * kQkvLd + d], acc);
    ctx[(row0 + r) * h + head * kDHead + d] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_core_kernel(const T* __restrict__ qkv, const int* __restrict__ mask,
                      DropSrc drop_p, unsigned thr, float scale,
                      T* __restrict__ p_out, T* __restrict__ ctx, int nb,
                      int t, int h, float inv) {
  extern __shared__ float attn_sm[];
  attention_core_tile<T>(qkv, mask, drop_p, thr, scale, p_out, ctx, nb, t, h,
                         inv, blockIdx.x, blockIdx.y, attn_sm);
}

// Shared memory of the backward block: q, k, v, do (t, 65), p and dp (t, t).
inline __host__ __device__ size_t attn_bwd_smem_bytes(int t) {
  return (size_t)(4 * t * kQkvLd + 2 * t * t) * sizeof(float);
}

// Caption b, head `head`: the per-head backward of block_pallas.py
// `_attn_heads_bwd`, from p (rounded, before dropout) and do = d(context),
// into that head's slices of dqkv. With dropout each probability's bit is
// read once: the dropped probabilities go into the dp buffer first (a
// dropped one as -1, since p >= 0), where dv reads them and dp its mask.
template <typename T>
__device__ __forceinline__ void
attention_core_bwd_tile(const T* qkv, const T* p, const T* dout,
                        const DropSrc& drop_p, unsigned thr, float scale,
                        T* dqkv, int nb, int t, int h, float inv, int b,
                        int head, float* sm) {
  float* q = sm;
  float* k = q + t * kQkvLd;
  float* v = k + t * kQkvLd;
  float* g = v + t * kQkvLd;   // do
  float* ps = g + t * kQkvLd;  // (t, t) p
  float* s = ps + t * t;       // (t, t) dp, then ds
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * t;
  const size_t pofs = ((size_t)head * nb + b) * t * t;

  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    const T* src = qkv + (row0 + r) * 3 * h + head * kDHead + d;
    q[r * kQkvLd + d] = to_f32(src[0]);
    k[r * kQkvLd + d] = to_f32(src[h]);
    v[r * kQkvLd + d] = to_f32(src[2 * h]);
    g[r * kQkvLd + d] = to_f32(dout[(row0 + r) * h + head * kDHead + d]);
  }
  for (int i = tid; i < t * t; i += kAttnThreads)
    ps[i] = to_f32(p[pofs + i]);
  __syncthreads();
  const bool drop = drop_p.on();
  if (drop) {
    const float sc = round_to<T>(scale);
    for (int i = tid; i < t * t; i += kAttnThreads)
      s[i] = drop_p.bit(pofs + i) >= thr ? round_to<T>(ps[i] * sc) : -1.f;
    __syncthreads();
  }

  // dv[j] = sum_i p_drop[i, j] do[i]
  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int j = i / kDHead, d = i % kDHead;
    float acc = 0.f;
    for (int r = 0; r < t; ++r) {
      const float pd = drop ? fmaxf(s[r * t + j], 0.f) : ps[r * t + j];
      acc = fmaf(pd, g[r * kQkvLd + d], acc);
    }
    dqkv[(row0 + j) * 3 * h + 2 * h + head * kDHead + d] =
        from_f32<T>(acc);
  }
  if (drop) __syncthreads();   // s is overwritten with dp below
  // dp[i, j] = do[i] . v[j], masked like the probabilities (f32 scale)
  for (int i = tid; i < t * t; i += kAttnThreads) {
    const int qi = i / t, kj = i % t;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kDHead; ++d)
      acc = fmaf(g[qi * kQkvLd + d], v[kj * kQkvLd + d], acc);
    if (drop) acc = s[i] >= 0.f ? acc * scale : 0.f;
    s[i] = acc;
  }
  __syncthreads();

  // ds = r(p (dp - sum_j dp p) / sqrt(d)), one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < t; r += kAttnThreads / 32) {
    float* sr = s + r * t;
    const float* pr = ps + r * t;
    float dot = 0.f;
    for (int j = lane; j < t; j += 32) dot += sr[j] * pr[j];
    dot = warp_sum(dot);
    for (int j = lane; j < t; j += 32)
      sr[j] = round_to<T>(pr[j] * (sr[j] - dot) * inv);
  }
  __syncthreads();

  // dq[i] = sum_j ds[i, j] k[j];  dk[j] = sum_i ds[i, j] q[i]
  for (int i = tid; i < t * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    float aq = 0.f, ak = 0.f;
    for (int j = 0; j < t; ++j) {
      aq = fmaf(s[r * t + j], k[j * kQkvLd + d], aq);
      ak = fmaf(s[j * t + r], q[j * kQkvLd + d], ak);
    }
    T* dst = dqkv + (row0 + r) * 3 * h + head * kDHead + d;
    dst[0] = from_f32<T>(aq);
    dst[h] = from_f32<T>(ak);
  }
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ p,
                          const T* __restrict__ dout, DropSrc drop_p,
                          unsigned thr, float scale, T* __restrict__ dqkv,
                          int nb, int t, int h, float inv) {
  extern __shared__ float attn_sm[];
  attention_core_bwd_tile<T>(qkv, p, dout, drop_p, thr, scale, dqkv, nb, t, h,
                             inv, blockIdx.x, blockIdx.y, attn_sm);
}

}  // namespace tgfr
