// Device code shared by the port's hand-written Hopper kernels.
//
// Element helpers for the two supported activation types (float and
// __nv_bfloat16), the LayerNorm row passes (the vector row kernels of K1-K6,
// whose backward adds its column sums in the same launch, and the
// whole-tower kernels' tiles on the same rows), a deterministic column sum,
// the GEMM core with fused epilogues (wgmma for bf16), and the
// per-(caption, head) attention blocks.
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
#include <mutex>
#include <type_traits>
#include <cuda/atomic>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The C entry points of each library: the one symbol set it exports. Every
// source is built with hidden visibility (ops/_cuda.py), so the template
// kernels that two libraries both instantiate never resolve to the other
// library's copy once both are loaded into one process.
#define TGFR_API extern "C" __attribute__((visibility("default")))

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

// Block q of the stream `key`: Philox of counter (lo32(q), hi32(q), 0, 0)
// under the key (key, 0), words 4 q .. 4 q + 3; and word k of a block.
__device__ __forceinline__ uint4 philox_block(unsigned key,
                                              unsigned long long q) {
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(q), static_cast<unsigned>(q >> 32),
                 0u, 0u), key, 0u);
}

__device__ __forceinline__ unsigned block_word(const uint4& r, unsigned k) {
  switch (k & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

// Word i of the stream `key`: word i & 3 of block i >> 2. An element that
// computes its own block keeps one of its four words: 4x the ALU work of a
// dump, in exchange for no state shared between threads (DropSrc::bits_run
// shares a block between the consecutive words one thread reads).
__device__ __forceinline__ unsigned philox_word(unsigned key,
                                                unsigned long long i) {
  return block_word(philox_block(key, i >> 2), static_cast<unsigned>(i));
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
  // bit(i) .. bit(i + N - 1), one Philox block for every four words of the
  // stream they span (the same words as bit()).
  template <int N>
  __device__ __forceinline__ void bits_run(size_t i,
                                           unsigned (&out)[N]) const {
    if (bits) {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = bits[i + j];
      return;
    }
    const unsigned key = static_cast<unsigned>(__ldg(seed)) + key_add;
    const unsigned long long w0 = base + i;
    uint4 r = philox_block(key, w0 >> 2);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned long long w = w0 + j;
      if (j > 0 && (w & 3) == 0) r = philox_block(key, w >> 2);
      out[j] = block_word(r, static_cast<unsigned>(w));
    }
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

constexpr int kLnPerLane = 32;
constexpr int kLnMaxWidth = 32 * kLnPerLane;   // a row a warp, <= 32 a lane

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
// - The row sums are those of the earlier warp-per-row tiles (lane l held
//   elements l, l + 32, ... in registers), in their order: lane l adds
//   elements l, l + 32, ..., read back from a copy of
//   the row in a staging buffer in shared memory (no bank conflicts), the
//   mean first, then the centred variance (the backward then sum dxhat and
//   sum dxhat xhat), and each output is the tile's expression, rounded
//   once: the arithmetic of K7 and K8, whose LN tiles (below) run these
//   rows too (chip_smoke.py holds the K5/K3 chain against K7), and of the
//   earlier K1 and K2. Adding in another order would move bf16 outputs by
//   a rounding step here and there, and the chains apart from the towers.
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
// - The counters (16 words, 0 between calls) belong to the stream the call
//   launches on (ops/layernorm.py makes them per device and stream), so
//   LN backward calls (K2, K4, K6) on two streams of one device may run at
//   once; launches on one stream run in order and never meet in them.
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

// VEC values at p (an affine parameter: f32 masters, or G = T where the
// caller holds them rounded) as f32, rounded to T with ROUND: as 16-byte
// loads where VEC elements of G fill them (p 16-byte aligned).
template <int VEC, typename T, bool ROUND, typename G>
__device__ __forceinline__ void ld_param(const G* p, float (&v)[VEC]) {
  if constexpr (std::is_same<G, float>::value && VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + j));
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else if constexpr (VEC * sizeof(G) == 16) {
    unpack_vec<VEC, G>(__ldg(reinterpret_cast<const uint4*>(p)), v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(p[j]);
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

// One row of K1 (and of the tower's LN tiles) by one warp: y = LN(x) with
// gamma and beta in registers, VPL vectors of VEC elements a lane. Device
// memory moves as 16-byte vectors (lane l: vectors l, l + 32, ...); the row
// statistics are the earlier warp-per-row tile's sums, in its order (lane l
// adds elements l, l + 32, ... read back from the warp's staging buffer
// `buf`, 32 VEC VPL elements), and y is its expression.
template <typename T, int VEC, int VPL>
__device__ __forceinline__ void ln_fwd_row(const T* xr,
                                           const float (&g)[VPL][VEC],
                                           const float (&b)[VPL][VEC],
                                           T* yr, int h, float eps, int lane,
                                           T* buf) {
  constexpr int J = VEC * VPL;
  const int nv = h / VEC;
  float v[VPL][VEC];
  uint4 u[VPL];
  ln_fetch<VEC, VPL>(xr, u, v, lane, nv);
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

// K1's kernel: two-warp blocks, a row a warp, gamma and beta loaded once
// into registers for every row the warp walks.
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
  for (int row = blockIdx.x * kLnFwdWarps + warp; row < rows;
       row += gridDim.x * kLnFwdWarps)
    ln_fwd_row<T, VEC, VPL>(x + (size_t)row * h, g, b, y + (size_t)row * h,
                            h, eps, lane, stage[warp]);
}

// K2's kernel (block_pallas.py `_ln_bwd_f32`, layernorm_pallas.py
// `_bwd_kernel`), statistics recomputed from the pre-LN input x:
//   xhat = (x - mean) rs,  dxhat = dy g,
//   dx = rs (dxhat - mean(dxhat) - xhat mean(dxhat xhat))   (f32)
// stored rounded to T; with `dxd` (the half-layers with dropout) also
// dxd = drop(r(dx)), the bit of element (row, i) being drop.bit(row h + i).
// As in K1's kernel, the four row sums are the earlier warp-per-row tile's,
// in its order, and dx is its expression. sums (NQ h) f32 = [sum dy xhat |
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
// LayerNorm tiles of the whole-tower kernels (tower_block.cu: K7, K8), on
// the vector rows of K1/K2: tile t is rows t WARPS .. t WARPS + WARPS - 1,
// one a warp, gamma and beta of type T as the tower holds them (rounded
// once, so no ROUND here). Rows, gamma and beta 16-byte aligned with h a
// multiple of 16 / sizeof(T) and h <= kLnMaxWidth (the tower's h is a
// multiple of 64). The sums are the earlier warp-per-row tiles', in their
// order (the staging buffers), so the tiles give the half-layer kernels'
// values bit for bit.
// ---------------------------------------------------------------------------

// Calls f(VPL) (as std::integral_constant) for the 16-byte vectors a lane
// that cover h, in device code.
template <typename T, int N = 1, typename F>
__device__ __forceinline__ void ln_vec_dispatch(int h, F&& f) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (N * 32 * V >= kLnMaxWidth) {
    f(std::integral_constant<int, N>{});
  } else {
    if ((h / V + 31) / 32 <= N)
      f(std::integral_constant<int, N>{});
    else
      ln_vec_dispatch<T, N + 1>(h, f);
  }
}

// Shared memory of the tiles' staging buffers: WARPS rows of x and of dy
// at the widest h.
template <typename T, int WARPS>
__host__ __device__ constexpr size_t ln_tile_stage_bytes() {
  return (size_t)WARPS * 2 * kLnMaxWidth * sizeof(T);
}

// y = LN(x) over the tile's rows; stage: ln_tile_stage_bytes bytes.
template <typename T, int WARPS>
__device__ __forceinline__ void
layernorm_rows_tile(const T* x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* y, int rows, int h,
                    float eps, int tile, T* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  if (row >= rows) return;
  ln_vec_dispatch<T>(h, [&](auto n) {
    constexpr int VEC = 16 / sizeof(T), VPL = decltype(n)::value;
    const int nv = h / VEC;
    float g[VPL][VEC], b[VPL][VEC];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nv) {
        ld_param<VEC, T, false>(gamma + (lane + 32 * k) * VEC, g[k]);
        ld_param<VEC, T, false>(beta + (lane + 32 * k) * VEC, b[k]);
      }
    }
    ln_fwd_row<T, VEC, VPL>(x + (size_t)row * h, g, b, y + (size_t)row * h,
                            h, eps, lane, stage + warp * 2 * 32 * VEC * VPL);
  });
}

// The LN backward over the tile's rows (block_pallas.py `_ln_bwd_f32`),
// statistics recomputed from x: dx = rs (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)) rounded to T; with `dxd` also dxd = drop(r(dx)). The
// tile's column sums [dy xhat | dy | (nq == 3) f32(dxd or dx)] go to row
// `tile` of part (tiles, nq h), f32, its warps added in warp order through
// `red` (3 WARPS kLnMaxWidth floats, all sums at once), for colsum_tile to
// reduce in a fixed order. The row sums re-read the staging buffers in the
// earlier tile's layout rather than hold it in registers. stage:
// ln_tile_stage_bytes bytes.
template <typename T, int WARPS>
__device__ __forceinline__ void
layernorm_bwd_rows_tile(const T* dy, const T* x, const T* __restrict__ gamma,
                        T* dx, T* dxd, const DropSrc& drop, unsigned thr,
                        float scale, float* part, int nq, int rows, int h,
                        float eps, int tile, float* red, T* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  const bool live = row < rows;
  ln_vec_dispatch<T>(h, [&](auto n) {
    constexpr int VEC = 16 / sizeof(T), VPL = decltype(n)::value;
    constexpr int J = VEC * VPL;
    const int nv = h / VEC;
    T* xbuf = stage + warp * 2 * 32 * J;
    T* dbuf = xbuf + 32 * J;
    // the sums' terms [dy xhat | dy | r] of the row go to this warp's rows
    // of `red` as each vector is done (0 where dead), so no term is held
    // to the end; then the warps are added in warp order
    float* q0 = red + warp * kLnMaxWidth;
    float* q1 = q0 + WARPS * kLnMaxWidth;
    float* q2s = q1 + WARPS * kLnMaxWidth;
    auto put = [&](float* q, int col, const float (&c)[VEC]) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)         // 16-byte stores
        *reinterpret_cast<float4*>(q + col + j) =
            make_float4(c[j], c[j + 1], c[j + 2], c[j + 3]);
    };
    if (live) {
      const size_t r0 = (size_t)row * h;
      float v[VPL][VEC], d[VPL][VEC];
      uint4 ux[VPL], ud[VPL];
      ln_fetch<VEC, VPL>(x + r0, ux, v, lane, nv);
      ln_fetch<VEC, VPL>(dy + r0, ud, d, lane, nv);
      ln_put<VEC, VPL>(xbuf, ux, v, lane, nv);
      ln_put<VEC, VPL>(dbuf, ud, d, lane, nv);
      __syncwarp();
      // the earlier tile's sums, in its order and with its expressions:
      // (sum x, sum dxhat), sum (x - mean)^2, sum dxhat xhat
      float s = 0.f, m1 = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = lane + 32 * j;
        const float g = i < h ? to_f32(gamma[i]) : 0.f;
        s += ln_tile<VEC, VPL>(xbuf, v, j, lane, h);
        m1 += ln_tile<VEC, VPL>(dbuf, d, j, lane, h) * g;
      }
      const float mean = warp_sum(s) / h;
      m1 = warp_sum(m1) / h;
      float q2 = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float c = lane + 32 * j < h
                            ? ln_tile<VEC, VPL>(xbuf, v, j, lane, h) - mean
                            : 0.f;
        q2 += c * c;
      }
      const float rs = rsqrtf(warp_sum(q2) / h + eps);
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = lane + 32 * j;
        const float g = i < h ? to_f32(gamma[i]) : 0.f;
        const float c = lane + 32 * j < h
                            ? ln_tile<VEC, VPL>(xbuf, v, j, lane, h) - mean
                            : 0.f;
        m2 += (ln_tile<VEC, VPL>(dbuf, d, j, lane, h) * g) * (c * rs);
      }
      m2 = warp_sum(m2) / h;
      __syncwarp();                 // the staging reads are done
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int col = (lane + 32 * k) * VEC;
        if (lane + 32 * k >= nv) continue;
        float g[VEC], r[VEC], c0[VEC];
        ld_param<VEC, T, false>(gamma + col, g);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (v[k][j] - mean) * rs;
          r[j] = round_to<T>(rs * (d[k][j] * g[j] - m1 - xh * m2));
          c0[j] = d[k][j] * xh;
        }
        put(q0, col, c0);
        put(q1, col, d[k]);
        st_vec<VEC>(dx + r0 + col, r);
        if (dxd) {
          if (drop.on()) {
            unsigned bits[VEC];
            drop.bits_run<VEC>(r0 + col, bits);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              r[j] = drop_to<T>(r[j], bits[j], thr, scale);
          }
          st_vec<VEC>(dxd + r0 + col, r);
        }
        if (nq == 3) put(q2s, col, r);
      }
    } else {
      float z[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) z[j] = 0.f;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        if (lane + 32 * k >= nv) continue;
        const int col = (lane + 32 * k) * VEC;
        put(q0, col, z);
        put(q1, col, z);
        if (nq == 3) put(q2s, col, z);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq * h; i += WARPS * 32) {
      const int qi = i / h, col = i - qi * h;
      const float* sq = red + qi * WARPS * kLnMaxWidth + col;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += sq[w * kLnMaxWidth];
      part[(size_t)tile * nq * h + i] = s;
    }
    __syncthreads();
  });
}

// a = gelu(f) over n elements (n a multiple of 16 / sizeof(T), both 16-byte
// aligned), grid-stride over 16-byte vectors.
template <typename T>
__device__ __forceinline__ void gelu_rows(const T* f, T* a, size_t n) {
  constexpr int V = 16 / sizeof(T);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / V;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[V];
    unpack_vec<V, T>(reinterpret_cast<const uint4*>(f)[i], v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = gelu_erf(v[j]);
    st_vec<V>(a + i * V, v);
  }
}

// ---------------------------------------------------------------------------
// GEMM: out(M, N) = epilogue(A . B), A (M, K), B (K, N), one output tile per
// call of gemm_tile by the kGemmThreads (one warpgroup) threads of a block.
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
// An f32 weight is rounded to T as it is staged in shared memory, so no
// rounded weight copy ever exists in device memory. Shapes: N a multiple of
// 8 and K of 8 for the K-major operands (the wrappers ask for multiples of
// 64); M, N and K may be ragged against the tile: what lies past them loads
// as zeros and is not stored.
//
// bf16 runs on Hopper's warpgroup MMA (`wgmma.mma_async`, the only way to
// the card's full tensor-core rate), the one core of the tower kernels
// K7/K8 (through their phases); the half-layers K3-K6 run the routes below,
// whose sums are this core's bit for bit, so the tower and the chains of
// half-layers add the same products in the same order:
// - a 64 x BN output tile, BN 48 or 96 (gemm_width), the whole K in each
//   tile, no split-K; at R = 384 token rows the N = 768 GEMMs take 96
//   tiles of 48 columns, where 64-wide tiles gave 72 and left 60 of 132
//   SMs idle;
// - K in steps of 64 (one 128-byte row of bf16), staged in shared memory in
//   wgmma's 128-byte-swizzled layout, K-major for A row-major and for B
//   stored (N, K), MN-major (the descriptor's transpose bit) for A stored
//   (K, M) and for B stored (K, N);
// - a ring of kWgStages stages fed by cp.async (16 bytes a copy, zeros past
//   the edges), all but one in flight while the tensor cores multiply the
//   current one. f32 masters cannot be copied as they are: a thread loads
//   its share of the next stage's f32 weights into registers before the
//   MMAs are issued and stores them rounded while they run. (TMA is not
//   used here: the tower would need a tensor map per operand and layer;
//   cp.async covers every layout with one path.)
// - the accumulators stay in registers and the epilogue reads them there.
// f32 runs an FMA tile (64 x 64, K in steps of 32, every thread an 8x4
// micro-tile, full f32, no TF32) that keeps the f32 variant usable for
// tight checks: wgmma has no full-f32 input.
// Every epilogue keeps the rounding contract at the top of this file.
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

constexpr int kGemmThreads = 128;
constexpr int kBM = 64;        // output rows of a tile (wgmma's M)

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
  int bn;                 // the tile's width (gemm_width, hl_width)
  unsigned thr;           // keep iff bit >= thr
  float scale;            // 1 / (1 - rate)
};

inline __host__ __device__ GemmArgs gemm_args(const void* a, const void* b,
                                              void* out, int m, int n,
                                              int k) {
  GemmArgs p{};
  p.a = a;
  p.b = b;
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  return p;
}

// The epilogue of output element (gm, gn) from its f32 accumulator.
template <typename T, int EPI>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& p, int gm,
                                              int gn, float a) {
  const size_t o = (size_t)gm * p.n + gn;
  if constexpr (EPI == kEpiF32) {
    static_cast<float*>(p.out)[o] = a;
  } else {
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
    static_cast<T*>(p.out)[o] = from_f32<T>(v);
  }
}

// --- f32: the FMA tile -----------------------------------------------------

constexpr int kFmaBN = 64, kFmaBK = 32;
constexpr int kALd = kFmaBK + 8;  // padded leading dims
constexpr int kBLd = kFmaBN + 8;
constexpr int kCLd = kFmaBN + 4;

template <int EPI, int AL, int BL>
__device__ __forceinline__ void gemm_tile_fma(const GemmArgs& p, int tile,
                                              unsigned char* smem) {
  using T = float;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * kALd;
  float* Cs = Bs + kFmaBK * kBLd;
  const T* A = static_cast<const T*>(p.a);
  const int tiles_n = (p.n + kFmaBN - 1) / kFmaBN;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kFmaBN;
  const int tid = threadIdx.x;
  // per thread and K-tile: kAVecs 16-byte vectors of A, kBVecs of B
  constexpr int kAVecs = kBM * kFmaBK / 4 / kGemmThreads;
  constexpr int kBVecs = kFmaBK * kFmaBN / 4 / kGemmThreads;
  uint4 a_reg[kAVecs];
  uint4 b_reg[kBVecs];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (AL == kARowMajor) {    // vectors along k
        const int r = idx / (kFmaBK / 4), c = (idx % (kFmaBK / 4)) * 4;
        const int gm = m0 + r;
        a_reg[l] = gm < p.m && k0 + c < p.k
                       ? *reinterpret_cast<const uint4*>(
                             A + (size_t)gm * p.k + k0 + c)
                       : zero4;
      } else {                   // stored (K, M): vectors along m
        const int r = idx / (kBM / 4), c = (idx % (kBM / 4)) * 4;
        const int gk = k0 + r;
        a_reg[l] = gk < p.k ? *reinterpret_cast<const uint4*>(
                                  A + (size_t)gk * p.m + m0 + c)
                            : zero4;
      }
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      const float* B = static_cast<const float*>(p.b);
      if (BL == kBWeightNK || BL == kBActNK) {  // 4 consecutive k of one n
        const int c = idx / (kFmaBK / 4), r = (idx % (kFmaBK / 4)) * 4;
        b_reg[l] = n0 + c < p.n && k0 + r < p.k
                       ? *reinterpret_cast<const uint4*>(
                             B + (size_t)(n0 + c) * p.k + k0 + r)
                       : zero4;
      } else {                   // stored (K, N): vectors along n
        const int r = idx / (kFmaBN / 4), c = (idx % (kFmaBN / 4)) * 4;
        const int gk = k0 + r;
        b_reg[l] = gk < p.k && n0 + c < p.n
                       ? *reinterpret_cast<const uint4*>(
                             B + (size_t)gk * p.n + n0 + c)
                       : zero4;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      if (AL == kARowMajor) {
        const int r = idx / (kFmaBK / 4), c = (idx % (kFmaBK / 4)) * 4;
        *reinterpret_cast<uint4*>(&As[r * kALd + c]) = a_reg[l];
      } else {                   // transposed into As (m, k)
        const int r = idx / (kBM / 4), c = (idx % (kBM / 4)) * 4;
        const T* e = reinterpret_cast<const T*>(&a_reg[l]);
#pragma unroll
        for (int q = 0; q < 4; ++q) As[(c + q) * kALd + r] = e[q];
      }
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      const T* e = reinterpret_cast<const T*>(&b_reg[l]);
      if (BL == kBWeightNK || BL == kBActNK) {  // transposed into Bs (k, n)
        const int c = idx / (kFmaBK / 4), r = (idx % (kFmaBK / 4)) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) Bs[(r + q) * kBLd + c] = e[q];
      } else {
        const int r = idx / (kFmaBN / 4), c = (idx % (kFmaBN / 4)) * 4;
        *reinterpret_cast<uint4*>(&Bs[r * kBLd + c]) = b_reg[l];
      }
    }
  };

  // thread (tr, tc) owns rows tr + 8 i (i < 8) and columns 4 tc + j (j < 4)
  const int tr = tid / 16, tc = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < p.k; k0 += kFmaBK) {
    const bool more = k0 + kFmaBK < p.k;
    if (more) load(k0 + kFmaBK);  // in flight while the tile below multiplies
#pragma unroll 4
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr + 8 * i) * kALd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kBLd + 4 * tc + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(tr + 8 * i) * kCLd + 4 * tc + j] = acc[i][j];
  __syncthreads();
  for (int i = tid; i < kBM * kFmaBN; i += kGemmThreads) {
    const int r = i / kFmaBN, c = i % kFmaBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < p.m && gn < p.n)
      gemm_epilogue<T, EPI>(p, gm, gn, Cs[r * kCLd + c]);
  }
}

// --- bf16: the wgmma core --------------------------------------------------

// Two consecutive bf16 at p (4-byte aligned) as f32, and two f32 rounded to
// bf16 as the 4 bytes that hold them, low first.
__device__ __forceinline__ void unpack_pair(const unsigned* p, float (&v)[2]) {
  const unsigned w = *p;
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ unsigned pack_pair(const float (&v)[2]) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[0]))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v[1])))
             << 16;
}

constexpr int kWgBK = 64;              // K step: one 128-byte row of bf16
constexpr int kWgStages = 3;           // the cp.async ring
constexpr int kWgAtom = 64 * 128;      // 64 swizzled rows of 128 bytes
// The tile widths, widest first: 96 and 48. (72 and 128 were tried too, and
// 128's 64 accumulators a thread add to the register pressure of the
// whole-tower kernels.)
__host__ __device__ constexpr int wg_width(int i) { return i == 0 ? 96 : 48; }

template <int BN> __host__ __device__ constexpr int wg_stage_bytes() {
  return kWgAtom + ((BN + 63) / 64) * kWgAtom;   // A, then B
}

// Dynamic shared memory of a tile of width bn: the ring, and 1 KB to align
// it to the swizzle's 1024-byte period.
inline __host__ __device__ size_t wg_smem_bytes(int bn) {
  return 1024 + (size_t)kWgStages * (kWgAtom + ((bn + 63) / 64) * kWgAtom);
}

template <typename T> inline __host__ __device__ size_t gemm_smem_bytes(
    int bn) {
  if constexpr (std::is_same<T, float>::value) {
    return (kBM * kALd + kFmaBK * kBLd + kBM * kCLd) * sizeof(float);
  } else {
    return wg_smem_bytes(bn);
  }
}

// The widest tile any GEMM of T may take (the tower sizes its memory so).
template <typename T> inline __host__ __device__ size_t gemm_smem_bytes() {
  return gemm_smem_bytes<T>(wg_width(0));
}

// The tile width of an (m, n) GEMM of T: for bf16 48 columns, and 96 where
// the output is at least twice as tall as wide (the weight gradients of
// Wqkv and W1, whose 2304 or 3072 rows the narrower tiles would read twice
// as often); f32: 64. Chosen from the whole-tower kernels' phase table on
// the H100 (chip_smoke.py; PERF.md, PR 6): 48-wide tiles took 25 us of the
// W1 phase where widths chosen by wave counts took 41, and 96 took 44.5 us
// of the dx + dWqkv phase where 48 took 53.9.
template <typename T>
inline __host__ __device__ int gemm_width(int m, int n) {
  if constexpr (std::is_same<T, float>::value) {
    return kFmaBN;
  } else {
    return m >= 2 * n ? wg_width(0) : wg_width(1);
  }
}

inline __host__ __device__ int gemm_tiles(const GemmArgs& p) {
  return ((p.m + kBM - 1) / kBM) * ((p.n + p.bn - 1) / p.bn);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma reads its operands through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's MMA groups are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled atom (rows
// of 128 bytes, chunk c stored at c ^ (r % 8); the atom 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (K-major: the stride between 8-row groups
// in sbo, lbo unused; MN-major: the stride between 64-element atoms along
// M or N in lbo, between 8-row groups along K in sbo).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (64 x N, f32, in registers) += A (64 x 16) . B (16 x N), bf16 operands
// from shared memory; TA / TB: 1 where the operand is MN-major.
template <int N> struct Wgmma;

template <> struct Wgmma<48> {
  template <int TA, int TB>
  __device__ static void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <> struct Wgmma<64> {
  template <int TA, int TB>
  __device__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <> struct Wgmma<72> {
  template <int TA, int TB>
  __device__ static void mma(float (&d)[36], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, %39, %40;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <> struct Wgmma<96> {
  template <int TA, int TB>
  __device__ static void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <> struct Wgmma<128> {
  template <int TA, int TB>
  __device__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// The epilogue of a 64 x BN wgmma tile at (m0, n0) from its accumulators,
// by the four warps (`warp` 0..3) of the warpgroup that holds them:
// accumulator j of thread (warp w, lane l): row 16 w + l / 4 (+ 8 for
// j % 4 >= 2), column 8 (j / 4) + 2 (l % 4) + j % 2: the thread owns
// column pairs (c, c + 1) of two rows. The epilogue runs in chunks of 2
// column groups: the chunk's operands (bias, residual, pre-activation,
// dropout bits) are all loaded before any of its outputs is stored, so
// the loads are in flight together; the arithmetic is gemm_epilogue's.
template <int EPI, int BN>
__device__ __forceinline__ void wg_epilogue(const GemmArgs& p, int m0,
                                            int n0,
                                            const float (&acc)[BN / 2],
                                            int warp, int lane) {
  using T = __nv_bfloat16;
  const int r0 = m0 + warp * 16 + lane / 4;
  constexpr int kGroups = BN / 8, kChunk = 2;
#pragma unroll
  for (int j0 = 0; j0 < kGroups; j0 += kChunk) {
    float bias[kChunk][2], pre[kChunk][2][2];
    unsigned bit[kChunk][2][2];
    bool hasb = false;
    // in-kernel bits with the stream's blocks aligned to the column groups
    // (base % 4 == 0, N % 4 == 0): lanes l and l ^ 1 own the two halves of
    // one Philox block in each of their two rows, so each computes one
    // row's block and takes the other's from its partner
    bool shared_bits = false;
    if constexpr (EPI == kEpiBiasResidual) {
      shared_bits = p.drop.seed && !p.drop.bits && (p.drop.base & 3) == 0;
      if (shared_bits) {
        const unsigned key =
            static_cast<unsigned>(__ldg(p.drop.seed)) + p.drop.key_add;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = j0 + jj;
          if (j >= kGroups) break;
          const int c = n0 + j * 8 + 2 * (lane % 4), hm = lane & 1;
          const uint4 mine = philox_block(
              key, (p.drop.base + (unsigned long long)(r0 + 8 * hm) * p.n +
                    (c & ~3)) >> 2);
          uint4 other;
          other.x = __shfl_xor_sync(0xffffffffu, mine.x, 1);
          other.y = __shfl_xor_sync(0xffffffffu, mine.y, 1);
          other.z = __shfl_xor_sync(0xffffffffu, mine.z, 1);
          other.w = __shfl_xor_sync(0xffffffffu, mine.w, 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4& blk = h == hm ? mine : other;
            bit[jj][h][0] = block_word(blk, static_cast<unsigned>(c));
            bit[jj][h][1] = block_word(blk, static_cast<unsigned>(c) + 1u);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      if (j >= kGroups) break;
      const int c = n0 + j * 8 + 2 * (lane % 4);
      if (c >= p.n) continue;
      if constexpr (EPI == kEpiBias || EPI == kEpiBiasGelu ||
                    EPI == kEpiBiasResidual) {
        if (p.bias) {
          const float2 b2 = *reinterpret_cast<const float2*>(p.bias + c);
          bias[jj][0] = round_to<T>(b2.x);
          bias[jj][1] = round_to<T>(b2.y);
          hasb = true;
        } else if (p.bias_t) {
          float b2[2];
          unpack_pair(reinterpret_cast<const unsigned*>(
                          static_cast<const T*>(p.bias_t) + c), b2);
          bias[jj][0] = b2[0];
          bias[jj][1] = b2[1];
          hasb = true;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = r0 + 8 * h;
        if (gm >= p.m) continue;
        const size_t o = (size_t)gm * p.n + c;
        if constexpr (EPI == kEpiBiasResidual || EPI == kEpiDgelu) {
          const T* src = static_cast<const T*>(
              EPI == kEpiDgelu ? p.aux : p.resid);
          unpack_pair(reinterpret_cast<const unsigned*>(src + o), pre[jj][h]);
        }
        if constexpr (EPI == kEpiBiasResidual) {
          if (p.drop.on() && !shared_bits) p.drop.bits_run<2>(o, bit[jj][h]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      if (j >= kGroups) break;
      const int c = n0 + j * 8 + 2 * (lane % 4);
      if (c >= p.n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = r0 + 8 * h;
        if (gm >= p.m) continue;
        const size_t o = (size_t)gm * p.n + c;
        float v[2], f[2];             // f: kEpiBiasGelu's pre-activation
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[4 * j + 2 * h + e];
          if constexpr (EPI == kEpiF32) {
            v[e] = a;
          } else {
            v[e] = round_to<T>(a);
            if constexpr (EPI == kEpiDgelu) {
              v[e] *= dgelu_erf(pre[jj][h][e]);
            } else {
              if (hasb) v[e] = round_to<T>(v[e] + bias[jj][e]);
              if constexpr (EPI == kEpiBiasGelu) {
                if (p.out2) f[e] = v[e];
                v[e] = gelu_erf(v[e]);
              }
              if constexpr (EPI == kEpiBiasResidual) {
                if (p.drop.on())
                  v[e] = drop_to<T>(v[e], bit[jj][h][e], p.thr, p.scale);
                v[e] = pre[jj][h][e] + v[e];
              }
            }
          }
        }
        if constexpr (EPI == kEpiBiasGelu) {
          if (p.out2)
            *reinterpret_cast<unsigned*>(static_cast<T*>(p.out2) + o) =
                pack_pair(f);
        }
        if constexpr (EPI == kEpiF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<unsigned*>(static_cast<T*>(p.out) + o) =
              pack_pair(v);
        }
      }
    }
  }
}

// Output tile `tile` (row-major over the (M / 64, N / BN) tile grid) of the
// bf16 GEMM p. smem: wg_smem_bytes(BN) bytes. See the section note.
template <int EPI, int AL, int BL, int BN>
__device__ __forceinline__ void gemm_tile_wg(const GemmArgs& p, int tile,
                                             unsigned char* smem) {
  using T = __nv_bfloat16;
  constexpr bool kAK = AL == kARowMajor;                     // A K-major
  constexpr bool kBK = BL == kBWeightNK || BL == kBActNK;    // B K-major
  constexpr bool kBF32 = BL == kBWeightNK || BL == kBWeightKN;
  constexpr int kSB = wg_stage_bytes<BN>();
  // B's 16-byte chunks a stage: K-major BN rows of 8, MN-major 64 rows of
  // BN / 8
  constexpr int kBChunks = kBK ? BN * 8 : 64 * (BN / 8);
  constexpr int kBPer = (kBChunks + kGemmThreads - 1) / kGemmThreads;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const T* A = static_cast<const T*>(p.a);
  const int tiles_n = (p.n + BN - 1) / BN;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
  const int tid = threadIdx.x;
  const int nk = (p.k + kWgBK - 1) / kWgBK;

  auto load_a = [&](int kt) {
    const uint32_t dst = base + (kt % kWgStages) * kSB;
    const int k0 = kt * kWgBK;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kGemmThreads; ++i) {
      const int q = tid + i * kGemmThreads, r = q >> 3, c = q & 7;
      if constexpr (kAK) {       // rows m, chunks along k
        const int gm = m0 + r, gk = k0 + c * 8;
        const bool v = gm < p.m && gk < p.k;
        cp_async16(dst + swz(r, c), v ? A + (size_t)gm * p.k + gk : A, v);
      } else {                   // stored (K, M): rows k, chunks along m
        const int gk = k0 + r, gm = m0 + c * 8;
        const bool v = gk < p.k && gm < p.m;
        cp_async16(dst + swz(r, c), v ? A + (size_t)gk * p.m + gm : A, v);
      }
    }
  };
  // chunk q of B's stage: its (row, chunk) in the stage and its element
  // (n, k) in B; B MN-major lies in 64-column atoms
  auto b_chunk = [&](int q, int k0, uint32_t& ofs, int& gn, int& gk) {
    if constexpr (kBK) {         // rows n, chunks along k
      const int r = q >> 3, c = q & 7;
      ofs = swz(r, c);
      gn = n0 + r;
      gk = k0 + c * 8;
    } else {                     // rows k, chunks along n
      const int r = q / (BN / 8), cc = q % (BN / 8);
      ofs = (cc >> 3) * kWgAtom + swz(r, cc & 7);
      gn = n0 + cc * 8;
      gk = k0 + r;
    }
  };
  auto b_index = [&](int gn, int gk) -> size_t {
    return kBK ? (size_t)gn * p.k + gk : (size_t)gk * p.n + gn;
  };
  auto load_b = [&](int kt) {    // type T: cp.async
    const T* B = static_cast<const T*>(p.b);
    const uint32_t dst = base + (kt % kWgStages) * kSB + kWgAtom;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kGemmThreads;
      if (kBChunks % kGemmThreads == 0 || q < kBChunks) {
        uint32_t ofs;
        int gn, gk;
        b_chunk(q, kt * kWgBK, ofs, gn, gk);
        const bool v = gn < p.n && gk < p.k;
        cp_async16(dst + ofs, v ? B + b_index(gn, gk) : B, v);
      }
    }
  };
  // f32 masters: 8 floats a chunk into registers, then rounded into smem
  float4 breg[kBF32 ? 2 * kBPer : 1];
  auto fetch_b = [&](int kt) {
    const float* W = static_cast<const float*>(p.b);
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kGemmThreads;
      breg[2 * i] = breg[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kBChunks % kGemmThreads == 0 || q < kBChunks) {
        uint32_t ofs;
        int gn, gk;
        b_chunk(q, kt * kWgBK, ofs, gn, gk);
        if (gn < p.n && gk < p.k) {
          const float4* src =
              reinterpret_cast<const float4*>(W + b_index(gn, gk));
          breg[2 * i] = __ldg(src);
          breg[2 * i + 1] = __ldg(src + 1);
        }
      }
    }
  };
  auto put_b = [&](int kt) {
    unsigned char* dst = gbase + (kt % kWgStages) * kSB + kWgAtom;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kGemmThreads;
      if (kBChunks % kGemmThreads == 0 || q < kBChunks) {
        uint32_t ofs;
        int gn, gk;
        b_chunk(q, kt * kWgBK, ofs, gn, gk);
        const float4 lo = breg[2 * i], hi = breg[2 * i + 1];
        const __nv_bfloat162 w0 = __floats2bfloat162_rn(lo.x, lo.y);
        const __nv_bfloat162 w1 = __floats2bfloat162_rn(lo.z, lo.w);
        const __nv_bfloat162 w2 = __floats2bfloat162_rn(hi.x, hi.y);
        const __nv_bfloat162 w3 = __floats2bfloat162_rn(hi.z, hi.w);
        uint4 u;
        u.x = *reinterpret_cast<const unsigned*>(&w0);
        u.y = *reinterpret_cast<const unsigned*>(&w1);
        u.z = *reinterpret_cast<const unsigned*>(&w2);
        u.w = *reinterpret_cast<const unsigned*>(&w3);
        *reinterpret_cast<uint4*>(dst + ofs) = u;
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // the ring's first kWgStages - 1 stages; one commit group a stage, empty
  // past the last, so that wait_group counts stages
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) {
      load_a(s);
      if constexpr (!kBF32) load_b(s);
    }
    cp_async_commit();
  }
  if constexpr (kBF32) {
    fetch_b(0);
    put_b(0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kWgStages - 2>();   // stage kt has landed (this thread's)
    fence_proxy_async();
    __syncthreads();                  // ... and every thread's; the stage
                                      // read at kt - 1 is free again
    const int kn = kt + kWgStages - 1;
    if (kn < nk) {
      load_a(kn);
      if constexpr (!kBF32) load_b(kn);
    }
    cp_async_commit();
    if constexpr (kBF32) {
      if (kt + 1 < nk) fetch_b(kt + 1);
    }
    const uint32_t a0 = base + (kt % kWgStages) * kSB, b0 = a0 + kWgAtom;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t da = kAK ? wg_desc(a0 + kk * 32, 16, 1024)
                              : wg_desc(a0 + kk * 2048, kWgAtom, 1024);
      const uint64_t db = kBK ? wg_desc(b0 + kk * 32, 16, 1024)
                              : wg_desc(b0 + kk * 2048, kWgAtom, 1024);
      Wgmma<BN>::template mma<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    if constexpr (kBF32) {
      if (kt + 1 < nk) put_b(kt + 1);   // while the MMAs run
    }
    wgmma_wait<0>();
  }

  wg_epilogue<EPI, BN>(p, m0, n0, acc, tid / 32, tid % 32);
}

// Output tile `tile` of the GEMM p (p.bn set by gemm_width), by the
// kGemmThreads threads of a block; smem: gemm_smem_bytes<T>(p.bn) bytes.
template <typename T, int EPI, int AL, int BL>
__device__ __forceinline__ void gemm_tile(const GemmArgs& p, int tile,
                                          unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value) {
    gemm_tile_fma<EPI, AL, BL>(p, tile, smem);
  } else {
    if (p.bn == wg_width(1))
      gemm_tile_wg<EPI, AL, BL, wg_width(1)>(p, tile, smem);
    else
      gemm_tile_wg<EPI, AL, BL, wg_width(0)>(p, tile, smem);
  }
}

template <typename T, int EPI, int AL, int BL>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char gemm_sm[];
  gemm_tile<T, EPI, AL, BL>(p, blockIdx.x, gemm_sm);
}

template <typename T, int EPI, int AL = kARowMajor, int BL = kBWeightNK>
cudaError_t launch_gemm(GemmArgs p, cudaStream_t stream) {
  const auto kernel = gemm_kernel<T, EPI, AL, BL>;
  p.bn = gemm_width<T>(p.m, p.n);
  const size_t smem = gemm_smem_bytes<T>(p.bn);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<gemm_tiles(p), kGemmThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The half-layer GEMM route: the four bf16 GEMMs of the forward half-layers
// K3 (f = x . W1^T + c1 with GELU; r = x + drop(act . W2^T + c2)) and K5
// (qkv = x . Wqkv^T + bqkv; r = x + drop(o . Wo^T + bo)):
//   out (M, N) = epilogue(A . W^T), A (M, K) bf16 row-major, W the f32
//   master (N, K) row-major as nn.Linear keeps it.
//
// Replaces, with the LN rows and the attention blocks, the GEMMs of
// block_pallas.py `_ffn_fwd_kernel` and `_attn_fwd_kernel`.
//
// Bound on the H100: at R = 768, H = 768, I = 3072 the four GEMMs are
// 9.9 GFLOP, 10 us at 989 TFLOP/s. What the core above (one 64 x 48 tile a
// warpgroup) loses besides: every 64-row tile re-reads the whole weight
// from L2 as f32, twice the bytes of bf16; the f32 weights go through the
// MMA warps' registers; loads and MMAs share the warps.
//
// This design:
// - A 128 x BN output tile (BN 48, 96 or 128, hl_width) by two consumer
//   warpgroups of 64 rows each: each staged weight tile feeds 128 rows.
// - One producer warpgroup keeps a ring of HlRing<BN>::kStages stages
//   full, handed over by mbarriers (full: the producer's 128 threads
//   arrive; empty: the consumers' 8 warps), so loads and MMAs run on other
//   warps and overlap.
// - One producer thread asks the Tensor Memory Accelerator for each step:
//   A (bf16) straight into the stage in the 128-byte swizzle, W (f32) into
//   an f32 staging slot, kAhead steps ahead, both completing on the step's
//   `loaded` mbarrier; the producer warpgroup then rounds W to bf16 into
//   the stage's swizzled B. No rounded weight copy exists in device
//   memory, and no MMA warp touches f32. The tensor maps come from
//   cuTensorMapEncodeTiled, reached through the runtime's entry-point
//   lookup, so the build links no -lcuda. (Copies by
//   cp.async from the producer's threads ran at half this speed, and W
//   loaded into the producer's registers instead of the staging slot
//   ran slower too: development runs on the H100.)
// - The consumers run wgmma on the stage (m64nBNk16, K-major both) and keep
//   one group in flight, releasing the stage before it.
// - The epilogue is wg_epilogue, shared with the core above, so every
//   rounding point is the one at the top of this file; each output adds
//   its K steps from 0 in the core's order (the products of the stage are
//   the same bits in every tile shape), which keeps the chain of
//   half-layers equal to the whole-tower kernels.
// ---------------------------------------------------------------------------

constexpr int kHlConsumers = 2;
constexpr int kHlThreads = 128 * (1 + kHlConsumers);
constexpr int kHlBM = 64 * kHlConsumers;

// The ring of a tile width: kStages stages of A (bf16) and W (rounded to
// bf16), and kAhead steps that the copies run ahead of the rounding (f32
// staging slots: kAhead + 1). The producer waits on the release of the
// stage kStages - kAhead steps back, so the consumers keep at least two
// steps of slack; the deepest ring that fits the 227 KB of shared memory.
template <int BN> struct HlRing;
template <> struct HlRing<48> { static constexpr int kStages = 7, kAhead = 3; };
template <> struct HlRing<96> { static constexpr int kStages = 5, kAhead = 2; };
template <> struct HlRing<128> { static constexpr int kStages = 4, kAhead = 1; };

template <int BN> __host__ __device__ constexpr int hl_stage_bytes() {
  return kHlConsumers * kWgAtom + BN * 128;
}

// Dynamic shared memory: 1 KB of alignment, the ring, the f32 staging
// slots (kAhead + 1 of BN x 64 floats).
template <int BN> __host__ __device__ constexpr size_t hl_smem_bytes() {
  return 1024 + (size_t)HlRing<BN>::kStages * hl_stage_bytes<BN>() +
         (size_t)(HlRing<BN>::kAhead + 1) * BN * 256;
}

inline __host__ __device__ int hl_tiles(const GemmArgs& p) {
  return ((p.m + kHlBM - 1) / kHlBM) * ((p.n + p.bn - 1) / p.bn);
}

// The tile width of an (m, n) GEMM, of 128, 96, 48: the one whose waves of
// tiles over the 132 SMs, each wave as long as the bytes a tile stages a K
// step (128 rows of A in bf16, BN of W in f32), take least; the wider on a
// tie. (At R = 768 it picks what the H100 measured fastest of 128, 96, 64
// and 48 for each of K3's and K5's GEMMs: 96 for K3's up GEMM, 48 for its
// down GEMM and for Wo, 128 for Wqkv.)
inline __host__ __device__ int hl_width(int m, int n) {
  const int widths[3] = {128, 96, 48};
  const int rows = (m + kHlBM - 1) / kHlBM;
  int best = widths[0];
  long long best_cost = -1;
  for (int i = 0; i < 3; ++i) {
    const int tiles = rows * ((n + widths[i] - 1) / widths[i]);
    const long long cost =
        (long long)((tiles + 131) / 132) * (2 * kHlBM + 4 * widths[i]);
    if (best_cost < 0 || cost < best_cost) {
      best = widths[i];
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(b))
      : "memory");
}

// This thread's arrival, and `bytes` more of asynchronous copies to wait
// for in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// Waits (acquire) until the phase of parity `parity` of b has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (c0 inner, c1 outer) of a 2-D tensor map into shared memory
// at dst, completing on the mbarrier b.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(b))
      : "memory");
}

// Named barrier `id` among the first `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int EPI, int BN>
__global__ void __launch_bounds__(kHlThreads, 1)
hl_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, GemmArgs p) {
  constexpr int kStages = HlRing<BN>::kStages, kAhead = HlRing<BN>::kAhead;
  extern __shared__ __align__(128) unsigned char hl_sm[];
  __shared__ __align__(8) uint64_t loaded[kStages], full[kStages],
      empty[kStages];
  constexpr int kSB = hl_stage_bytes<BN>();
  constexpr int kSlot = BN * 256;        // an f32 staging slot: BN rows
  constexpr int kBPer = BN * 8 / 128;    // B chunks a producer thread
  const uint32_t raw = smem_u32(hl_sm);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = hl_sm + (base - raw);
  const uint32_t slots = base + kStages * kSB;
  const unsigned char* gslots = gbase + kStages * kSB;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kHlBM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int nk = (p.k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * kHlConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (wg == 0) {
    // producer: step i into stage i % kStages and f32 slot i % (kAhead + 1)
    auto issue = [&](int j) {       // thread 0: the copies of step j
      if (j >= kStages)             // the consumers are done with its stage
        mbar_wait(&empty[j % kStages], ((j / kStages) - 1) & 1);
      uint64_t* bar = &loaded[j % kStages];
      mbar_expect_tx(bar, kHlBM * 128 + kSlot);
      tma_load_2d(base + (j % kStages) * kSB, &map_a, j * kWgBK, m0, bar);
      tma_load_2d(slots + (j % (kAhead + 1)) * kSlot, &map_w, j * kWgBK, n0,
                  bar);
    };
    if (tid == 0)
      for (int j = 0; j < kAhead && j < nk; ++j) issue(j);
    for (int i = 0; i < nk; ++i) {
      // every producer thread is done with step i - 1's f32 slot, which
      // step i + kAhead's copy overwrites
      if (i > 0) named_sync(1, 128);
      if (tid == 0 && i + kAhead < nk) issue(i + kAhead);
      mbar_wait(&loaded[i % kStages], (i / kStages) & 1);
      unsigned char* sb = gbase + (i % kStages) * kSB +
                          kHlConsumers * kWgAtom;
      const unsigned char* sf = gslots + (i % (kAhead + 1)) * kSlot;
#pragma unroll
      for (int u = 0; u < kBPer; ++u) {
        // 16-byte chunk c of row r of B: 8 floats of row r of the slot
        const int q = tid + u * 128, r = q >> 3, c = q & 7;
        const float4 lo = *reinterpret_cast<const float4*>(sf + r * 256 +
                                                           c * 32);
        const float4 hi = *reinterpret_cast<const float4*>(sf + r * 256 +
                                                           c * 32 + 16);
        const __nv_bfloat162 w0 = __floats2bfloat162_rn(lo.x, lo.y);
        const __nv_bfloat162 w1 = __floats2bfloat162_rn(lo.z, lo.w);
        const __nv_bfloat162 w2 = __floats2bfloat162_rn(hi.x, hi.y);
        const __nv_bfloat162 w3 = __floats2bfloat162_rn(hi.z, hi.w);
        uint4 o;
        o.x = *reinterpret_cast<const unsigned*>(&w0);
        o.y = *reinterpret_cast<const unsigned*>(&w1);
        o.z = *reinterpret_cast<const unsigned*>(&w2);
        o.w = *reinterpret_cast<const unsigned*>(&w3);
        *reinterpret_cast<uint4*>(sb + swz(r, c)) = o;
      }
      fence_proxy_async();          // the rounded B, to wgmma's proxy
      mbar_arrive(&full[i % kStages]);
    }
  } else {
    // consumers: rows 64 (wg - 1) .. of the tile
    const int lane = tid % 32;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t a0 = base + s * kSB + (wg - 1) * kWgAtom;
      const uint32_t b0 = base + s * kSB + kHlConsumers * kWgAtom;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        Wgmma<BN>::template mma<0, 0>(acc, wg_desc(a0 + kk * 32, 16, 1024),
                                      wg_desc(b0 + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();                 // step i - 1's MMAs are done
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
    }
    wgmma_wait<0>();
    wg_epilogue<EPI, BN>(p, m0 + 64 * (wg - 1), n0, acc, tid / 32, lane);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*TensorMapEncode)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncode tensor_map_encode() {
  static TensorMapEncode fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncode>(f);
  }
  return fn;
}

// The tensor map of a row-major (rows, cols) matrix at base, boxes of
// box_rows x box_cols; past its edges the copies read zeros.
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                                 size_t elem, const void* base, int rows,
                                 int cols, int box_rows, int box_cols,
                                 CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encode();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The route's launch: p.bn one of 128, 96, 48 (hl_width). Shapes: K
// and N multiples of 8; A and W 16-byte aligned.
template <int EPI>
cudaError_t launch_hl_gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.k % 8 || p.n % 8) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err = tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  2, p.a, p.m, p.k, kHlBM, kWgBK,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.b, p.n,
                      p.k, p.bn, kWgBK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto go = [&](auto kernel, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<hl_tiles(p), kHlThreads, smem, stream>>>(map_a, map_w, p);
    return cudaGetLastError();
  };
  switch (p.bn) {
    case 128: return go(hl_gemm_kernel<EPI, 128>, hl_smem_bytes<128>());
    case 96: return go(hl_gemm_kernel<EPI, 96>, hl_smem_bytes<96>());
    case 48: return go(hl_gemm_kernel<EPI, 48>, hl_smem_bytes<48>());
    default: return cudaErrorInvalidValue;
  }
}

// A forward half-layer GEMM with an f32 master weight (N, K): the route in
// bf16, the FMA tile in f32.
template <typename T, int EPI>
cudaError_t launch_forward_gemm(GemmArgs p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    p.bn = hl_width(p.m, p.n);
    return launch_hl_gemm<EPI>(p, stream);
  } else {
    return launch_gemm<T, EPI>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// The backward GEMM route: the bf16 GEMMs of the half-layer backwards K4
// and K6 on the route's design above (128 x BN tiles by two consumer
// warpgroups on wgmma, a producer warpgroup, TMA copies, mbarrier
// hand-over), in the backward's layouts (HlMode):
//   kHlDgrad  out (M, N) = epilogue(A . W), A (M, K) bf16 row-major, W the
//             f32 master stored (K, N) and used untransposed: the data
//             gradients, K4's df = r(r(dgg . W2) gelu'(f)) and
//             dx = r(dr + r(df . W1)), K6's do = r(dh . Wo) and
//             dx = r(dr + r(dqkv . Wqkv));
//   kHlWgrad  out (M, N) f32 = G^T . X, G stored (K, M) and X stored (K, N),
//             both bf16 activations, K the token rows: the weight gradients
//             dW2, dW1 (K4), dWo, dWqkv (K6) in nn.Linear's (out, in)
//             layout; with `colsum` the tiles of the first column block
//             also sum G's columns over the K rows, the bias gradient (dc1,
//             dbqkv) that a launch of its own used to read G again for.
//
// Replaces, with the LN rows and the attention blocks, the GEMMs of
// block_pallas.py `_ffn_bwd_kernel` and `_attn_bwd_kernel`.
//
// Bound on the H100: at R = 768, H = 768, I = 3072 the eight GEMMs are
// 21.7 GFLOP, 22 us at 989 TFLOP/s. The 64-row core above, which ran them
// before, re-reads the whole weight as f32 for every 64-row tile, through
// the MMA warps' registers, with loads and MMAs on the same warps.
//
// This design, beside the forward route's:
// - kHlDgrad: TMA copies W's f32 box of 64 k-rows x BN columns into a
//   staging slot; the producer warpgroup rounds it to bf16 into the MN-major
//   atoms of 64 columns that the descriptor's transpose bit reads, the
//   layout the core stages W (K, N) in. Width 48 (hl_dgrad_width): on the
//   H100 it beat 96 and 128 at every data gradient of K4 and K6
//   (development runs; the narrow tiles' extra waves cost less than the
//   wide tiles' fewer blocks).
// - kHlWgrad: both operands bf16, so no rounding: one producer thread has
//   TMA copy them straight into MN-major atoms (boxes of 64 x 64) and the
//   consumers wait on the copies themselves. Width 64 or 128
//   (hl_wgrad_width).
// - The operand layouts are the core's for the same GEMM (A K-major and B
//   MN-major for the data gradients, both MN-major for the weight
//   gradients), and each output adds its K steps from 0 in the core's
//   order, so the sums are the core's bit for bit and the chain of
//   half-layer backwards stays in step with the whole-tower kernel K8.
// - The column sums: each consumer thread adds one column's 32 elements of
//   each staged step in row order while the step's MMAs run, the two
//   halves of the 64 rows added last: a fixed order, no atomics.
// - The epilogue is wg_epilogue, so every rounding point is the one at
//   the top of this file.
// ---------------------------------------------------------------------------

enum HlMode { kHlDgrad = 1, kHlWgrad = 2 };

// The ring of a mode and width: kStages stages; kAhead steps the copies
// run ahead of the rounding (kHlDgrad; f32 slots kAhead + 1), none for
// kHlWgrad, whose copies land in the stages themselves.
template <int MODE, int BN> struct HlBwdRing;
template <> struct HlBwdRing<kHlDgrad, 48> {
  static constexpr int kStages = 7, kAhead = 3;
};
template <> struct HlBwdRing<kHlWgrad, 64> {
  static constexpr int kStages = 8, kAhead = 0;
};
template <> struct HlBwdRing<kHlWgrad, 128> {
  static constexpr int kStages = 6, kAhead = 0;
};

template <int BN> __host__ __device__ constexpr int hl_bwd_stage_bytes() {
  return kHlConsumers * kWgAtom + ((BN + 63) / 64) * kWgAtom;
}

// Dynamic shared memory: 1 KB of alignment, the ring, the f32 staging
// slots of kHlDgrad (kAhead + 1 of 64 x BN floats).
template <int MODE, int BN>
__host__ __device__ constexpr size_t hl_bwd_smem_bytes() {
  using Ring = HlBwdRing<MODE, BN>;
  return 1024 + (size_t)Ring::kStages * hl_bwd_stage_bytes<BN>() +
         (MODE == kHlDgrad ? (size_t)(Ring::kAhead + 1) * BN * 256 : 0);
}

// The data gradients' width (see the section note).
constexpr int kHlDgradWidth = 48;

// The tile width of a weight gradient (m, n), of 128 and 64: the one whose
// waves of tiles over the 132 SMs, each as long as the bytes a tile stages
// a K step (128 rows of G and BN of X, bf16), take least; the wider on a
// tie. (At R = 768 it picks what the H100 measured fastest in development
// runs: 128 for dW2, dW1 and dWqkv, 64 for dWo.)
inline __host__ __device__ int hl_wgrad_width(int m, int n) {
  const int rows = (m + kHlBM - 1) / kHlBM;
  const int wide = rows * ((n + 127) / 128), narrow = rows * ((n + 63) / 64);
  return (long long)((narrow + 131) / 132) * (2 * kHlBM + 2 * 64) <
                 (long long)((wide + 131) / 132) * (2 * kHlBM + 2 * 128)
             ? 64
             : 128;
}

// map_a: A (kHlDgrad: (M, K), boxes of 128 x 64; kHlWgrad: G (K, M), boxes
// of 64 x 64); map_w: kHlDgrad W (K, N) f32, boxes of 64 x BN; kHlWgrad X
// (K, N) bf16, boxes of 64 x 64. colsum: kHlWgrad's column sums of G, or
// null.
template <int MODE, int EPI, int BN>
__global__ void __launch_bounds__(kHlThreads, 1)
hl_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, GemmArgs p,
                   float* colsum) {
  constexpr int kStages = HlBwdRing<MODE, BN>::kStages;
  constexpr int kAhead = HlBwdRing<MODE, BN>::kAhead;
  constexpr bool kWg = MODE == kHlWgrad;
  extern __shared__ __align__(128) unsigned char hl_sm[];
  __shared__ __align__(8) uint64_t loaded[kStages], full[kStages],
      empty[kStages];
  __shared__ float csum[kWg ? kHlConsumers : 1][128];
  constexpr int kSB = hl_bwd_stage_bytes<BN>();
  constexpr int kSlot = BN * 256;        // an f32 staging slot: 64 x BN
  constexpr int kBPer = BN * 8 / 128;    // B chunks a producer thread
  constexpr int kBBoxes = (BN + 63) / 64;
  const uint32_t raw = smem_u32(hl_sm);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = hl_sm + (base - raw);
  const uint32_t slots = base + kStages * kSB;
  const unsigned char* gslots = gbase + kStages * kSB;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kHlBM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int nk = (p.k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4 * kHlConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (wg == 0) {
    if constexpr (kWg) {
      // thread 0: every step's copies straight into its stage
      if (tid == 0) {
        for (int j = 0; j < nk; ++j) {
          const int s = j % kStages;
          if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
          mbar_expect_tx(&loaded[s], (kHlConsumers + kBBoxes) * kWgAtom);
          const uint32_t st = base + s * kSB;
#pragma unroll
          for (int c = 0; c < kHlConsumers; ++c)
            tma_load_2d(st + c * kWgAtom, &map_a, m0 + 64 * c, j * kWgBK,
                        &loaded[s]);
#pragma unroll
          for (int c = 0; c < kBBoxes; ++c)
            tma_load_2d(st + (kHlConsumers + c) * kWgAtom, &map_w,
                        n0 + 64 * c, j * kWgBK, &loaded[s]);
        }
      }
    } else {
      // step i into stage i % kStages and f32 slot i % (kAhead + 1)
      auto issue = [&](int j) {     // thread 0: the copies of step j
        if (j >= kStages)           // the consumers are done with its stage
          mbar_wait(&empty[j % kStages], ((j / kStages) - 1) & 1);
        uint64_t* bar = &loaded[j % kStages];
        mbar_expect_tx(bar, kHlBM * 128 + kSlot);
        tma_load_2d(base + (j % kStages) * kSB, &map_a, j * kWgBK, m0, bar);
        tma_load_2d(slots + (j % (kAhead + 1)) * kSlot, &map_w, n0,
                    j * kWgBK, bar);
      };
      if (tid == 0)
        for (int j = 0; j < kAhead && j < nk; ++j) issue(j);
      for (int i = 0; i < nk; ++i) {
        // every producer thread is done with step i - 1's f32 slot, which
        // step i + kAhead's copy overwrites
        if (i > 0) named_sync(1, 128);
        if (tid == 0 && i + kAhead < nk) issue(i + kAhead);
        mbar_wait(&loaded[i % kStages], (i / kStages) & 1);
        unsigned char* sb = gbase + (i % kStages) * kSB +
                            kHlConsumers * kWgAtom;
        const unsigned char* sf = gslots + (i % (kAhead + 1)) * kSlot;
#pragma unroll
        for (int u = 0; u < kBPer; ++u) {
          // columns 8 cc .. of row r (a k) of the slot into the atom of 64
          // columns that holds them
          const int q = tid + u * 128, r = q / (BN / 8), cc = q % (BN / 8);
          const float4 lo = *reinterpret_cast<const float4*>(
              sf + r * (BN * 4) + cc * 32);
          const float4 hi = *reinterpret_cast<const float4*>(
              sf + r * (BN * 4) + cc * 32 + 16);
          const __nv_bfloat162 w0 = __floats2bfloat162_rn(lo.x, lo.y);
          const __nv_bfloat162 w1 = __floats2bfloat162_rn(lo.z, lo.w);
          const __nv_bfloat162 w2 = __floats2bfloat162_rn(hi.x, hi.y);
          const __nv_bfloat162 w3 = __floats2bfloat162_rn(hi.z, hi.w);
          uint4 o;
          o.x = *reinterpret_cast<const unsigned*>(&w0);
          o.y = *reinterpret_cast<const unsigned*>(&w1);
          o.z = *reinterpret_cast<const unsigned*>(&w2);
          o.w = *reinterpret_cast<const unsigned*>(&w3);
          *reinterpret_cast<uint4*>(sb + (cc >> 3) * kWgAtom +
                                    swz(r, cc & 7)) = o;
        }
        fence_proxy_async();          // the rounded B, to wgmma's proxy
        mbar_arrive(&full[i % kStages]);
      }
    }
  } else {
    // consumers: rows 64 (wg - 1) .. of the tile
    const int lane = tid % 32;
    // the column sums: this thread's column and half of the step's rows
    const bool sums = kWg && colsum && n0 == 0;
    const int sc = tid % 64, sh = tid / 64;
    float part = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(kWg ? &loaded[s] : &full[s], (i / kStages) & 1);
      const uint32_t a0 = base + s * kSB + (wg - 1) * kWgAtom;
      const uint32_t b0 = base + s * kSB + kHlConsumers * kWgAtom;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        if constexpr (kWg)
          Wgmma<BN>::template mma<1, 1>(
              acc, wg_desc(a0 + kk * 2048, kWgAtom, 1024),
              wg_desc(b0 + kk * 2048, kWgAtom, 1024));
        else
          Wgmma<BN>::template mma<0, 1>(
              acc, wg_desc(a0 + kk * 32, 16, 1024),
              wg_desc(b0 + kk * 2048, kWgAtom, 1024));
      }
      wgmma_commit();
      if (sums) {                      // while the MMAs run
        const unsigned char* ga = gbase + s * kSB + (wg - 1) * kWgAtom;
#pragma unroll 8
        for (int r = 32 * sh; r < 32 * sh + 32; ++r)
          part += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              ga + swz(r, sc >> 3) + (sc & 7) * 2));
      }
      wgmma_wait<1>();                 // step i - 1's MMAs are done
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
    }
    wgmma_wait<0>();
    if constexpr (kWg) {
      if (sums) {
        csum[wg - 1][tid] = part;
        named_sync(1 + wg, 128);
        const int gm = m0 + 64 * (wg - 1) + sc;
        if (sh == 0 && gm < p.m)
          colsum[gm] = csum[wg - 1][sc] + csum[wg - 1][64 + sc];
      }
    }
    wg_epilogue<EPI, BN>(p, m0 + 64 * (wg - 1), n0, acc, tid / 32, lane);
  }
}

// The backward route's launch in mode MODE: p.bn kHlDgradWidth, or 128 or
// 64 (hl_wgrad_width) for a weight gradient. Shapes: every operand's rows
// a multiple of 16 bytes long (kHlDgrad: K and N multiples of 8; kHlWgrad:
// M and N, and K, the token rows, any); the operands 16-byte aligned.
template <int MODE, int EPI>
cudaError_t launch_hl_bwd_gemm(const GemmArgs& p, float* colsum,
                               cudaStream_t stream) {
  if (p.n % 8 || (MODE == kHlWgrad ? p.m % 8 : p.k % 8))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  cudaError_t err;
  if (MODE == kHlWgrad) {
    err = tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.a, p.k,
                        p.m, kWgBK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = tensor_map_2d(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.b, p.k,
                        p.n, kWgBK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    err = tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.a, p.m,
                        p.k, kHlBM, kWgBK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = tensor_map_2d(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.b, p.k,
                        p.n, kWgBK, p.bn, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return err;
  auto go = [&](auto kernel, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<hl_tiles(p), kHlThreads, smem, stream>>>(map_a, map_w, p,
                                                      colsum);
    return cudaGetLastError();
  };
  if constexpr (MODE == kHlWgrad) {
    switch (p.bn) {
      case 128:
        return go(hl_bwd_gemm_kernel<MODE, EPI, 128>,
                  hl_bwd_smem_bytes<MODE, 128>());
      case 64:
        return go(hl_bwd_gemm_kernel<MODE, EPI, 64>,
                  hl_bwd_smem_bytes<MODE, 64>());
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (p.bn != kHlDgradWidth) return cudaErrorInvalidValue;
    return go(hl_bwd_gemm_kernel<MODE, EPI, kHlDgradWidth>,
              hl_bwd_smem_bytes<MODE, kHlDgradWidth>());
  }
}

// A second stream of the current device, on which the half-layer backwards
// run their weight gradients beside the data gradients (the weight
// gradients' tiles fill the SMs that the data gradients' last wave leaves
// idle, and dW2 / dWo need nothing the data path computes after the LN
// rows): fork(s) has it wait for what s has enqueued, join(s) has s wait
// for what it has enqueued, so the caller's stream sees one ordered call.
// Made at the first call on the device, non-blocking (no implicit order
// with the legacy default stream); inside a CUDA graph capture the fork
// brings it into the capture and the join takes it out again. A mutex
// keeps each record-and-wait pair together across threads.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline std::mutex& side_mutex() {
  static std::mutex mu;
  return mu;
}

inline cudaError_t side_stream(SideStream** out) {
  constexpr int kMaxDevices = 64;
  static SideStream sides[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(side_mutex());
  SideStream& sd = sides[dev];
  if (!sd.stream) {
    cudaStream_t st;
    e = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
    sd.stream = st;
  }
  *out = &sd;
  return cudaSuccess;
}

inline cudaError_t side_fork(SideStream* sd, cudaStream_t s) {
  std::lock_guard<std::mutex> lock(side_mutex());
  const cudaError_t e = cudaEventRecord(sd->fork, s);
  return e == cudaSuccess ? cudaStreamWaitEvent(sd->stream, sd->fork, 0) : e;
}

inline cudaError_t side_join(SideStream* sd, cudaStream_t s) {
  std::lock_guard<std::mutex> lock(side_mutex());
  const cudaError_t e = cudaEventRecord(sd->join, sd->stream);
  return e == cudaSuccess ? cudaStreamWaitEvent(s, sd->join, 0) : e;
}

// A backward data gradient out = epilogue(A . W), W the f32 master stored
// (K, N): the backward route in bf16, the FMA tile in f32.
template <typename T, int EPI>
cudaError_t launch_data_grad(GemmArgs p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    p.bn = kHlDgradWidth;
    return launch_hl_bwd_gemm<kHlDgrad, EPI>(p, nullptr, stream);
  } else {
    return launch_gemm<T, EPI, kARowMajor, kBWeightKN>(p, stream);
  }
}

// A backward weight gradient dW (M, N) f32 = G^T X, G stored (K, M), X
// stored (K, N), both type T, contracting over the K token rows; with
// `colsum` (M,) also the column sums of G (the bias gradient): the
// backward route in bf16; in f32 the FMA tile and a column-sum launch.
template <typename T>
cudaError_t launch_weight_grad(const void* g, const void* x, float* dw,
                               float* colsum, int m, int n, int k,
                               cudaStream_t stream) {
  GemmArgs p = gemm_args(g, x, dw, m, n, k);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    p.bn = hl_wgrad_width(m, n);
    return launch_hl_bwd_gemm<kHlWgrad, kEpiF32>(p, colsum, stream);
  } else {
    cudaError_t err =
        launch_gemm<T, kEpiF32, kATransposed, kBActKN>(p, stream);
    if (err != cudaSuccess || !colsum) return err;
    return launch_colsum<T>(static_cast<const T*>(g), k, m, colsum, stream);
  }
}

// ---------------------------------------------------------------------------
// Multi-head self-attention, one block of work per (caption, head), heads of
// width 64, everything of the head in shared memory as f32 (block_pallas.py
// `_attn_heads_fwd`): the scalar forward tile of bf16 K5 with residuals and
// of bf16 K7, up to t = kAttnScalarT (3 (t, 65) + (t, t) f32: 165 KB at
// t = 128). qkv is (B t, 3 h) with q | k | v packed on the output axis,
// head-major within each; probabilities and their dropout bits are
// (heads * B, t, t).
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

// ---------------------------------------------------------------------------
// The attention forward on tensor cores (bf16 K5 without residuals: the
// serving path), block_pallas.py `_attn_heads_fwd`: per (caption, head) pair,
// scores q.k^T / sqrt(64) plus the additive key mask, an f32 softmax,
// probabilities rounded to bf16, dropped with the bits of element
// [head*B + b, i, j], then P.V rounded into the context rows.
//
// Bound on the H100: bytes. At B 32, T 24, 12 heads the scores and P.V are
// 0.057 GFLOP against 3.5 MB of q, k, v and context; the scalar tile above
// (f32 FMA, one block a pair, everything staged as f32) took 21 us inside
// the tower kernel.
//
// This design:
// - q.k^T and P.V run on mma.sync m16n8k16 (bf16 in, f32 accumulation): a
//   warp holds 16 query rows, q in registers as A fragments, and walks the
//   keys in blocks of 64 from shared memory, where k and v of the pair lie
//   as bf16 rows of 72 (144 bytes: the fragment loads and ldmatrix are
//   free of bank conflicts), zero past t.
// - Two passes over the key blocks, so that T is bounded by shared memory
//   (2 x T x 144 bytes a pair: T <= 512, bert-base's position table), not
//   by the registers: first the row maximum and the sum of exp(s - max)
//   (rescaled as the maximum grows), then the normalised probabilities,
//   rounded, saved, dropped and multiplied by v, the P fragments reused as
//   A fragments of P.V (v through ldmatrix.trans).
// - Several pairs a block where the queries are few: 4 warps, and 4, 2 or
//   1 pairs a block (T <= 16, <= 32, longer), each pair's query tiles
//   spread over its warps.
// Up to t = kAttnScalarT the whole-tower kernel K7 keeps the scalar tile
// above (in development runs on the H100 this tile inside it slowed every
// phase of K7, 18 % in all), and so does K5 with residuals, so that the
// training chain of half-layers equals K7 bit for bit; past it both run
// this tile, K7 in an instantiation of its own (csrc/tower_block.cu).
// Keys past t score -inf (no weight); a masked key scores
// s + finfo(float32).min, as the plain version adds it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr int kAttnKeys = 64;           // keys a block of the two passes
constexpr int kAttnLd = kDHead + 8;     // bf16 row stride in shared memory
constexpr int kAttnMaxT = 512;          // this tile's t
// bf16 with residuals (K5, K7): the scalar tile above up to this t, so that
// the training chain of half-layers equals K7 bit for bit; this tile past it
constexpr int kAttnScalarT = 128;

// Pairs a block of the kernel, from t: a pair's 16-row query tiles fill
// its share of the block's 4 warps.
inline __host__ __device__ int attn_pairs_per_block(int t) {
  return t <= 16 ? 4 : (t <= 32 ? 2 : 1);
}

// Shared memory of a block of `pairs` pairs: k and v, t rounded up to 16
// rows of kAttnLd bf16 each, then each pair's additive key biases (f32).
inline __host__ __device__ size_t attn_mma_smem_bytes(int t, int pairs) {
  const size_t tp = (t + 15) / 16 * 16;
  return (size_t)pairs * tp * (2 * kAttnLd * sizeof(__nv_bfloat16) +
                               sizeof(float));
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Pairs pair0 .. pair0 + pairs - 1 (pair = b * heads + head; those at or
// past n_pairs are absent) by the block's kAttnThreads threads; smem:
// attn_mma_smem_bytes(t, pairs) bytes, pairs one of 1, 2, 4. kSaveP: the
// probabilities are also written to p_out, rounded, before dropout (K5
// with residuals past the scalar tile's t).
template <bool kSaveP>
__device__ __forceinline__ void
attention_mma_tile(const __nv_bfloat16* qkv, const int* __restrict__ mask,
                   const DropSrc& drop_p, unsigned thr, float scale,
                   __nv_bfloat16* p_out, __nv_bfloat16* ctx, int nb, int t,
                   int h, float inv, int pair0, int pairs, int n_pairs,
                   unsigned char* smem) {
  using T = __nv_bfloat16;
  const int heads = h / kDHead, tp = (t + 15) / 16 * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpp = (kAttnThreads / 32) / pairs;     // warps a pair
  const int pi = warp / wpp, pair = pair0 + pi;
  const bool live = pair < n_pairs;
  const int b = live ? pair / heads : 0, head = live ? pair % heads : 0;
  const size_t row0 = (size_t)b * t;
  const int g = lane >> 2, tq = lane & 3;
  // q of the warp's query tile qt, rows g and g + 8, as A fragments over
  // the 4 k16 steps of d (rows past t zero)
  unsigned qa[4][4];
  auto load_q = [&](int qt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = qt * 16 + g + 8 * hr;
      const unsigned* q = reinterpret_cast<const unsigned*>(
          qkv + (row0 + (row < t ? row : 0)) * 3 * h + head * kDHead);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qa[kk][hr] = row < t ? q[kk * 8 + tq] : 0u;
        qa[kk][2 + hr] = row < t ? q[kk * 8 + 4 + tq] : 0u;
      }
    }
  };
  if (live) load_q(warp % wpp);           // in flight during the staging
  // k and v of every pair of the block (rows past t zero), a thread's
  // loads of a batch all issued before its stores; the key biases
  T* kv = reinterpret_cast<T*>(smem);
  float* biases = reinterpret_cast<float*>(kv + (size_t)pairs * 2 * tp *
                                                   kAttnLd);
  // the additive bias of key i % tp of pair i / tp: finfo(float32).min on
  // a masked key, -inf past t (no weight); the first 4 a thread loaded
  // beside the first batch of k and v
  auto key_bias = [&](int i) {
    const int pj = i / tp, key = i % tp;
    if (pair0 + pj >= n_pairs || key >= t) return neg_inf();
    return __ldg(mask + (size_t)((pair0 + pj) / heads) * t + key) != 0
               ? 0.f
               : -FLT_MAX;
  };
  float bias0[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = u * kAttnThreads + threadIdx.x;
    bias0[u] = i < pairs * tp ? key_bias(i) : 0.f;
  }
  const int nchunk = pairs * tp * 8;
  for (int i0 = 0; i0 < nchunk; i0 += 4 * kAttnThreads) {
    uint4 kr[4], vr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kAttnThreads + threadIdx.x;
      const int pj = i / (tp * 8), r = (i / 8) % tp, c = i % 8;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nchunk && pair0 + pj < n_pairs && r < t) {
        const int bj = (pair0 + pj) / heads, hj = (pair0 + pj) % heads;
        const T* src =
            qkv + ((size_t)bj * t + r) * 3 * h + hj * kDHead + c * 8;
        kr[u] = *reinterpret_cast<const uint4*>(src + h);
        vr[u] = *reinterpret_cast<const uint4*>(src + 2 * h);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kAttnThreads + threadIdx.x;
      if (i < nchunk) {
        const int pj = i / (tp * 8), r = (i / 8) % tp, c = i % 8;
        T* ks = kv + (size_t)pj * 2 * tp * kAttnLd;
        *reinterpret_cast<uint4*>(ks + r * kAttnLd + c * 8) = kr[u];
        *reinterpret_cast<uint4*>(ks + (tp + r) * kAttnLd + c * 8) = vr[u];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = u * kAttnThreads + threadIdx.x;
    if (i < pairs * tp) biases[i] = bias0[u];
  }
  for (int i = 4 * kAttnThreads + threadIdx.x; i < pairs * tp;
       i += kAttnThreads)
    biases[i] = key_bias(i);
  __syncthreads();
  if (!live) return;
  const T* ks = kv + (size_t)pi * 2 * tp * kAttnLd;
  const T* vs = ks + tp * kAttnLd;
  const float* kbias = biases + pi * tp;
  const uint32_t vs_addr = smem_u32(vs);
  const size_t pofs = ((size_t)head * nb + b) * t * t;   // [head*B + b]
  const int nkb = (t + kAttnKeys - 1) / kAttnKeys;

  for (int qt = warp % wpp; qt * 16 < t; qt += wpp) {
    if (qt != warp % wpp) load_q(qt);
    const int rows[2] = {qt * 16 + g, qt * 16 + g + 8};
    // scores of key block kb: s[j][e], key kb * 64 + 8 j + 2 tq + (e & 1),
    // query row rows[e >> 1]
    auto scores = [&](int kb, float (&s)[8][4]) {
      const int k0 = kb * kAttnKeys;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        if (k0 + 8 * j < t) {
          const unsigned* kr = reinterpret_cast<const unsigned*>(
              ks + (k0 + 8 * j + g) * kAttnLd);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_16816(s[j], qa[kk], kr[kk * 8 + tq], kr[kk * 8 + 4 + tq]);
        }
        // the key biases of columns 2 tq, 2 tq + 1 (past the padded rows:
        // no weight)
        const int key = k0 + 8 * j + 2 * tq;
        const float2 kb2 = key < tp
                               ? *reinterpret_cast<const float2*>(kbias + key)
                               : make_float2(neg_inf(), neg_inf());
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * inv + ((e & 1) ? kb2.y : kb2.x);
      }
    };
    // pass 1: each row's maximum and its sum of exp(s - max), the quad of
    // lanes that share a row combined
    // With one key block (t <= 64) the scores stay in s from pass 1 to
    // pass 2, as exp(s - max): the same values pass 2 would recompute.
    float mx[2] = {neg_inf(), neg_inf()}, sum[2] = {0.f, 0.f};
    float s[8][4];
    for (int kb = 0; kb < nkb; ++kb) {
      scores(kb, s);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float bm = neg_inf();
#pragma unroll
        for (int j = 0; j < 8; ++j)           // tiles past t add nothing
          if (kb * kAttnKeys + 8 * j < t)
            bm = fmaxf(bm, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
        const float m = fmaxf(mx[hr], bm);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kb * kAttnKeys + 8 * j < t) {
            const float e0 = expf(s[j][2 * hr] - m);
            const float e1 = expf(s[j][2 * hr + 1] - m);
            add += e0 + e1;
            if (nkb == 1) {
              s[j][2 * hr] = e0;
              s[j][2 * hr + 1] = e1;
            }
          }
        }
        sum[hr] = sum[hr] * expf(mx[hr] - m) + add;
        mx[hr] = m;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    }
    // pass 2: p = r(exp(s - max) / sum), dropped, then P.V
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * kAttnKeys;
      if (nkb > 1) scores(kb, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k0 + 8 * j >= t) {                // past t: p = 0
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
          continue;
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = rows[hr], key = k0 + 8 * j + 2 * tq;
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pv[e] = round_to<T>(
                (nkb > 1 ? expf(s[j][2 * hr + e] - mx[hr]) : s[j][2 * hr + e]) /
                sum[hr]);
          if (kSaveP && row < t && key < t) {  // saved before dropout
            const size_t at = pofs + (size_t)row * t + key;
            p_out[at] = __float2bfloat16(pv[0]);
            if (key + 1 < t) p_out[at + 1] = __float2bfloat16(pv[1]);
          }
          if (row < t && key < t && drop_p.on()) {
            const size_t at = pofs + (size_t)row * t + key;
            unsigned bits[2];
            if (key + 1 < t) {
              drop_p.bits_run<2>(at, bits);
            } else {
              bits[0] = drop_p.bit(at);
              bits[1] = 0u;                  // past t: p = 0 stays 0
            }
            pv[0] = drop_to<T>(pv[0], bits[0], thr, scale);
            pv[1] = drop_to<T>(pv[1], bits[1], thr, scale);
          }
          s[j][2 * hr] = pv[0];
          s[j][2 * hr + 1] = pv[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + 16 * kk >= t) break;
        unsigned pa[4];
        pa[0] = pack_pair({s[2 * kk][0], s[2 * kk][1]});
        pa[1] = pack_pair({s[2 * kk][2], s[2 * kk][3]});
        pa[2] = pack_pair({s[2 * kk + 1][0], s[2 * kk + 1][1]});
        pa[3] = pack_pair({s[2 * kk + 1][2], s[2 * kk + 1][3]});
        // v rows k0 + 16 kk .. + 15 as B fragments of the d tiles 2 dn and
        // 2 dn + 1: matrix lane / 8 = keys + 8 (m & 1), d + 8 (m >> 1)
        const int mi = lane >> 3;
        const uint32_t vrow =
            vs_addr + ((k0 + 16 * kk + (mi & 1) * 8 + (lane & 7)) * kAttnLd +
                       (mi >> 1) * 8) * 2;
#pragma unroll
        for (int dn = 0; dn < 4; ++dn) {
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vrow + dn * 32);
          mma_16816(o[2 * dn], pa, vb[0], vb[1]);
          mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (rows[hr] >= t) continue;
      T* dst = ctx + (row0 + rows[hr]) * h + head * kDHead + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<unsigned*>(dst + 8 * j) =
            pack_pair({o[j][2 * hr], o[j][2 * hr + 1]});
    }
  }
}

template <bool kSaveP>
__global__ void __launch_bounds__(kAttnThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                     const int* __restrict__ mask, DropSrc drop_p,
                     unsigned thr, float scale, __nv_bfloat16* p_out,
                     __nv_bfloat16* ctx, int nb, int t, int h, float inv,
                     int pairs) {
  extern __shared__ __align__(16) unsigned char attn_mma_sm[];
  attention_mma_tile<kSaveP>(qkv, mask, drop_p, thr, scale, p_out, ctx, nb,
                             t, h, inv, blockIdx.x * pairs, pairs,
                             nb * (h / kDHead), attn_mma_sm);
}

// ---------------------------------------------------------------------------
// The f32 attention, forward and backward (K5, K6, K7 and K8 in f32, the
// parity dtype; block_pallas.py `_attn_heads_fwd`, `_attn_heads_bwd`): f32
// FMA, one block of kAttnThreads a (caption, head) pair, the queries and
// the keys walked in strips of 64 rows, so that shared memory holds a few
// (64, 65) f32 strips and tiles whatever t: t goes to 512 (bert-base's
// position table) and past it. Bound on the H100: operations, f32 FMA at
// 67 TFLOP/s (2 t^2 64 a product); the design keeps it simple, as f32 is
// checked, not served: a thread holds a 4 x 8 block of each 64 x 64
// product (its rows 4 rg .. 4 rg + 3, its columns cg + 8 c), so a feature
// step reads 12 values of shared memory for 32 FMAs, free of bank
// conflicts (row stride 65).
// - Forward, per strip of 64 queries: pass 1 walks the key strips for each
//   row's maximum and its sum of exp(s - max) (rescaled as the maximum
//   grows, the 8 lanes of a row combined by shuffles); pass 2 recomputes
//   the same scores, forms p = exp(s - max) / sum (saved before dropout
//   when the backward needs it), drops it into a (64, 65) tile and adds
//   P.V into the thread's 32 context sums.
// - Backward, from p (the saved residual, read back from device memory)
//   and do: per strip of 64 queries, the row sums dot_i = sum_j dp p over
//   the key strips, then ds = p (dp - dot) / sqrt(64) tile by tile and
//   dq += ds . k; then per strip of 64 keys, over the query strips, ds and
//   the dropped p again, dk += ds^T . q and dv += p_drop^T . do. dp is
//   do . v^T dropped like the probabilities; a probability's bit is read
//   where it is used.
// ---------------------------------------------------------------------------

constexpr int kStrip = 64;            // rows of a query or key strip
constexpr int kStripLd = kDHead + 1;  // f32 row stride of a strip or tile
constexpr int kStripEl = kStrip * kStripLd;

// Shared memory of the forward tile: the q, k and v strips, the
// probability tile and the key strip's additive biases, f32.
inline __host__ __device__ size_t attn_strip_fwd_smem_bytes() {
  return (size_t)(4 * kStripEl + kStrip) * sizeof(float);
}

// Shared memory of the backward tile: the q, k, v and do strips, the ds
// and dropped-p tiles, and each query row's dot (t rounded up to 64), f32.
inline __host__ __device__ size_t attn_strip_bwd_smem_bytes(int t) {
  return (size_t)(6 * kStripEl + (t + kStrip - 1) / kStrip * kStrip) *
         sizeof(float);
}

// Rows r0 .. r0 + 63 of a head's (t, 64) slice at src (row stride ld) into
// a strip; rows at or past t zero.
template <typename T>
__device__ __forceinline__ void load_strip(float* dst, const T* src,
                                           size_t ld, int r0, int t) {
  for (int i = threadIdx.x; i < kStrip * kDHead; i += kAttnThreads) {
    const int r = i / kDHead, d = i % kDHead;
    dst[r * kStripLd + d] =
        r0 + r < t ? to_f32(src[(size_t)(r0 + r) * ld + d]) : 0.f;
  }
}

// acc[a][c] = sum_d A[4 rg + a][d] B[cg + 8 c][d]: the thread's block of
// the 64 x 64 product A B^T of two strips.
__device__ __forceinline__ void strip_abt(float (&acc)[4][8], const float* A,
                                          const float* B, int rg, int cg) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDHead; ++d) {
    float av[4], bv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(4 * rg + a) * kStripLd + d];
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = B[(cg + 8 * c) * kStripLd + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_{j < n} P[4 rg + a][j] V[j][cg + 8 c] (kT: P[j][4 rg + a],
// the product P^T V): the thread's block of a tile times a strip.
template <bool kT>
__device__ __forceinline__ void strip_ab(float (&acc)[4][8], const float* P,
                                         const float* V, int n, int rg,
                                         int cg) {
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float pv[4], vv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pv[a] = kT ? P[j * kStripLd + 4 * rg + a]
                 : P[(4 * rg + a) * kStripLd + j];
#pragma unroll
    for (int c = 0; c < 8; ++c) vv[c] = V[j * kStripLd + cg + 8 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
  }
}

// The thread's block of a strip's rows r0 + 4 rg + a (< t), features
// cg + 8 c, into dst (row stride ld).
__device__ __forceinline__ void store_strip(float* dst, size_t ld,
                                            const float (&acc)[4][8], int r0,
                                            int t, int rg, int cg) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 4 * rg + a;
    if (r < t) {
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[(size_t)r * ld + cg + 8 * c] = acc[a][c];
    }
  }
}

// v reduced over the 8 lanes that share a row group (lane bits 0-2).
__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Caption b, head `head`, f32: scores, softmax, the probabilities' dropout
// (bits of element [head*B + b, i, j]) and P.V; p_out (or null) takes the
// probabilities before dropout. smem: attn_strip_fwd_smem_bytes().
__device__ __forceinline__ void
attention_strip_tile(const float* qkv, const int* __restrict__ mask,
                     const DropSrc& drop_p, unsigned thr, float scale,
                     float* p_out, float* ctx, int nb, int t, int h,
                     float inv, int b, int head, float* sm) {
  float* qs = sm;
  float* ks = qs + kStripEl;
  float* vs = ks + kStripEl;
  float* ps = vs + kStripEl;   // (64, 65) dropped probabilities
  float* kb = ps + kStripEl;   // (64) the key strip's biases
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const size_t row0 = (size_t)b * t, ld = 3 * (size_t)h;
  const float* q = qkv + row0 * ld + head * kDHead;
  const size_t pofs = ((size_t)head * nb + b) * t * t;   // [head*B + b]
  // key strip k0 (and its values): the additive bias of a key is 0, or
  // finfo(float32).min where masked, -inf past t (no weight)
  auto load_keys = [&](int k0, bool values) {
    load_strip(ks, q + h, ld, k0, t);
    if (values) load_strip(vs, q + 2 * h, ld, k0, t);
    for (int j = threadIdx.x; j < kStrip; j += kAttnThreads)
      kb[j] = k0 + j >= t ? neg_inf()
              : (mask[row0 + k0 + j] != 0 ? 0.f : -FLT_MAX);
  };
  // the thread's scores of query strip q0 against the staged key strip
  auto scores = [&](float (&s)[4][8]) {
    strip_abt(s, qs, ks, rg, cg);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = s[a][c] * inv + kb[cg + 8 * c];
  };
  for (int q0 = 0; q0 < t; q0 += kStrip) {
    __syncthreads();   // the previous strip is done with every buffer
    load_strip(qs, q, ld, q0, t);
    // pass 1: each row's maximum and its sum of exp(s - max)
    float mx[4], sum[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      mx[a] = neg_inf();
      sum[a] = 0.f;
    }
    for (int k0 = 0; k0 < t; k0 += kStrip) {
      __syncthreads();
      load_keys(k0, false);
      __syncthreads();
      float s[4][8];
      scores(s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float m = neg_inf();
#pragma unroll
        for (int c = 0; c < 8; ++c) m = fmaxf(m, s[a][c]);
        const float mn = fmaxf(mx[a], row8_max(m));
        float add = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) add += expf(s[a][c] - mn);
        sum[a] = sum[a] * expf(mx[a] - mn) + row8_sum(add);
        mx[a] = mn;
      }
    }
    // pass 2: p = exp(s - max) / sum, saved, dropped; o += P.V
    float o[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[a][c] = 0.f;
    for (int k0 = 0; k0 < t; k0 += kStrip) {
      __syncthreads();
      load_keys(k0, true);
      __syncthreads();
      float s[4][8];
      scores(s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = q0 + 4 * rg + a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = k0 + cg + 8 * c;
          float pv = 0.f;
          if (row < t && key < t) {
            const size_t at = pofs + (size_t)row * t + key;
            pv = expf(s[a][c] - mx[a]) / sum[a];
            if (p_out) p_out[at] = pv;
            if (drop_p.on())
              pv = drop_to<float>(pv, drop_p.bit(at), thr, scale);
          }
          ps[(4 * rg + a) * kStripLd + cg + 8 * c] = pv;
        }
      }
      __syncthreads();
      strip_ab<false>(o, ps, vs, min(kStrip, t - k0), rg, cg);
    }
    store_strip(ctx + row0 * h + head * kDHead, h, o, q0, t, rg, cg);
  }
}

__global__ void __launch_bounds__(kAttnThreads)
attention_strip_kernel(const float* __restrict__ qkv,
                       const int* __restrict__ mask, DropSrc drop_p,
                       unsigned thr, float scale, float* __restrict__ p_out,
                       float* __restrict__ ctx, int nb, int t, int h,
                       float inv) {
  extern __shared__ float attn_strip_sm[];
  attention_strip_tile(qkv, mask, drop_p, thr, scale, p_out, ctx, nb, t, h,
                       inv, blockIdx.x, blockIdx.y, attn_strip_sm);
}

// Caption b, head `head`, f32: the per-head backward from p (before
// dropout) and do = d(context), into that head's slices of dqkv. smem:
// attn_strip_bwd_smem_bytes(t).
__device__ __forceinline__ void
attention_strip_bwd_tile(const float* qkv, const float* p, const float* dout,
                         const DropSrc& drop_p, unsigned thr, float scale,
                         float* dqkv, int nb, int t, int h, float inv, int b,
                         int head, float* sm) {
  float* qs = sm;
  float* ks = qs + kStripEl;
  float* vs = ks + kStripEl;
  float* gs = vs + kStripEl;   // do
  float* ds = gs + kStripEl;   // (64, 65) ds, query rows by key columns
  float* pd = ds + kStripEl;   // (64, 65) the dropped probabilities
  float* dot = pd + kStripEl;  // (t) sum_j dp p of each query row
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const size_t row0 = (size_t)b * t, ld = 3 * (size_t)h;
  const float* q = qkv + row0 * ld + head * kDHead;
  const float* g = dout + row0 * h + head * kDHead;
  float* dq = dqkv + row0 * ld + head * kDHead;
  const size_t pofs = ((size_t)head * nb + b) * t * t;
  const bool drop = drop_p.on();
  // element (i, j): p, whether it is kept, and dp (the thread's do . v^T
  // value a), dropped like the probabilities (f32 scale)
  auto prob = [&](int i, int j, float a, float& pr, bool& keep, float& dp) {
    const size_t at = pofs + (size_t)i * t + j;
    pr = p[at];
    keep = !drop || drop_p.bit(at) >= thr;
    dp = drop ? (keep ? a * scale : 0.f) : a;
  };
  // phase A, per query strip: the row sums, then ds and dq = ds . k
  for (int i0 = 0; i0 < t; i0 += kStrip) {
    __syncthreads();
    load_strip(gs, g, h, i0, t);
    float dotr[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < t; j0 += kStrip) {
      __syncthreads();
      load_strip(vs, q + 2 * h, ld, j0, t);
      __syncthreads();
      float a[4][8];
      strip_abt(a, gs, vs, rg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = i0 + 4 * rg + r, j = j0 + cg + 8 * c;
          if (i < t && j < t) {
            float pr, dp;
            bool keep;
            prob(i, j, a[r][c], pr, keep, dp);
            dotr[r] += dp * pr;
          }
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dotr[r] = row8_sum(dotr[r]);
      if (cg == 0) dot[i0 + 4 * rg + r] = dotr[r];
    }
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int j0 = 0; j0 < t; j0 += kStrip) {
      __syncthreads();
      load_strip(vs, q + 2 * h, ld, j0, t);
      load_strip(ks, q + h, ld, j0, t);
      __syncthreads();
      float a[4][8];
      strip_abt(a, gs, vs, rg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = i0 + 4 * rg + r, j = j0 + cg + 8 * c;
          float s = 0.f;
          if (i < t && j < t) {
            float pr, dp;
            bool keep;
            prob(i, j, a[r][c], pr, keep, dp);
            s = pr * (dp - dotr[r]) * inv;
          }
          ds[(4 * rg + r) * kStripLd + cg + 8 * c] = s;
        }
      __syncthreads();
      strip_ab<false>(acc, ds, ks, min(kStrip, t - j0), rg, cg);
    }
    store_strip(dq, ld, acc, i0, t, rg, cg);
  }
  // phase B, per key strip: dk = ds^T . q and dv = p_drop^T . do over the
  // query strips
  for (int j0 = 0; j0 < t; j0 += kStrip) {
    __syncthreads();
    load_strip(ks, q + h, ld, j0, t);
    load_strip(vs, q + 2 * h, ld, j0, t);
    float ak[4][8], av[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) ak[r][c] = av[r][c] = 0.f;
    for (int i0 = 0; i0 < t; i0 += kStrip) {
      __syncthreads();
      load_strip(qs, q, ld, i0, t);
      load_strip(gs, g, h, i0, t);
      __syncthreads();
      float a[4][8];
      strip_abt(a, gs, vs, rg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = i0 + 4 * rg + r, j = j0 + cg + 8 * c;
          float s = 0.f, pdv = 0.f;
          if (i < t && j < t) {
            float pr, dp;
            bool keep;
            prob(i, j, a[r][c], pr, keep, dp);
            s = pr * (dp - dot[i]) * inv;
            pdv = keep ? (drop ? pr * scale : pr) : 0.f;
          }
          ds[(4 * rg + r) * kStripLd + cg + 8 * c] = s;
          pd[(4 * rg + r) * kStripLd + cg + 8 * c] = pdv;
        }
      __syncthreads();
      const int n = min(kStrip, t - i0);
      strip_ab<true>(ak, ds, qs, n, rg, cg);
      strip_ab<true>(av, pd, gs, n, rg, cg);
    }
    store_strip(dq + h, ld, ak, j0, t, rg, cg);
    store_strip(dq + 2 * h, ld, av, j0, t, rg, cg);
  }
}

__global__ void __launch_bounds__(kAttnThreads)
attention_strip_bwd_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ p,
                           const float* __restrict__ dout, DropSrc drop_p,
                           unsigned thr, float scale,
                           float* __restrict__ dqkv, int nb, int t, int h,
                           float inv) {
  extern __shared__ float attn_strip_sm[];
  attention_strip_bwd_tile(qkv, p, dout, drop_p, thr, scale, dqkv, nb, t, h,
                           inv, blockIdx.x, blockIdx.y, attn_strip_sm);
}

// ---------------------------------------------------------------------------
// The per-head attention backward on tensor cores (bf16 K6 at every t, and
// the whole-tower kernel K8's attention phase), block_pallas.py
// `_attn_heads_bwd`: per (caption, head) pair, from the saved probabilities
// p (rounded, before dropout) and do = d(context),
//   dv = p_drop^T . do,  dp = do . v^T (dropped like the probabilities,
//   scaled in f32),  ds = r(p (dp - sum_j dp p) / sqrt(64)),
//   dq = ds . k,  dk = ds^T . q,
// each rounded into the pair's slices of dqkv (B t, 3 h).
//
// Bound on the H100: bytes. At B 32, T 24, 12 heads: 0.11 GFLOP against
// 5.2 MB of q, k, v, do, p and dqkv; the scalar tile it replaced in bf16
// (f32 FMA, everything staged as f32, one block a pair) took 32 us on the
// H100, a quarter of K6 (PERF.md), and held 4 (t, 64) + 2 (t, t) f32, so
// training stopped at t = 64.
//
// This design (mma.sync m16n8k16, bf16 in, f32 accumulation; the fragment
// and ldmatrix scheme of attention_mma_tile above):
// - Phase A, per 16-query tile of a warp: the row sums dot_i = sum_j dp p
//   over the key blocks of 64 (do as A fragments, v from shared memory),
//   then a second pass that forms ds and adds dq = ds . k (k through
//   ldmatrix.trans); dot_i goes to shared memory.
// - Phase B, per 16-key tile of a warp, over the query blocks of 64: first
//   dv += p_drop^T . do, then dp^T = v . do^T, ds^T, dk += ds^T . q, each
//   product's left operand formed in the accumulator layout and reused as
//   A fragments (q and do through ldmatrix.trans); two passes keep fewer
//   registers live, which the whole-tower kernel's cap of 168 needs. At
//   t <= 64 the dv pass needs nothing of phase A, so it runs beside
//   phase A on the pair's warps, and only the dk pass waits for the row
//   sums: one block's chain of dependent steps is what bounds the tile at
//   short t.
// - k and v (phase A), q and do (phase B) lie in shared memory as bf16 rows
//   of 72, all four at once where they fit (t <= kAttnBwdAll4T), else q and
//   do are staged over k and v between the phases. The probabilities with
//   their keep flags (the sign bit of a bf16 p >= 0) are staged beside
//   them, each Philox block drawn once for four words: all of them at
//   t <= 64, else a strip of 64 query rows (phase A) or of 64 key columns
//   (phase B) in turn; so t is bounded by shared memory at
//   2 x t x 144 + 128 t bytes a pair: t <= 512.
// - Two pairs a block where the rows are fewest (attn_bwd_pairs_per_block).
// K6 and K8 run this one function, so the chain of half-layers and the
// whole-tower kernel add the same values in the same order.
// ---------------------------------------------------------------------------

constexpr int kAttnBwdAll4T = 320;   // q, k, v, do all staged at once

inline __host__ __device__ bool attn_bwd_all4(int t) {
  return t <= kAttnBwdAll4T;
}

// Pairs a block of the backward tile, from t: one, so that more blocks
// hide the chain of each (the query and key tiles of a pair fill its 4
// warps from t = 24); two at t <= 16, where one pair has a single query
// tile and a single key tile. (Faster than attn_pairs_per_block's counts
// in K6 and in K8 at t = 24: development runs on the H100.)
inline __host__ __device__ int attn_bwd_pairs_per_block(int t) {
  return t <= 16 ? 2 : 1;
}

// Shared memory of a block of `pairs` pairs of the backward tile: the
// staged rows (four or two (t rounded up to 16, 72) bf16 buffers a pair),
// each pair's row sums (f32), then the probabilities with their keep
// flags (16-bit): at t <= 64 each pair's whole (tp, tp), else a strip of
// 64 query rows or 64 key columns, (64, tp).
inline __host__ __device__ size_t attn_bwd_mma_smem_bytes(int t, int pairs) {
  const size_t tp = (t + 15) / 16 * 16;
  return (size_t)pairs * tp *
             ((attn_bwd_all4(t) ? 4 : 2) * kAttnLd * sizeof(__nv_bfloat16) +
              sizeof(float)) +
         (t <= kAttnKeys ? (size_t)pairs * tp * tp : (size_t)kAttnKeys * tp) *
             sizeof(unsigned short);
}

// A fragments of a 16-row tile whose rows start at `rows` (rows past t
// zero): 16 rows of 64 bf16 at row stride `ld` elements.
__device__ __forceinline__ void load_a_frags(unsigned (&fa)[4][4],
                                             const __nv_bfloat16* rows,
                                             size_t ld, int r0, int t,
                                             int g, int tq) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    const unsigned* src = reinterpret_cast<const unsigned*>(
        rows + (size_t)(row < t ? row : 0) * ld);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fa[kk][hr] = row < t ? src[kk * 8 + tq] : 0u;
      fa[kk][2 + hr] = row < t ? src[kk * 8 + 4 + tq] : 0u;
    }
  }
}

// c[j] (8 column groups of 8) += A (16 x 64, fragments fa) . B^T, B's 64
// rows r0 + 8 j + g at stride kAttnLd in shared memory (K-major B: the
// scores' k, or v and do here); groups past t skipped.
__device__ __forceinline__ void mma_rows(float (&c)[8][4],
                                         const unsigned (&fa)[4][4],
                                         const __nv_bfloat16* bs, int r0,
                                         int t, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
    if (r0 + 8 * j < t) {
      const unsigned* br = reinterpret_cast<const unsigned*>(
          bs + (size_t)(r0 + 8 * j + g) * kAttnLd);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_16816(c[j], fa[kk], br[kk * 8 + tq], br[kk * 8 + 4 + tq]);
    }
  }
}

// o (16 x 64) += A . B, A the 16 x 64 tile c0 .. of `c` (accumulator
// layout, rounded to bf16 as the fragments), B rows r0 .. r0 + 63 of a
// (rows, 64) bf16 matrix at smem address `bs` (stride kAttnLd), through
// ldmatrix.trans; 16-row steps at or past t skipped.
__device__ __forceinline__ void mma_acc_rows(float (&o)[8][4],
                                             const float (&c)[8][4],
                                             uint32_t bs, int r0, int t,
                                             int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (r0 + 16 * kk >= t) break;
    unsigned pa[4];
    pa[0] = pack_pair({c[2 * kk][0], c[2 * kk][1]});
    pa[1] = pack_pair({c[2 * kk][2], c[2 * kk][3]});
    pa[2] = pack_pair({c[2 * kk + 1][0], c[2 * kk + 1][1]});
    pa[3] = pack_pair({c[2 * kk + 1][2], c[2 * kk + 1][3]});
    const uint32_t row =
        bs + ((r0 + 16 * kk + (mi & 1) * 8 + (lane & 7)) * kAttnLd +
              (mi >> 1) * 8) * 2;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, row + dn * 32);
      mma_16816(o[2 * dn], pa, vb[0], vb[1]);
      mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
}

// A 16 x 64 accumulator tile rounded to bf16 into rows r0 + g (+ 8) of dst
// (row stride ld), rows at or past t not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t ld,
                                           const float (&o)[8][4], int r0,
                                           int t, int g, int tq) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= t) continue;
    __nv_bfloat16* d = dst + (size_t)row * ld + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned*>(d + 8 * j) =
          pack_pair({o[j][2 * hr], o[j][2 * hr + 1]});
  }
}

// Pairs pair0 .. pair0 + pairs - 1 (pair = b * heads + head; those at or
// past n_pairs are absent) by the block's kAttnThreads threads; smem:
// attn_bwd_mma_smem_bytes(t, pairs) bytes, pairs one of 1, 2, 4 (1 past
// t = 64: the strips are the block's).
__device__ __forceinline__ void
attention_bwd_mma_tile(const __nv_bfloat16* qkv, const __nv_bfloat16* p,
                       const __nv_bfloat16* dout, const DropSrc& drop_p,
                       unsigned thr, float scale, __nv_bfloat16* dqkv, int nb,
                       int t, int h, float inv, int pair0, int pairs,
                       int n_pairs, unsigned char* smem) {
  using T = __nv_bfloat16;
  const int heads = h / kDHead, tp = (t + 15) / 16 * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpp = (kAttnThreads / 32) / pairs;     // warps a pair
  const int pi = warp / wpp, pair = pair0 + pi;
  const bool live = pair < n_pairs;
  const int b = live ? pair / heads : 0, head = live ? pair % heads : 0;
  const size_t row0 = (size_t)b * t;
  const int g = lane >> 2, tq = lane & 3;
  const bool all4 = attn_bwd_all4(t), whole = t <= kAttnKeys;
  const bool drop = drop_p.on();
  const size_t buf = (size_t)tp * kAttnLd;
  const int nbuf = all4 ? 4 : 2;
  T* sm = reinterpret_cast<T*>(smem);
  float* dots = reinterpret_cast<float*>(sm + (size_t)pairs * nbuf * buf);
  // the probabilities (bf16 bits), the sign bit set where the probability
  // was dropped (p >= 0)
  unsigned short* pks =
      reinterpret_cast<unsigned short*>(dots + (size_t)pairs * tp);
  // rows of every pair of the block into its buffers: k, v (phase A:
  // which 0) at 0 and 1, q, do (phase B: which 1) at 2 and 3, or at 0 and
  // 1 over k and v; rows past t zero
  auto stage = [&](int which) {
    const int nchunk = pairs * tp * 8;
    const int at = all4 ? 2 * which : 0;
    for (int i0 = 0; i0 < nchunk; i0 += 4 * kAttnThreads) {
      uint4 r0v[4], r1v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kAttnThreads + threadIdx.x;
        const int pj = i / (tp * 8), r = (i / 8) % tp, c = i % 8;
        r0v[u] = r1v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nchunk && pair0 + pj < n_pairs && r < t) {
          const int bj = (pair0 + pj) / heads, hj = (pair0 + pj) % heads;
          const size_t row = (size_t)bj * t + r;
          const T* src = qkv + row * 3 * h + hj * kDHead + c * 8;
          if (which == 0) {
            r0v[u] = *reinterpret_cast<const uint4*>(src + h);
            r1v[u] = *reinterpret_cast<const uint4*>(src + 2 * h);
          } else {
            r0v[u] = *reinterpret_cast<const uint4*>(src);
            r1v[u] = *reinterpret_cast<const uint4*>(
                dout + row * h + hj * kDHead + c * 8);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kAttnThreads + threadIdx.x;
        if (i < nchunk) {
          const int pj = i / (tp * 8), r = (i / 8) % tp, c = i % 8;
          T* d = sm + ((size_t)pj * nbuf + at) * buf + r * kAttnLd + c * 8;
          *reinterpret_cast<uint4*>(d) = r0v[u];
          *reinterpret_cast<uint4*>(d + buf) = r1v[u];
        }
      }
    }
  };
  // queries [q0, q0 + nq) x keys [k0, k0 + nk) (clipped to t) of every
  // pair of the block into pks at row stride `stride`, four consecutive
  // keys a thread (one Philox block for every four words in prng mode)
  auto stage_p = [&](int q0, int nq, int k0, int nk, int stride) {
    const int q1 = min(q0 + nq, t), k1 = min(k0 + nk, t);
    const int kg = (k1 - k0 + 3) / 4, per = (q1 - q0) * kg;
    for (int i = threadIdx.x; i < pairs * per; i += kAttnThreads) {
      const int pj = i / per, q = q0 + (i % per) / kg;
      const int k = k0 + (i % kg) * 4, n = min(k1 - k, 4);
      if (pair0 + pj >= n_pairs) continue;
      const int bj = (pair0 + pj) / heads, hj = (pair0 + pj) % heads;
      const size_t at = (((size_t)hj * nb + bj) * t + q) * t + k;
      unsigned bits[4] = {thr, thr, thr, thr};
      if (drop) {
        if (n == 4) {
          drop_p.bits_run<4>(at, bits);
        } else {
          for (int e = 0; e < n; ++e) bits[e] = drop_p.bit(at + e);
        }
      }
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(p) + at;
      unsigned short* dst = pks + (size_t)pj * tp * tp +
                            (size_t)(q - q0) * stride + (k - k0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n)
          dst[e] = static_cast<unsigned short>(
              src[e] | (bits[e] >= thr ? 0u : 0x8000u));
    }
  };
  stage(0);
  if (all4) stage(1);
  if (whole) stage_p(0, t, 0, t, tp);
  __syncthreads();
  const T* pb = sm + (size_t)pi * nbuf * buf;        // this pair's buffers
  const T* ks = pb;
  const T* vs = pb + buf;
  float* pdots = dots + pi * tp;
  const unsigned short* ppk = pks + (size_t)pi * tp * tp;
  const float sc = round_to<T>(scale);
  const int nblk = (t + kAttnKeys - 1) / kAttnKeys, ntile = tp / 16;
  // the staged element (query q, key k), q and k < t: p and its keep flag;
  // (sq0, sk0, stride): the strip's origin and row stride
  int sq0 = 0, sk0 = 0, stride = tp;
  auto prob = [&](int q, int k, bool& keep) -> float {
    const unsigned u = ppk[(q - sq0) * stride + (k - sk0)];
    keep = !(u & 0x8000u);
    return __uint_as_float((u & 0x7FFFu) << 16);
  };

  const T* qs = pb + (all4 ? 2 : 0) * buf;   // q, do: staged by phase B
  const T* dos = qs + buf;

  // query tile qt: the row sums dot over the key blocks, then ds and
  // dq = ds . k (phase A)
  auto a_unit = [&](int qt) {
    unsigned fa[4][4];
    if (all4)
      load_a_frags(fa, dos, kAttnLd, qt * 16, t, g, tq);
    else
      load_a_frags(fa, dout + row0 * h + head * kDHead, h, qt * 16, t, g,
                   tq);
    const int rows[2] = {qt * 16 + g, qt * 16 + g + 8};
    // key block kb: the masked dp in s and p in pv, elements past t zero
    auto block_dp = [&](int kb, float (&s)[8][4], float (&pv)[8][4]) {
      const int k0 = kb * kAttnKeys;
      mma_rows(s, fa, vs, k0, t, g, tq);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rows[e >> 1], key = k0 + 8 * j + 2 * tq + (e & 1);
          float d = 0.f, pr = 0.f;
          if (row < t && key < t) {
            bool keep;
            pr = prob(row, key, keep);
            d = keep ? (drop ? s[j][e] * scale : s[j][e]) : 0.f;
          }
          s[j][e] = d;
          pv[j][e] = pr;
        }
    };
    float dot[2] = {0.f, 0.f};
    float s[8][4], pv[8][4];
    for (int kb = 0; kb < nblk; ++kb) {
      block_dp(kb, s, pv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[e >> 1] += s[j][e] * pv[j][e];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 1);
      dot[hr] += __shfl_xor_sync(0xffffffffu, dot[hr], 2);
      if (tq == 0 && rows[hr] < t) pdots[rows[hr]] = dot[hr];
    }
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kb = 0; kb < nblk; ++kb) {
      if (nblk > 1) block_dp(kb, s, pv);   // one block: still in s, pv
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = round_to<T>(pv[j][e] * (s[j][e] - dot[e >> 1]) * inv);
      mma_acc_rows(o, s, smem_u32(ks), kb * kAttnKeys, t, lane);
    }
    store_rows(dqkv + row0 * 3 * h + head * kDHead, 3 * h, o, qt * 16, t, g,
               tq);
  };
  // key tile kt: dv = p_drop^T . do over the query blocks (needs no row
  // sum), and dk = ds^T . q (after phase A's row sums); c holds p_drop^T,
  // then ds^T, in the accumulator layout (keys x queries)
  auto dv_unit = [&](int kt) {
    const int keys[2] = {kt * 16 + g, kt * 16 + g + 8};
    float acc[8][4], c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int qb = 0; qb < nblk; ++qb) {
      const int q0 = qb * kAttnKeys;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1], qry = q0 + 8 * j + 2 * tq + (e & 1);
          float pd = 0.f;
          if (key < t && qry < t) {
            bool keep;
            const float pr = prob(qry, key, keep);
            pd = drop ? (keep ? round_to<T>(pr * sc) : 0.f) : pr;
          }
          c[j][e] = pd;
        }
      mma_acc_rows(acc, c, smem_u32(dos), q0, t, lane);
    }
    store_rows(dqkv + row0 * 3 * h + 2 * h + head * kDHead, 3 * h, acc,
               kt * 16, t, g, tq);
  };
  auto dk_unit = [&](int kt) {
    const int keys[2] = {kt * 16 + g, kt * 16 + g + 8};
    unsigned fa[4][4];
    if (all4)
      load_a_frags(fa, vs, kAttnLd, kt * 16, t, g, tq);
    else
      load_a_frags(fa, qkv + row0 * 3 * h + 2 * h + head * kDHead, 3 * h,
                   kt * 16, t, g, tq);
    float acc[8][4], c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int qb = 0; qb < nblk; ++qb) {
      const int q0 = qb * kAttnKeys;
      mma_rows(c, fa, dos, q0, t, g, tq);         // dp^T = v . do^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1], qry = q0 + 8 * j + 2 * tq + (e & 1);
          float ds = 0.f;
          if (key < t && qry < t) {
            bool keep;
            const float pr = prob(qry, key, keep);
            const float d = keep ? (drop ? c[j][e] * scale : c[j][e]) : 0.f;
            ds = round_to<T>(pr * (d - pdots[qry]) * inv);
          }
          c[j][e] = ds;
        }
      mma_acc_rows(acc, c, smem_u32(qs), q0, t, lane);
    }
    store_rows(dqkv + row0 * 3 * h + h + head * kDHead, 3 * h, acc, kt * 16,
               t, g, tq);
  };

  if (whole) {
    // everything staged: the query tiles and the key tiles' dv spread over
    // the pair's warps, then the key tiles' dk
    for (int u = warp % wpp; live && u < 2 * ntile; u += wpp) {
      if (u < ntile)
        a_unit(u);
      else
        dv_unit(u - ntile);
    }
    __syncthreads();
    for (int kt = warp % wpp; live && kt < ntile; kt += wpp) dk_unit(kt);
    return;
  }
  // phase A, query block by query block, the block's strip of p staged in
  // turn
  for (int qb = 0; qb < nblk; ++qb) {
    __syncthreads();
    stage_p(qb * kAttnKeys, kAttnKeys, 0, t, tp);
    sq0 = qb * kAttnKeys;
    __syncthreads();
    const int qt_end = min(ntile, (qb + 1) * (kAttnKeys / 16));
    for (int qt = qb * (kAttnKeys / 16) + warp % wpp; live && qt < qt_end;
         qt += wpp)
      a_unit(qt);
  }
  __syncthreads();
  if (!all4) {
    stage(1);
    __syncthreads();
  }
  sq0 = 0;
  stride = kAttnKeys;
  // phase B, key block by key block, the block's strip of p staged in turn
  for (int kb = 0; kb < nblk; ++kb) {
    __syncthreads();
    stage_p(0, t, kb * kAttnKeys, kAttnKeys, kAttnKeys);
    sk0 = kb * kAttnKeys;
    __syncthreads();
    const int kt_end = min(ntile, (kb + 1) * (kAttnKeys / 16));
    for (int kt = kb * (kAttnKeys / 16) + warp % wpp; live && kt < kt_end;
         kt += wpp) {
      dv_unit(kt);
      dk_unit(kt);
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ p,
                         const __nv_bfloat16* __restrict__ dout,
                         DropSrc drop_p, unsigned thr, float scale,
                         __nv_bfloat16* dqkv, int nb, int t, int h, float inv,
                         int pairs) {
  extern __shared__ __align__(16) unsigned char attn_mma_sm[];
  attention_bwd_mma_tile(qkv, p, dout, drop_p, thr, scale, dqkv, nb, t, h,
                         inv, blockIdx.x * pairs, pairs, nb * (h / kDHead),
                         attn_mma_sm);
}

}  // namespace tgfr
