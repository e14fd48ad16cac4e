// Device code shared by the port's hand-written Hopper kernels.
//
// Element helpers for the two supported activation types (float and
// __nv_bfloat16), a tiled GEMM with fused epilogues, and a LayerNorm row
// pass. Each kernel source (layernorm.cu, ffn_block.cu, attn_block.cu)
// includes this header and is built on its own into a shared library with a
// plain C interface (ops/_cuda.py).
//
// Rounding contract (the one the JAX package's Pallas kernels and flax's
// nn.Dense(dtype=...) follow): a GEMM accumulates in f32, its result is
// rounded to the activation type, and only then is the bias (itself
// rounded from the f32 master) added, with the sum rounded again.
#pragma once

#include <cfloat>
#include <cstddef>
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

// ---------------------------------------------------------------------------
// LayerNorm over rows of width h <= kLnMaxWidth: one warp per row, the row
// read once into registers (lane i holds elements i, i + 32, ...), f32
// statistics (mean, then the centred sum of squares), y = (x - mean) *
// rsqrt(var + eps) * gamma + beta. gamma/beta are f32 masters; ROUND_AFFINE
// rounds them to T first, as the half-layer kernels do (block_pallas.py
// casts them to the caller dtype), while the stand-alone LayerNorm uses them
// as they are.
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 256;
constexpr int kLnPerLane = 32;
constexpr int kLnMaxWidth = 32 * kLnPerLane;

template <typename T, bool ROUND_AFFINE>
__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      int rows, int h, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kLnThreads / 32) + warp;
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
    float g = gamma[i], b = beta[i];
    if (ROUND_AFFINE) {
      g = round_to<T>(g);
      b = round_to<T>(b);
    }
    yr[i] = from_f32<T>((v[j] - mean) * rs * g + b);
  }
}

template <typename T, bool ROUND_AFFINE>
cudaError_t launch_layernorm_rows(const T* x, const float* gamma,
                                  const float* beta, T* y, int rows, int h,
                                  float eps, cudaStream_t stream) {
  const int per_block = kLnThreads / 32;
  const int blocks = (rows + per_block - 1) / per_block;
  layernorm_rows_kernel<T, ROUND_AFFINE>
      <<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y, rows, h, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiled GEMM: out(M, N) = epilogue(A(M, K) . W(K, N)).
//
// A is the activation (row-major, type T). W is an f32 master weight stored
// (N, K) row-major, as nn.Linear stores it (the wrappers take its .t() view,
// which has the JAX (K, N) shape); each tile is transposed and rounded to T
// as it is staged in shared memory, so no rounded weight copy ever exists in
// device memory. 64x64 output tile per block, K in steps of
// 32, 4 warps. For bf16 each warp runs 2x2 wmma 16x16x16 tiles with f32
// accumulators; for f32 every thread runs an 8x4 FMA micro-tile (full f32,
// no TF32), which keeps the f32 variant usable for tight checks.
// Tiles move as 16-byte vectors, and the next K-tile is loaded into
// registers while the current one is multiplied, so the loads' latency
// hides behind the tensor-core work. Shapes: N and K multiples of 64, any M
// (the wrappers check).
// ---------------------------------------------------------------------------

enum Epilogue {
  kEpiBias = 0,          // out = r(r(acc) + r(bias))
  kEpiBiasGelu = 1,      // out = r(gelu(r(r(acc) + r(bias))))
  kEpiBiasResidual = 2,  // out = r(resid + r(r(acc) + r(bias)))
};

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;
constexpr int kALd = kBK + 8;  // padded leading dims (wmma wants multiples
constexpr int kBLd = kBN + 8;  // of 8 elements and 32-byte aligned rows)
constexpr int kCLd = kBN + 4;

struct GemmArgs {
  const void* a;       // (M, K), type T
  const float* w;      // (N, K) f32
  const float* bias;   // (N,) f32
  const void* resid;   // (M, N), type T; kEpiBiasResidual only
  void* out;           // (M, N), type T
  int m, n, k;
};

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

template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs p) {
  __shared__ __align__(32) T As[kBM * kALd];
  __shared__ __align__(32) T Bs[kBK * kBLd];
  __shared__ __align__(32) float Cs[kBM * kCLd];
  const T* __restrict__ A = static_cast<const T*>(p.a);
  const float* __restrict__ W = p.w;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;

  // per thread and K-tile: kAVecs 16-byte vectors of A, kBVecs float4 of W
  constexpr int kAPer = 16 / sizeof(T);                  // elements / vector
  constexpr int kAVecs = kBM * kBK / kAPer / kGemmThreads;
  constexpr int kBVecs = kBK * kBN / 4 / kGemmThreads;
  uint4 a_reg[kAVecs];
  float4 b_reg[kBVecs];

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / (kBK / kAPer), c = (idx % (kBK / kAPer)) * kAPer;
      const int gm = m0 + r;
      a_reg[l] = gm < p.m ? *reinterpret_cast<const uint4*>(
                                A + (size_t)gm * p.k + k0 + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {  // 4 consecutive k of one n
      const int idx = tid + l * kGemmThreads;
      const int c = idx / (kBK / 4), r = (idx % (kBK / 4)) * 4;
      b_reg[l] = *reinterpret_cast<const float4*>(
          W + (size_t)(n0 + c) * p.k + k0 + r);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int l = 0; l < kAVecs; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / (kBK / kAPer), c = (idx % (kBK / kAPer)) * kAPer;
      *reinterpret_cast<uint4*>(&As[r * kALd + c]) = a_reg[l];
    }
#pragma unroll
    for (int l = 0; l < kBVecs; ++l) {  // transposed into Bs (k, n)
      const int idx = tid + l * kGemmThreads;
      const int c = idx / (kBK / 4), r = (idx % (kBK / 4)) * 4;
      const float4 v = b_reg[l];
      Bs[(r + 0) * kBLd + c] = from_f32<T>(v.x);
      Bs[(r + 1) * kBLd + c] = from_f32<T>(v.y);
      Bs[(r + 2) * kBLd + c] = from_f32<T>(v.z);
      Bs[(r + 3) * kBLd + c] = from_f32<T>(v.w);
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

  T* __restrict__ out = static_cast<T*>(p.out);
  const T* __restrict__ resid = static_cast<const T*>(p.resid);
  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= p.m || gn >= p.n) continue;
    float v = round_to<T>(round_to<T>(Cs[r * kCLd + c]) +
                          round_to<T>(p.bias[gn]));
    if (EPI == kEpiBiasGelu) v = gelu_erf(v);
    if (EPI == kEpiBiasResidual) v = to_f32(resid[(size_t)gm * p.n + gn]) + v;
    out[(size_t)gm * p.n + gn] = from_f32<T>(v);
  }
}

template <typename T, int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM);
  gemm_kernel<T, EPI><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tgfr
