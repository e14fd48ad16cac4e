// The whole post-LN tower in one kernel each way: forward (K7 of the port)
// and backward (K8). Per layer
//   y = LN(x + drop(Wo . MHSA(x) + bo)),
//   z = LN(y + drop(W2 . gelu(W1 . y + c1) + c2)), the next layer's x.
//
// Replaces: text_guided_face_recognition_tpu/ops/block_pallas.py,
// `_tower_fwd_kernel` reached through `_tower_fwd` (K7) and
// `_tower_bwd_kernel` reached through `_tower_bwd` (K8), the custom VJP of
// `tower_block`. The TPU kernel is one call over a sequential grid of L
// layers with the activation carried in on-chip scratch; its point is one
// kernel crossing each way for the tower instead of one per half-layer.
//
// Design. One launch per pass: a persistent cooperative kernel whose grid
// is no larger than what is resident on the card at once (occupancy of this
// kernel x SM count, asked of the runtime at launch), launched with
// cudaLaunchCooperativeKernel. Every block loops over the tiles of the
// current phase (the `*_tile` device functions of common.cuh, the same ones
// the half-layer kernels K1-K6 launch one per block) and the blocks meet at
// a grid-wide barrier between phases. No on-chip memory spans SMs, so the
// carried activation lives in device memory (1.2 MB in bf16 at 768 rows: it
// stays in the 50 MB L2), and so do the phase outputs; a phase reads what
// other blocks wrote before the barrier with ordinary (coherent) loads. The
// weights arrive stacked (L, ...) and already rounded to the activation
// type T, in nn.Linear's (out, in) layout.
//
// Forward, 7 phases and barriers a layer:
//   (1) qkv = x . Wqkv + bqkv;  (2) per (caption, head): softmax, the
//   probabilities' dropout, P.V -> o;  (3) r1 = x + drop(o . Wo + bo);
//   (4) y = LN(r1);  (5) f = y . W1 + c1, a = gelu(f);
//   (6) r2 = y + drop(a . W2 + c2);  (7) z = LN(r2), written straight into
//   the next layer's input slot (or the output), so no tile reads a row that
//   another block is overwriting.
// Dropout bits: host-drawn (L, ...) stacks, or (prng mode) in-kernel
// Philox from the one seed read through a device pointer: layer j draws
// stream seed + j, its probabilities at words [0, heads B T^2), the
// attention output next and the FFN output after it (ops/philox.py, the
// TPU kernel's prng_seed(seed + j) and draw order); the backward
// regenerates the same words.
// When a gradient is needed the per-layer residuals xin, qkv, p, o, r1, f,
// r2 are kept as (L, ...) buffers; a and y are not (the backward recomputes
// them). Otherwise one layer's worth of scratch is reused and the input
// slot ping-pongs.
//
// Backward, layers L-1 .. 0, 7 phases and barriers a layer, dx carried in
// the output buffer:
//   (1) LN2 backward rows from r2: dr2, dgg = drop(dr2) and the row-group
//       partials of dgamma2, dbeta2, dc2; beside it a = gelu(f) and
//       y = LN(r1) recomputed;
//   (2) the partials summed in a fixed order; dW2 = dgg^T . a;
//       df = r(r(dgg . W2) gelu'(f));
//   (3) dy = r(dr2 + r(df . W1)); dW1 = df^T . y; dc1 = column sums of df;
//   (4) LN1 backward rows from r1: dr1, dh = drop(dr1), partials;
//   (5) the partials summed; dWo = dh^T . o; do = r(dh . Wo);
//   (6) per (caption, head): the attention backward -> dqkv;
//   (7) dx = r(dr1 + r(dqkv . Wqkv)); dWqkv = dqkv^T . x; dbqkv.
// Sums over rows are per-tile f32 partials reduced in a second phase in a
// fixed order: no float atomics, the result is deterministic. Every
// gradient is rounded to T, the stacked leaves' type, as the TPU kernel's
// outputs are (K4 and K6 write f32 weight gradients; in bf16 this is a real
// difference between the tower and the half-layer kernels, kept).
//
// Bound on the H100 at R = 768 rows, H = 768, I = 3072, 12 layers, bf16:
// operations. Forward 12 x 10.9 GFLOP = 131 GFLOP (0.13 ms at 989 TFLOP/s)
// against 170 MB of weights and about as much of residuals; backward twice
// the operations. The tiles are the half-layer kernels' 64 x 64 wmma tiles,
// far from that rate; what this kernel removes is the launches between them.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tgfr;

constexpr int kThreads = 128;  // = kGemmThreads = kAttnThreads
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == kGemmThreads && kThreads == kAttnThreads, "");

// Pointer slots of the C interface (see tgfr_tower_fwd / tgfr_tower_bwd).
enum FwdPtr {
  F_X, F_MASK, F_WQKV, F_BQKV, F_WO, F_BO, F_G1, F_B1, F_W1, F_C1, F_W2, F_C2,
  F_G2, F_B2, F_BITS_P, F_BITS_H, F_BITS_F, F_SEED, F_Z, F_XIN, F_QKV, F_P,
  F_O, F_R1, F_F, F_R2, F_Y, F_A, F_COUNT
};
enum BwdPtr {
  B_DZ, B_MASK, B_XIN, B_QKV, B_P, B_O, B_R1, B_F, B_R2, B_WQKV, B_WO, B_G1,
  B_B1, B_W1, B_W2, B_G2, B_BITS_P, B_BITS_H, B_BITS_F, B_SEED, B_DX,
  B_DWQKV,
  B_DBQKV, B_DWO, B_DBO, B_DG1, B_DB1, B_DW1, B_DC1, B_DW2, B_DC2, B_DG2,
  B_DB2, B_DR, B_DD, B_A, B_Y, B_DF, B_DY, B_DOUT, B_DQKV, B_PART, B_COUNT
};

struct TowerArgs {
  void* p[B_COUNT > F_COUNT ? B_COUNT : F_COUNT];
  long long bits_stride[3];  // elements between two layers' bits p, h, f
  int layers, b, t, h, heads, inter, save;
  unsigned thr;
  float scale, eps;
};

template <typename T> __device__ __forceinline__ T* at(void* base, size_t ofs) {
  return base ? static_cast<T*>(base) + ofs : nullptr;
}

// Layer j's three dropout sources (probabilities, attention output, FFN
// output): the host bits at the layer's stride, or stream seed + j at word
// offsets 0, n_p and n_p + R H.
struct LayerDrop {
  DropSrc p, h, f;
};

__device__ __forceinline__ LayerDrop layer_drop(const TowerArgs& a,
                                                void* const* bits, void* seed,
                                                int j) {
  const unsigned long long n_p = (unsigned long long)a.heads * a.b * a.t * a.t;
  const unsigned long long n_h = (unsigned long long)a.b * a.t * a.h;
  const unsigned long long base[3] = {0, n_p, n_p + n_h};
  DropSrc d[3];
  for (int k = 0; k < 3; ++k)
    d[k] = drop_src(bits[k] ? static_cast<const unsigned*>(bits[k]) +
                                  j * a.bits_stride[k]
                            : nullptr,
                    seed, static_cast<unsigned>(j), base[k]);
  return {d[0], d[1], d[2]};
}

template <typename T, int EPI, int AL, int BL>
__device__ __forceinline__ void run_gemm(const GemmArgs& g, int first,
                                         unsigned char* smem) {
  // this block's share of the phase's work items [first, first + tiles)
  const int n = gemm_tiles(g);
  int w = blockIdx.x;
  if (w < first) w += ((first - w + gridDim.x - 1) / gridDim.x) * gridDim.x;
  for (; w < first + n; w += gridDim.x) {
    gemm_tile<T, EPI, AL, BL>(g, w - first, smem);
    __syncthreads();
  }
}

template <typename TIn, typename T>
__device__ __forceinline__ void run_colsum(const TIn* in, int rows, int cols,
                                           T* out, int first,
                                           unsigned char* smem) {
  const int n = cols / kSumCols;
  int w = blockIdx.x;
  if (w < first) w += ((first - w + gridDim.x - 1) / gridDim.x) * gridDim.x;
  for (; w < first + n; w += gridDim.x) {
    const int c0 = (w - first) * kSumCols;
    colsum_tile<TIn, T, kWarps>(in, rows, cols, c0, out + c0,
                                threadIdx.x % 32, threadIdx.x / 32,
                                reinterpret_cast<float*>(smem));
    __syncthreads();
  }
}

// part (tiles, 3 h) f32 -> s0, s1, s2 (h each) of type T
template <typename T>
__device__ __forceinline__ void run_ln_sums(const float* part, int tiles,
                                            int h, T* s0, T* s1, T* s2,
                                            int first, unsigned char* smem) {
  const int per = h / kSumCols, n = 3 * per;
  int w = blockIdx.x;
  if (w < first) w += ((first - w + gridDim.x - 1) / gridDim.x) * gridDim.x;
  for (; w < first + n; w += gridDim.x) {
    const int q = (w - first) / per, c0 = ((w - first) % per) * kSumCols;
    T* out = (q == 0 ? s0 : (q == 1 ? s1 : s2)) + c0;
    colsum_tile<float, T, kWarps>(part, tiles, 3 * h, q * h + c0, out,
                                  threadIdx.x % 32, threadIdx.x / 32,
                                  reinterpret_cast<float*>(smem));
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tower_fwd_kernel(TowerArgs a) {
  extern __shared__ __align__(32) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = a.b * a.t, h = a.h, inter = a.inter, L = a.layers;
  const size_t act = (size_t)rows * h;
  const size_t p_el = (size_t)a.heads * a.b * a.t * a.t;
  const int ln_tiles = (rows + kWarps - 1) / kWarps;
  const float inv = 1.0f / sqrtf(static_cast<float>(kDHead));
  T* y = static_cast<T*>(a.p[F_Y]);
  T* ab = static_cast<T*>(a.p[F_A]);
  const int* mask = static_cast<const int*>(a.p[F_MASK]);

  for (int j = 0; j < L; ++j) {
    const size_t slot = a.save ? j : 0;         // this layer's residual slot
    const T* x = j == 0 ? static_cast<const T*>(a.p[F_X])
                        : at<T>(a.p[F_XIN], (a.save ? j : (j & 1)) * act);
    T* z = j == L - 1 ? static_cast<T*>(a.p[F_Z])
                      : at<T>(a.p[F_XIN],
                              (a.save ? j + 1 : ((j + 1) & 1)) * act);
    T* qkv = at<T>(a.p[F_QKV], slot * act * 3);
    T* p = at<T>(a.p[F_P], slot * p_el);
    T* o = at<T>(a.p[F_O], slot * act);
    T* r1 = at<T>(a.p[F_R1], slot * act);
    T* f = at<T>(a.p[F_F], slot * rows * inter);
    T* r2 = at<T>(a.p[F_R2], slot * act);
    const LayerDrop ld = layer_drop(a, a.p + F_BITS_P, a.p[F_SEED], j);

    // (1) qkv = x . Wqkv + bqkv; layer 0 also files x as its saved input
    {
      GemmArgs g = gemm_args(x, at<T>(a.p[F_WQKV], (size_t)j * 3 * h * h),
                             qkv, rows, 3 * h, h);
      g.bias_t = at<T>(a.p[F_BQKV], (size_t)j * 3 * h);
      run_gemm<T, kEpiBias, kARowMajor, kBActNK>(g, 0, smem);
      if (j == 0 && a.save) {
        T* x0 = static_cast<T*>(a.p[F_XIN]);
        for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < act;
             i += (size_t)gridDim.x * kThreads)
          x0[i] = x[i];
      }
    }
    grid.sync();
    // (2) attention per (caption, head)
    for (int w = blockIdx.x; w < a.b * a.heads; w += gridDim.x) {
      attention_core_tile<T>(qkv, mask, ld.p, a.thr, a.scale, p, o, a.b, a.t,
                             h, inv, w / a.heads, w % a.heads,
                             reinterpret_cast<float*>(smem));
      __syncthreads();
    }
    grid.sync();
    // (3) r1 = x + drop(o . Wo + bo)
    {
      GemmArgs g = gemm_args(o, at<T>(a.p[F_WO], (size_t)j * h * h), r1, rows,
                             h, h);
      g.bias_t = at<T>(a.p[F_BO], (size_t)j * h);
      g.resid = x;
      g.drop = ld.h;
      g.thr = a.thr;
      g.scale = a.scale;
      run_gemm<T, kEpiBiasResidual, kARowMajor, kBActNK>(g, 0, smem);
    }
    grid.sync();
    // (4) y = LN(r1)
    for (int w = blockIdx.x; w < ln_tiles; w += gridDim.x)
      layernorm_rows_tile<T, T, false, kWarps>(
          r1, at<T>(a.p[F_G1], (size_t)j * h), at<T>(a.p[F_B1], (size_t)j * h),
          y, rows, h, a.eps, w);
    grid.sync();
    // (5) f = y . W1 + c1, a = gelu(f)
    {
      GemmArgs g = gemm_args(y, at<T>(a.p[F_W1], (size_t)j * inter * h), ab,
                             rows, inter, h);
      g.bias_t = at<T>(a.p[F_C1], (size_t)j * inter);
      g.out2 = f;
      run_gemm<T, kEpiBiasGelu, kARowMajor, kBActNK>(g, 0, smem);
    }
    grid.sync();
    // (6) r2 = y + drop(a . W2 + c2)
    {
      GemmArgs g = gemm_args(ab, at<T>(a.p[F_W2], (size_t)j * inter * h), r2,
                             rows, h, inter);
      g.bias_t = at<T>(a.p[F_C2], (size_t)j * h);
      g.resid = y;
      g.drop = ld.f;
      g.thr = a.thr;
      g.scale = a.scale;
      run_gemm<T, kEpiBiasResidual, kARowMajor, kBActNK>(g, 0, smem);
    }
    grid.sync();
    // (7) z = LN(r2)
    for (int w = blockIdx.x; w < ln_tiles; w += gridDim.x)
      layernorm_rows_tile<T, T, false, kWarps>(
          r2, at<T>(a.p[F_G2], (size_t)j * h), at<T>(a.p[F_B2], (size_t)j * h),
          z, rows, h, a.eps, w);
    if (j < L - 1) grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tower_bwd_kernel(TowerArgs a) {
  extern __shared__ __align__(32) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = a.b * a.t, h = a.h, inter = a.inter, L = a.layers;
  const size_t act = (size_t)rows * h;
  const size_t p_el = (size_t)a.heads * a.b * a.t * a.t;
  const int ln_tiles = (rows + kWarps - 1) / kWarps;
  const float inv = 1.0f / sqrtf(static_cast<float>(kDHead));
  float* red = reinterpret_cast<float*>(smem);
  T* dx = static_cast<T*>(a.p[B_DX]);
  T* dr = static_cast<T*>(a.p[B_DR]);
  T* ab = static_cast<T*>(a.p[B_A]);
  T* y = static_cast<T*>(a.p[B_Y]);
  T* df = static_cast<T*>(a.p[B_DF]);
  T* dy = static_cast<T*>(a.p[B_DY]);
  T* dout = static_cast<T*>(a.p[B_DOUT]);
  T* dqkv = static_cast<T*>(a.p[B_DQKV]);
  float* part = static_cast<float*>(a.p[B_PART]);

  for (int j = L - 1; j >= 0; --j) {
    const T* dz = j == L - 1 ? static_cast<const T*>(a.p[B_DZ]) : dx;
    const T* xin = at<T>(a.p[B_XIN], j * act);
    const T* qkv = at<T>(a.p[B_QKV], j * act * 3);
    const T* p = at<T>(a.p[B_P], j * p_el);
    const T* o = at<T>(a.p[B_O], j * act);
    const T* r1 = at<T>(a.p[B_R1], j * act);
    const T* f = at<T>(a.p[B_F], (size_t)j * rows * inter);
    const T* r2 = at<T>(a.p[B_R2], j * act);
    const T* wqkv = at<T>(a.p[B_WQKV], (size_t)j * 3 * h * h);
    const T* wo = at<T>(a.p[B_WO], (size_t)j * h * h);
    const T* w1 = at<T>(a.p[B_W1], (size_t)j * inter * h);
    const T* w2 = at<T>(a.p[B_W2], (size_t)j * inter * h);
    const T* g1 = at<T>(a.p[B_G1], (size_t)j * h);
    const T* b1 = at<T>(a.p[B_B1], (size_t)j * h);
    const T* g2 = at<T>(a.p[B_G2], (size_t)j * h);
    const LayerDrop ld = layer_drop(a, a.p + B_BITS_P, a.p[B_SEED], j);
    // the dropped gradients: a buffer of their own with dropout, else dr
    T* dd_f = ld.f.on() ? static_cast<T*>(a.p[B_DD]) : dr;
    T* dd_h = ld.h.on() ? static_cast<T*>(a.p[B_DD]) : dr;

    // (1) LN2 backward rows; a = gelu(f) and y = LN(r1) recomputed
    for (int w = blockIdx.x; w < ln_tiles; w += gridDim.x)
      layernorm_bwd_rows_tile<T, T, false, kWarps>(
          dz, r2, g2, dr, ld.f.on() ? dd_f : nullptr, ld.f, a.thr, a.scale,
          part, 3, rows, h, a.eps, w, red);
    for (int w = blockIdx.x; w < ln_tiles; w += gridDim.x)
      layernorm_rows_tile<T, T, false, kWarps>(r1, g1, b1, y, rows, h, a.eps,
                                               w);
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
         i < (size_t)rows * inter; i += (size_t)gridDim.x * kThreads)
      ab[i] = from_f32<T>(gelu_erf(to_f32(f[i])));
    grid.sync();
    // (2) dgamma2, dbeta2, dc2; dW2 (h, inter) = dgg^T . a;
    //     df = r(r(dgg . W2) gelu'(f)), W2 stored (h, inter) = (K, N)
    {
      GemmArgs gw = gemm_args(dd_f, ab, at<T>(a.p[B_DW2],
                                               (size_t)j * inter * h),
                              h, inter, rows);
      GemmArgs gd = gemm_args(dd_f, w2, df, rows, inter, h);
      gd.aux = f;
      const int n0 = gemm_tiles(gw), n1 = gemm_tiles(gd);
      run_gemm<T, kEpiBias, kATransposed, kBActKN>(gw, 0, smem);
      run_gemm<T, kEpiDgelu, kARowMajor, kBActKN>(gd, n0, smem);
      run_ln_sums<T>(part, ln_tiles, h, at<T>(a.p[B_DG2], (size_t)j * h),
                     at<T>(a.p[B_DB2], (size_t)j * h),
                     at<T>(a.p[B_DC2], (size_t)j * h), n0 + n1, smem);
    }
    grid.sync();
    // (3) dy = r(dr2 + r(df . W1)), W1 stored (inter, h) = (K, N);
    //     dW1 (inter, h) = df^T . y; dc1
    {
      GemmArgs gx = gemm_args(df, w1, dy, rows, h, inter);
      gx.resid = dr;
      GemmArgs gw = gemm_args(df, y, at<T>(a.p[B_DW1], (size_t)j * inter * h),
                              inter, h, rows);
      const int n0 = gemm_tiles(gx), n1 = gemm_tiles(gw);
      run_gemm<T, kEpiBiasResidual, kARowMajor, kBActKN>(gx, 0, smem);
      run_gemm<T, kEpiBias, kATransposed, kBActKN>(gw, n0, smem);
      run_colsum<T, T>(df, rows, inter, at<T>(a.p[B_DC1], (size_t)j * inter),
                       n0 + n1, smem);
    }
    grid.sync();
    // (4) LN1 backward rows
    for (int w = blockIdx.x; w < ln_tiles; w += gridDim.x)
      layernorm_bwd_rows_tile<T, T, false, kWarps>(
          dy, r1, g1, dr, ld.h.on() ? dd_h : nullptr, ld.h, a.thr, a.scale,
          part, 3, rows, h, a.eps, w, red);
    grid.sync();
    // (5) dgamma1, dbeta1, dbo; dWo (h, h) = dh^T . o; do = r(dh . Wo)
    {
      GemmArgs gw = gemm_args(dd_h, o, at<T>(a.p[B_DWO], (size_t)j * h * h),
                              h, h, rows);
      GemmArgs gd = gemm_args(dd_h, wo, dout, rows, h, h);
      const int n0 = gemm_tiles(gw), n1 = gemm_tiles(gd);
      run_gemm<T, kEpiBias, kATransposed, kBActKN>(gw, 0, smem);
      run_gemm<T, kEpiBias, kARowMajor, kBActKN>(gd, n0, smem);
      run_ln_sums<T>(part, ln_tiles, h, at<T>(a.p[B_DG1], (size_t)j * h),
                     at<T>(a.p[B_DB1], (size_t)j * h),
                     at<T>(a.p[B_DBO], (size_t)j * h), n0 + n1, smem);
    }
    grid.sync();
    // (6) the attention backward per (caption, head)
    for (int w = blockIdx.x; w < a.b * a.heads; w += gridDim.x) {
      attention_core_bwd_tile<T>(qkv, p, dout, ld.p, a.thr, a.scale, dqkv,
                                 a.b, a.t, h, inv, w / a.heads, w % a.heads,
                                 red);
      __syncthreads();
    }
    grid.sync();
    // (7) dx = r(dr1 + r(dqkv . Wqkv)), Wqkv stored (3h, h) = (K, N);
    //     dWqkv (3h, h) = dqkv^T . x; dbqkv
    {
      GemmArgs gx = gemm_args(dqkv, wqkv, dx, rows, h, 3 * h);
      gx.resid = dr;
      GemmArgs gw = gemm_args(dqkv, xin,
                              at<T>(a.p[B_DWQKV], (size_t)j * 3 * h * h),
                              3 * h, h, rows);
      const int n0 = gemm_tiles(gx), n1 = gemm_tiles(gw);
      run_gemm<T, kEpiBiasResidual, kARowMajor, kBActKN>(gx, 0, smem);
      run_gemm<T, kEpiBias, kATransposed, kBActKN>(gw, n0, smem);
      run_colsum<T, T>(dqkv, rows, 3 * h,
                       at<T>(a.p[B_DBQKV], (size_t)j * 3 * h), n0 + n1, smem);
    }
    if (j > 0) grid.sync();
  }
}

size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// Launch `kernel` cooperatively on a grid that is resident at once, no
// larger than `max_tiles`. info[0] = the grid, info[1] = blocks per SM,
// info[2] = the dynamic shared memory in bytes.
template <typename K>
int launch(K kernel, const TowerArgs& a, size_t smem, int max_tiles,
           int* info, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int grid = per_sm * sms;
  if (grid > max_tiles) grid = max_tiles;
  if (info) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = static_cast<int>(smem);
  }
  TowerArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), params, smem,
                                    s);
  return static_cast<int>(err);
}

int fill(TowerArgs& a, void* const* ptrs, int count, const long long* strides,
         const int* dims, unsigned thr, float scale, float eps) {
  for (int i = 0; i < count; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < 3; ++i) a.bits_stride[i] = strides[i];
  a.layers = dims[0];
  a.b = dims[1];
  a.t = dims[2];
  a.h = dims[3];
  a.heads = dims[4];
  a.inter = dims[5];
  a.save = dims[6];
  a.thr = thr;
  a.scale = scale;
  a.eps = eps;
  if (a.h != a.heads * kDHead || a.h > kLnMaxWidth || a.h % 64 ||
      a.inter % 64 || a.layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// ptrs: F_COUNT device pointers in FwdPtr order (null where absent): x
// (b t, h), mask (b, t) int32, the 12 stacked leaves of type T with weights
// (L, out, in), bits p / h / f (layer 0's, uint32; null without dropout or
// in prng mode), seed ((1,) int32: prng mode; else null), z
// (b t, h), then the residuals xin, qkv, p, o, r1, f, r2 ((L, ...) with
// save; else xin (2, b t, h), one layer of qkv, o, r1, r2, and p, f null),
// and scratch y (b t, h), a (b t, inter). strides: elements between two
// layers' bits. dims: L, b, t, h, heads, inter, save. info: 3 host ints out.
extern "C" int tgfr_tower_fwd(void* const* ptrs, const long long* strides,
                              const int* dims, int* info, unsigned thr,
                              float scale, float eps, int dtype,
                              void* stream) {
  TowerArgs a{};
  if (int e = fill(a, ptrs, F_COUNT, strides, dims, thr, scale, eps)) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = a.b * a.t;
  const int tiles = std::max({ceil_div(rows, tgfr::kBM) * (a.inter / tgfr::kBN),
                              a.b * a.heads, ceil_div(rows, kWarps)});
  if (dtype == tgfr::kBF16)
    return launch(tower_fwd_kernel<__nv_bfloat16>, a,
                  max_sz(tgfr::gemm_smem_bytes<__nv_bfloat16>(),
                         tgfr::attn_fwd_smem_bytes(a.t)), tiles, info, s);
  if (dtype == tgfr::kF32)
    return launch(tower_fwd_kernel<float>, a,
                  max_sz(tgfr::gemm_smem_bytes<float>(),
                         tgfr::attn_fwd_smem_bytes(a.t)), tiles, info, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ptrs: B_COUNT device pointers in BwdPtr order: dz (b t, h), mask, the
// saved residuals xin, qkv, p, o, r1, f, r2 (L, ...), the stacked leaves
// wqkv, wo, g1, b1, w1, w2, g2 of type T, bits p / h / f, seed; outputs dx
// (b t, h) and the 12 stacked gradients of type T in the leaves' shapes;
// scratch dr, dd (b t, h; dd only with bits), a (b t, inter), y (b t, h),
// df (b t, inter), dy, dout (b t, h), dqkv (b t, 3h), part
// (ceil(b t / 4), 3h) f32.
extern "C" int tgfr_tower_bwd(void* const* ptrs, const long long* strides,
                              const int* dims, int* info, unsigned thr,
                              float scale, float eps, int dtype,
                              void* stream) {
  TowerArgs a{};
  if (int e = fill(a, ptrs, B_COUNT, strides, dims, thr, scale, eps)) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = a.b * a.t;
  // the widest phase: dW2 and df, or dW1 and dy
  const int tiles = (a.h / tgfr::kBM) * (a.inter / tgfr::kBN) +
                    ceil_div(rows, tgfr::kBM) * (a.inter / tgfr::kBN) +
                    3 * a.h / tgfr::kSumCols;
  const size_t extra =
      max_sz(tgfr::attn_bwd_smem_bytes(a.t),
             (size_t)kWarps * tgfr::kLnMaxWidth * sizeof(float));
  if (dtype == tgfr::kBF16)
    return launch(tower_bwd_kernel<__nv_bfloat16>, a,
                  max_sz(tgfr::gemm_smem_bytes<__nv_bfloat16>(), extra),
                  tiles, info, s);
  if (dtype == tgfr::kF32)
    return launch(tower_bwd_kernel<float>, a,
                  max_sz(tgfr::gemm_smem_bytes<float>(), extra), tiles, info, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
