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
// fills the card (the occupancy of this kernel x SM count, asked of the
// runtime at launch for the shared memory that launch's t needs: 3 blocks
// a SM in bf16 at T 24, so the 384 caption-head items of the attention
// phase at B 32 take one round; 1 at T 512, where the attention tiles take
// 150 KB forward and 210 KB backward), launched with
// cudaLaunchCooperativeKernel. The blocks take the work items of the
// current phase (the `*_tile` device functions of common.cuh, the same ones
// the half-layer kernels K1-K6 launch one per block) from a counter and
// meet at a grid-wide barrier between phases. No on-chip memory spans SMs,
// so the carried activation lives in device memory (1.2 MB in bf16 at 768
// rows: it stays in the 50 MB L2), and so do the phase outputs; a phase
// reads what other blocks wrote before the barrier with ordinary (coherent)
// loads. The weights arrive stacked (L, ...) and already rounded to the
// activation type T, in nn.Linear's (out, in) layout; before each barrier
// the blocks ask the next phase's weight (and the next layer's Wqkv) into
// L2. The GEMMs run on common.cuh's wgmma core, the LayerNorm phases on
// the vector rows of K1/K2. A layer's buffers are recomputed from the
// kernel's parameters in each phase, so that none stays in registers
// across the barriers.
//
// Forward, 7 phases and barriers a layer:
//   (1) qkv = x . Wqkv + bqkv;  (2) per (caption, head): softmax, the
//   probabilities' dropout, P.V -> o, on the tile the half-layer kernel K5
//   runs at the same t with residuals (bf16: common.cuh's scalar tile up
//   to t = 128; past it the tensor-core tile, in an instantiation of its
//   own (kLong), so that the short one keeps the code and the time it had;
//   f32: the strip tile), so that the chain of half-layers adds the same
//   values;  (3) r1 = x + drop(o . Wo + bo);
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
//   (6) per (caption, head): the attention backward -> dqkv (bf16: the
//       tensor-core tile of common.cuh that K6 runs too; f32: the strip
//       tile, K6's too), t up to 512;
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
// the operations. Measured (PERF.md, PR 6, NVIDIA H100 80GB HBM3 at 700 W):
// the forward 1.8 ms (eval), the backward 3.4 ms (host-bits dropout),
// each below the 12 x half-layer chain on the same core; the phase table
// (chip_smoke.py, the TGFR_PHASE_TIMES build) puts most of what is left in
// the GEMM phases, slower than the same GEMMs launched alone, the
// attention phases and the LN backward rows.
#include <algorithm>

#include <cooperative_groups.h>

// TGFR_TOWER_PART 1 compiles the forward (K7), 2 the backward (K8): ops/
// _cuda.py `PARTS` builds each as a shared library of its own, the two at
// once, each minutes of compile; without it, both in one.
#if !defined(TGFR_TOWER_PART) || TGFR_TOWER_PART == 1
#define TGFR_TOWER_FWD 1
#else
#define TGFR_TOWER_FWD 0
#endif
#if !defined(TGFR_TOWER_PART) || TGFR_TOWER_PART == 2
#define TGFR_TOWER_BWD 1
#else
#define TGFR_TOWER_BWD 0
#endif

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tgfr;

constexpr int kThreads = 128;  // = kGemmThreads = kAttnThreads
constexpr int kWarps = kThreads / 32;
constexpr int kLnRed = 3 * kWarps * kLnMaxWidth;  // floats: the LN tiles' sums
// Blocks a SM the compiler sizes registers for: bf16 three (the attention
// phase's 384 caption-head items at B 32 take one round on 396 blocks, and
// the GEMM ring is sized for three), f32 one (its checks need no speed).
// How many are resident is the runtime's answer for the launch's shared
// memory (`launch`): fewer at long t.
template <typename T> constexpr int kMinBlocks = 3;
template <> constexpr int kMinBlocks<float> = 1;
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

// The GEMM p with its tile width (common.cuh gemm_width).
template <typename T>
__device__ __forceinline__ GemmArgs planned(GemmArgs p) {
  p.bn = gemm_width<T>(p.m, p.n);
  return p;
}

// This block's share of [p, p + bytes) asked into L2, 128-byte lines: the
// next phase's weight, requested before the barrier in front of it, so its
// first tiles find it in L2 (a layer's weights, 14 MB in bf16, come from
// device memory once a pass: the 12 layers' 170 MB exceed the 50 MB L2).
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 128;
       o < bytes; o += (size_t)gridDim.x * kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

// The work items of a phase go to the blocks in order from a counter, one
// counter a phase (g_items, per direction), so that a block that finishes
// early takes the next item: the runtime does not spread the first blocks
// over distinct SMs (132 blocks of a 264-block grid sat on 124 SMs of an
// H100), so a fixed split by block index doubled the load of some SMs
// while others idled. Block 0 zeroes the counters before its first item;
// a block that reads a counter before that only finds its items taken by
// others, and a counter read twice hands an item out twice, which writes
// the same values again: every item is computed, none half. The grid fills
// the card, so no two launches of one direction run at once.
constexpr int kMaxPhases = 1024;
__device__ unsigned g_items[2][kMaxPhases];

// Runs f(w) for the items w < n of the phase whose counter is ctr that
// this block takes: thread 0 asks for the next item while the block works
// on the current one, so the atomic's round trip is hidden; `slot` is
// shared memory. Ends after a barrier, with shared memory free.
template <typename F>
__device__ __forceinline__ void for_items(unsigned* ctr, int n, int* slot,
                                          F&& f) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = static_cast<int>(atomicAdd(ctr, 1u));
  __syncthreads();
  int w = *slot;
  while (w < n) {
    unsigned next = 0u;
    if (threadIdx.x == 0) next = atomicAdd(ctr, 1u);
    f(w);
    __syncthreads();
    if (threadIdx.x == 0) *slot = static_cast<int>(next);
    __syncthreads();
    w = *slot;
  }
}

template <int DIR>
__device__ __forceinline__ void zero_items(int phases) {
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < phases; i += kThreads) g_items[DIR][i] = 0u;
    __threadfence();
  }
}

// One work item of each kind: a tile function of common.cuh.
template <typename T, int EPI, int AL, int BL>
__device__ __forceinline__ void gemm_item(const GemmArgs& g, int tile,
                                       unsigned char* smem) {
  gemm_tile<T, EPI, AL, BL>(g, tile, smem);
}

// The attention forward of pair w (= b heads + head), on K5's tile for the
// same t with residuals: bf16 the scalar tile (t <= kAttnScalarT) or, in
// the kLong instantiation, the tensor-core tile, one pair an item
// (attn_pairs_per_block past 32), saving p where p is given; f32 the strip
// tile.
template <typename T, bool kLong>
__device__ __forceinline__ void attn_fwd_item(const T* qkv, const int* mask,
                                           const DropSrc& drop, unsigned thr,
                                           float scale, T* p, T* o, int nb,
                                           int t, int h, float inv, int w,
                                           unsigned char* smem) {
  const int heads = h / kDHead;
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    attention_strip_tile(qkv, mask, drop, thr, scale, p, o, nb, t, h, inv,
                         w / heads, w % heads,
                         reinterpret_cast<float*>(smem));
  } else if constexpr (kLong) {
    if (p)
      attention_mma_tile<true>(qkv, mask, drop, thr, scale, p, o, nb, t, h,
                               inv, w, 1, nb * heads, smem);
    else
      attention_mma_tile<false>(qkv, mask, drop, thr, scale, p, o, nb, t, h,
                                inv, w, 1, nb * heads, smem);
  } else {
    attention_core_tile<T>(qkv, mask, drop, thr, scale, p, o, nb, t, h, inv,
                           w / heads, w % heads,
                           reinterpret_cast<float*>(smem));
  }
}

// Pairs (caption, head) a work item of the attention backward: in bf16 as
// many as a block of the half-layer kernel K6 takes
// (attn_bwd_pairs_per_block), in f32 one.
template <typename T> __host__ __device__ int attn_bwd_pairs(int t) {
  return std::is_same<T, __nv_bfloat16>::value ? attn_bwd_pairs_per_block(t)
                                               : 1;
}

// The attention backward of item w: in bf16 the tensor-core tile the
// half-layer backward K6 runs, so that the chain of half-layers adds the
// same values (a pair's sums do not depend on the pairs beside it); in f32
// the strip tile of pair w (= b heads + head).
template <typename T>
__device__ __forceinline__ void attn_bwd_item(const T* qkv, const T* p,
                                           const T* dout, const DropSrc& drop,
                                           unsigned thr, float scale, T* dqkv,
                                           int nb, int t, int h, float inv,
                                           int w, unsigned char* smem) {
  const int heads = h / kDHead;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int pairs = attn_bwd_pairs<T>(t);
    attention_bwd_mma_tile(qkv, p, dout, drop, thr, scale, dqkv, nb, t, h,
                           inv, w * pairs, pairs, nb * heads, smem);
  } else {
    attention_strip_bwd_tile(qkv, p, dout, drop, thr, scale, dqkv, nb, t, h,
                             inv, w / heads, w % heads,
                             reinterpret_cast<float*>(smem));
  }
}

template <typename T>
__device__ __forceinline__ void ln_item(const T* x, const T* gamma,
                                     const T* beta, T* y, int rows, int h,
                                     float eps, int tile, T* stage) {
  layernorm_rows_tile<T, kWarps>(x, gamma, beta, y, rows, h, eps, tile,
                                 stage);
}

template <typename T>
__device__ __forceinline__ void ln_bwd_item(const T* dy, const T* x,
                                         const T* gamma, T* dx, T* dxd,
                                         const DropSrc& drop, unsigned thr,
                                         float scale, float* part, int rows,
                                         int h, float eps, int tile,
                                         float* red, T* stage) {
  layernorm_bwd_rows_tile<T, kWarps>(dy, x, gamma, dx, dxd, drop, thr, scale,
                                     part, 3, rows, h, eps, tile, red, stage);
}

// Column-sum item w of a phase: 32 columns of `in` (rows, cols) into out.
template <typename TIn, typename T>
__device__ __forceinline__ void colsum_item(const TIn* in, int rows, int cols,
                                            T* out, int w,
                                            unsigned char* smem) {
  const int c0 = w * kSumCols;
  colsum_tile<TIn, T, kWarps>(in, rows, cols, c0, out + c0, threadIdx.x % 32,
                              threadIdx.x / 32,
                              reinterpret_cast<float*>(smem));
}

// Item w of the LN sums: part (tiles, 3 h) f32 -> s0, s1, s2 (h each), T.
template <typename T>
__device__ __forceinline__ void ln_sums_item(const float* part, int tiles,
                                             int h, T* s0, T* s1, T* s2,
                                             int w, unsigned char* smem) {
  const int per = h / kSumCols;
  const int q = w / per, c0 = (w % per) * kSumCols;
  T* out = (q == 0 ? s0 : (q == 1 ? s1 : s2)) + c0;
  colsum_tile<float, T, kWarps>(part, tiles, 3 * h, q * h + c0, out,
                                threadIdx.x % 32, threadIdx.x / 32,
                                reinterpret_cast<float*>(smem));
}

// Measurement build (-DTGFR_PHASE_TIMES; ops/_cuda.py `VARIANTS`): the
// time of every phase and barrier, read by chip_smoke.py's phase table and
// loaded by nothing else. At each barrier every block's thread 0 stamps its
// arrival with %globaltimer into a device buffer (atomicMax: the last
// block's arrival ends the phase), and block 0 stamps the release right
// after grid.sync(); block 0 also stamps the kernel's start. A phase's time
// is its last arrival less the previous release; a barrier's cost is its
// release less its last arrival. The default build compiles none of it.
#ifdef TGFR_PHASE_TIMES
constexpr int kMaxStamps = 1024;
__device__ unsigned long long g_start[2];
__device__ unsigned long long g_arrive[2][kMaxStamps];
__device__ unsigned long long g_release[2][kMaxStamps];
__device__ unsigned g_smid[2][kMaxStamps];   // the SM of each block

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Block 0 stamps the kernel's start, every block its SM (measurement build
// only).
template <int DIR> __device__ __forceinline__ void phase_start() {
#ifdef TGFR_PHASE_TIMES
  if (blockIdx.x == 0 && threadIdx.x == 0) g_start[DIR] = now_ns();
  if (threadIdx.x == 0 && blockIdx.x < kMaxStamps) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_smid[DIR][blockIdx.x] = sm;
  }
#endif
}

// The end of phase n: the block's arrival (measurement build only).
template <int DIR> __device__ __forceinline__ void phase_arrive(int n) {
#ifdef TGFR_PHASE_TIMES
  __syncthreads();
  if (threadIdx.x == 0 && n < kMaxStamps)
    atomicMax(&g_arrive[DIR][n], now_ns());
#endif
}

// The grid-wide barrier after phase n; n counts the pass's barriers.
template <int DIR>
__device__ __forceinline__ void phase_sync(cg::grid_group& grid, int& n) {
  phase_arrive<DIR>(n);
  grid.sync();
#ifdef TGFR_PHASE_TIMES
  if (blockIdx.x == 0 && threadIdx.x == 0 && n < kMaxStamps)
    g_release[DIR][n] = now_ns();
#endif
  ++n;
}

#if TGFR_TOWER_FWD
template <typename T, bool kLong>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
tower_fwd_kernel(TowerArgs a) {
  extern __shared__ __align__(32) unsigned char smem[];
  __shared__ int slot;
  cg::grid_group grid = cg::this_grid();
  const int rows = a.b * a.t, h = a.h, inter = a.inter, L = a.layers;
  const size_t act = (size_t)rows * h;
  const size_t p_el = (size_t)a.heads * a.b * a.t * a.t;
  const size_t hh = (size_t)h * h, ih = (size_t)inter * h;
  const int ln_tiles = (rows + kWarps - 1) / kWarps;
  const float inv = 1.0f / sqrtf(static_cast<float>(kDHead));
  T* y = static_cast<T*>(a.p[F_Y]);
  T* ab = static_cast<T*>(a.p[F_A]);
  T* stage = reinterpret_cast<T*>(smem);        // the LN tiles' staging
  const int* mask = static_cast<const int*>(a.p[F_MASK]);
  unsigned* items = g_items[0];
  int ns = 0;
  phase_start<0>();
  zero_items<0>(7 * L);

  for (int j = 0; j < L; ++j) {
    // the layer's buffers, recomputed from the kernel's parameters where
    // a phase uses them (none stays live across the phases)
    const size_t slot_j = a.save ? j : 0;       // this layer's residual slot
    auto X = [&] {
      return j == 0 ? static_cast<const T*>(a.p[F_X])
                    : at<T>(a.p[F_XIN], (a.save ? j : (j & 1)) * act);
    };
    auto Z = [&] {
      return j == L - 1 ? static_cast<T*>(a.p[F_Z])
                        : at<T>(a.p[F_XIN],
                                (a.save ? j + 1 : ((j + 1) & 1)) * act);
    };
    auto QKV = [&] { return at<T>(a.p[F_QKV], slot_j * act * 3); };
    auto O = [&] { return at<T>(a.p[F_O], slot_j * act); };
    auto R1 = [&] { return at<T>(a.p[F_R1], slot_j * act); };
    auto R2 = [&] { return at<T>(a.p[F_R2], slot_j * act); };
    auto W = [&](int which, size_t per) {
      return at<T>(a.p[which], j * per);
    };
    auto LD = [&] { return layer_drop(a, a.p + F_BITS_P, a.p[F_SEED], j); };

    // (1) qkv = x . Wqkv + bqkv; layer 0 also files x as its saved input
    {
      GemmArgs g = planned<T>(
          gemm_args(X(), W(F_WQKV, 3 * hh), QKV(), rows, 3 * h, h));
      g.bias_t = at<T>(a.p[F_BQKV], (size_t)j * 3 * h);
      const int n = gemm_tiles(g);
      for_items(items + ns, n, &slot, [&](int w) {
        gemm_item<T, kEpiBias, kARowMajor, kBActNK>(g, w, smem);
      });
      if (j == 0 && a.save) {
        T* x0 = static_cast<T*>(a.p[F_XIN]);
        const T* x = X();
        for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < act;
             i += (size_t)gridDim.x * kThreads)
          x0[i] = x[i];
      }
    }
    prefetch_l2(W(F_WO, hh), hh * sizeof(T));
    phase_sync<0>(grid, ns);
    // (2) attention per (caption, head)
    for_items(items + ns, a.b * a.heads, &slot, [&](int w) {
      attn_fwd_item<T, kLong>(QKV(), mask, LD().p, a.thr, a.scale,
                              at<T>(a.p[F_P], slot_j * p_el), O(), a.b, a.t,
                              h, inv, w, smem);
    });
    phase_sync<0>(grid, ns);
    // (3) r1 = x + drop(o . Wo + bo)
    {
      GemmArgs g = planned<T>(gemm_args(O(), W(F_WO, hh), R1(), rows, h, h));
      g.bias_t = at<T>(a.p[F_BO], (size_t)j * h);
      g.resid = X();
      g.drop = LD().h;
      g.thr = a.thr;
      g.scale = a.scale;
      const int n = gemm_tiles(g);
      for_items(items + ns, n, &slot, [&](int w) {
        gemm_item<T, kEpiBiasResidual, kARowMajor, kBActNK>(g, w, smem);
      });
    }
    prefetch_l2(W(F_W1, ih), ih * sizeof(T));
    phase_sync<0>(grid, ns);
    // (4) y = LN(r1)
    for_items(items + ns, ln_tiles, &slot, [&](int w) {
      ln_item<T>(R1(), at<T>(a.p[F_G1], (size_t)j * h),
                 at<T>(a.p[F_B1], (size_t)j * h), y, rows, h, a.eps, w,
                 stage);
    });
    phase_sync<0>(grid, ns);
    // (5) f = y . W1 + c1, a = gelu(f)
    {
      GemmArgs g = planned<T>(gemm_args(y, W(F_W1, ih), ab, rows, inter, h));
      g.bias_t = at<T>(a.p[F_C1], (size_t)j * inter);
      g.out2 = at<T>(a.p[F_F], slot_j * rows * inter);
      const int n = gemm_tiles(g);
      for_items(items + ns, n, &slot, [&](int w) {
        gemm_item<T, kEpiBiasGelu, kARowMajor, kBActNK>(g, w, smem);
      });
    }
    prefetch_l2(W(F_W2, ih), ih * sizeof(T));
    phase_sync<0>(grid, ns);
    // (6) r2 = y + drop(a . W2 + c2)
    {
      GemmArgs g = planned<T>(gemm_args(ab, W(F_W2, ih), R2(), rows, h, inter));
      g.bias_t = at<T>(a.p[F_C2], (size_t)j * h);
      g.resid = y;
      g.drop = LD().f;
      g.thr = a.thr;
      g.scale = a.scale;
      const int n = gemm_tiles(g);
      for_items(items + ns, n, &slot, [&](int w) {
        gemm_item<T, kEpiBiasResidual, kARowMajor, kBActNK>(g, w, smem);
      });
    }
    if (j + 1 < L)
      prefetch_l2(at<T>(a.p[F_WQKV], (j + 1) * 3 * hh), 3 * hh * sizeof(T));
    phase_sync<0>(grid, ns);
    // (7) z = LN(r2)
    for_items(items + ns, ln_tiles, &slot, [&](int w) {
      ln_item<T>(R2(), at<T>(a.p[F_G2], (size_t)j * h),
                 at<T>(a.p[F_B2], (size_t)j * h), Z(), rows, h, a.eps, w,
                 stage);
    });
    if (j < L - 1) phase_sync<0>(grid, ns);
  }
  phase_arrive<0>(ns);
}

#endif  // TGFR_TOWER_FWD
#if TGFR_TOWER_BWD
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
tower_bwd_kernel(TowerArgs a) {
  extern __shared__ __align__(32) unsigned char smem[];
  __shared__ int slot;
  cg::grid_group grid = cg::this_grid();
  const int rows = a.b * a.t, h = a.h, inter = a.inter, L = a.layers;
  const size_t act = (size_t)rows * h;
  const size_t p_el = (size_t)a.heads * a.b * a.t * a.t;
  const size_t hh = (size_t)h * h, ih = (size_t)inter * h;
  const int ln_tiles = (rows + kWarps - 1) / kWarps;
  const float inv = 1.0f / sqrtf(static_cast<float>(kDHead));
  float* red = reinterpret_cast<float*>(smem);    // the LN tiles' sums,
  T* stage = reinterpret_cast<T*>(red + kLnRed);  // then their staging
  T* dx = static_cast<T*>(a.p[B_DX]);
  T* dr = static_cast<T*>(a.p[B_DR]);
  T* ab = static_cast<T*>(a.p[B_A]);
  T* y = static_cast<T*>(a.p[B_Y]);
  T* df = static_cast<T*>(a.p[B_DF]);
  T* dy = static_cast<T*>(a.p[B_DY]);
  T* dout = static_cast<T*>(a.p[B_DOUT]);
  T* dqkv = static_cast<T*>(a.p[B_DQKV]);
  float* part = static_cast<float*>(a.p[B_PART]);
  unsigned* items = g_items[1];
  int ns = 0;
  phase_start<1>();
  zero_items<1>(7 * L);

  for (int j = L - 1; j >= 0; --j) {
    // the layer's buffers, recomputed from the kernel's parameters where
    // a phase uses them (none stays live across the phases)
    auto R = [&](int which, size_t per) {      // a saved residual of layer j
      return static_cast<const T*>(at<T>(a.p[which], j * per));
    };
    auto W = [&](int which, size_t per) {      // a stacked leaf of layer j
      return static_cast<const T*>(at<T>(a.p[which], j * per));
    };
    auto G = [&](int which, size_t per) {      // a stacked gradient
      return at<T>(a.p[which], j * per);
    };
    auto LD = [&] { return layer_drop(a, a.p + B_BITS_P, a.p[B_SEED], j); };
    const size_t ri = (size_t)rows * inter;
    // the dropped gradients: a buffer of their own with dropout, else dr
    auto DD = [&](bool on) { return on ? static_cast<T*>(a.p[B_DD]) : dr; };

    // (1) LN2 backward rows; y = LN(r1) and a = gelu(f) recomputed
    for_items(items + ns, 2 * ln_tiles, &slot, [&](int w) {
      if (w < ln_tiles)
      {
        const DropSrc df_ = LD().f;
        ln_bwd_item<T>(j == L - 1 ? static_cast<const T*>(a.p[B_DZ]) : dx,
                       R(B_R2, act), W(B_G2, h), dr,
                       df_.on() ? DD(true) : nullptr, df_, a.thr, a.scale,
                       part, rows, h, a.eps, w, red, stage);
      } else {
        ln_item<T>(R(B_R1, act), W(B_G1, h), W(B_B1, h), y, rows, h, a.eps,
                   w - ln_tiles, stage);
      }
    });
    gelu_rows<T>(R(B_F, ri), ab, ri);
    prefetch_l2(W(B_W2, ih), ih * sizeof(T));
    phase_sync<1>(grid, ns);
    // (2) dgamma2, dbeta2, dc2; dW2 (h, inter) = dgg^T . a;
    //     df = r(r(dgg . W2) gelu'(f)), W2 stored (h, inter) = (K, N)
    {
      T* dd_f = DD(LD().f.on());
      GemmArgs gw = planned<T>(
          gemm_args(dd_f, ab, G(B_DW2, ih), h, inter, rows));
      GemmArgs gd = planned<T>(
          gemm_args(dd_f, W(B_W2, ih), df, rows, inter, h));
      gd.aux = R(B_F, ri);
      const int n0 = gemm_tiles(gw), n1 = n0 + gemm_tiles(gd);
      const int n2 = n1 + 3 * h / kSumCols;
      for_items(items + ns, n2, &slot, [&](int w) {
        if (w < n0)
          gemm_item<T, kEpiBias, kATransposed, kBActKN>(gw, w, smem);
        else if (w < n1)
          gemm_item<T, kEpiDgelu, kARowMajor, kBActKN>(gd, w - n0, smem);
        else
          ln_sums_item<T>(part, ln_tiles, h, G(B_DG2, h), G(B_DB2, h),
                          G(B_DC2, h), w - n1, smem);
      });
    }
    prefetch_l2(W(B_W1, ih), ih * sizeof(T));
    phase_sync<1>(grid, ns);
    // (3) dy = r(dr2 + r(df . W1)), W1 stored (inter, h) = (K, N);
    //     dW1 (inter, h) = df^T . y; dc1
    {
      GemmArgs gx = planned<T>(gemm_args(df, W(B_W1, ih), dy, rows, h, inter));
      gx.resid = dr;
      GemmArgs gw = planned<T>(
          gemm_args(df, y, G(B_DW1, ih), inter, h, rows));
      const int n0 = gemm_tiles(gx), n1 = n0 + gemm_tiles(gw);
      const int n2 = n1 + inter / kSumCols;
      for_items(items + ns, n2, &slot, [&](int w) {
        if (w < n0)
          gemm_item<T, kEpiBiasResidual, kARowMajor, kBActKN>(gx, w, smem);
        else if (w < n1)
          gemm_item<T, kEpiBias, kATransposed, kBActKN>(gw, w - n0, smem);
        else
          colsum_item<T, T>(df, rows, inter, G(B_DC1, inter), w - n1, smem);
      });
    }
    phase_sync<1>(grid, ns);
    // (4) LN1 backward rows
    for_items(items + ns, ln_tiles, &slot, [&](int w) {
      const DropSrc dh_ = LD().h;
      ln_bwd_item<T>(dy, R(B_R1, act), W(B_G1, h), dr,
                     dh_.on() ? DD(true) : nullptr, dh_, a.thr, a.scale, part,
                     rows, h, a.eps, w, red, stage);
    });
    prefetch_l2(W(B_WO, hh), hh * sizeof(T));
    phase_sync<1>(grid, ns);
    // (5) dgamma1, dbeta1, dbo; dWo (h, h) = dh^T . o; do = r(dh . Wo)
    {
      T* dd_h = DD(LD().h.on());
      GemmArgs gw = planned<T>(
          gemm_args(dd_h, R(B_O, act), G(B_DWO, hh), h, h, rows));
      GemmArgs gd = planned<T>(gemm_args(dd_h, W(B_WO, hh), dout, rows, h, h));
      const int n0 = gemm_tiles(gw), n1 = n0 + gemm_tiles(gd);
      const int n2 = n1 + 3 * h / kSumCols;
      for_items(items + ns, n2, &slot, [&](int w) {
        if (w < n0)
          gemm_item<T, kEpiBias, kATransposed, kBActKN>(gw, w, smem);
        else if (w < n1)
          gemm_item<T, kEpiBias, kARowMajor, kBActKN>(gd, w - n0, smem);
        else
          ln_sums_item<T>(part, ln_tiles, h, G(B_DG1, h), G(B_DB1, h),
                          G(B_DBO, h), w - n1, smem);
      });
    }
    prefetch_l2(W(B_WQKV, 3 * hh), 3 * hh * sizeof(T));
    phase_sync<1>(grid, ns);
    // (6) the attention backward per (caption, head)
    const int pairs = attn_bwd_pairs<T>(a.t);
    for_items(items + ns, (a.b * a.heads + pairs - 1) / pairs, &slot,
              [&](int w) {
      attn_bwd_item<T>(R(B_QKV, 3 * act), R(B_P, p_el), dout, LD().p, a.thr,
                       a.scale, dqkv, a.b, a.t, h, inv, w, smem);
    });
    phase_sync<1>(grid, ns);
    // (7) dx = r(dr1 + r(dqkv . Wqkv)), Wqkv stored (3h, h) = (K, N);
    //     dWqkv (3h, h) = dqkv^T . x; dbqkv
    {
      GemmArgs gx = planned<T>(
          gemm_args(dqkv, W(B_WQKV, 3 * hh), dx, rows, h, 3 * h));
      gx.resid = dr;
      GemmArgs gw = planned<T>(
          gemm_args(dqkv, R(B_XIN, act), G(B_DWQKV, 3 * hh), 3 * h, h, rows));
      const int n0 = gemm_tiles(gx), n1 = n0 + gemm_tiles(gw);
      const int n2 = n1 + 3 * h / kSumCols;
      for_items(items + ns, n2, &slot, [&](int w) {
        if (w < n0)
          gemm_item<T, kEpiBiasResidual, kARowMajor, kBActKN>(gx, w, smem);
        else if (w < n1)
          gemm_item<T, kEpiBias, kATransposed, kBActKN>(gw, w - n0, smem);
        else
          colsum_item<T, T>(dqkv, rows, 3 * h, G(B_DBQKV, 3 * h), w - n1,
                            smem);
      });
    }
    if (j > 0)
      prefetch_l2(at<T>(a.p[B_W2], (j - 1) * ih), ih * sizeof(T));
    if (j > 0) phase_sync<1>(grid, ns);
  }
  phase_arrive<1>(ns);
}

#endif  // TGFR_TOWER_BWD
// Launch `kernel` cooperatively on the grid that fills the card: as many
// blocks as are resident at once. info[0] = the grid, info[1] = blocks per
// SM, info[2] = the dynamic shared memory in bytes.
template <typename K>
int launch(K kernel, const TowerArgs& a, size_t smem, int max_per_sm,
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
  if (per_sm > max_per_sm) per_sm = max_per_sm;
  // the thread stack the kernel's spills need (the runtime does not grow
  // it for a cooperative launch: without this the f32 backward's launch
  // is refused as out of resources)
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
    return static_cast<int>(err);
  size_t stack = 0;
  if ((err = cudaDeviceGetLimit(&stack, cudaLimitStackSize)) != cudaSuccess)
    return static_cast<int>(err);
  if (stack < fa.localSizeBytes &&
      (err = cudaDeviceSetLimit(cudaLimitStackSize, fa.localSizeBytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int grid = per_sm * sms;
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
      a.inter % 64 || a.layers < 1 || 7 * a.layers > kMaxPhases ||
      a.t < 1 || a.t > kAttnMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}


}  // namespace

#if TGFR_TOWER_FWD
// ptrs: F_COUNT device pointers in FwdPtr order (null where absent): x
// (b t, h), mask (b, t) int32, the 12 stacked leaves of type T with weights
// (L, out, in), bits p / h / f (layer 0's, uint32; null without dropout or
// in prng mode), seed ((1,) int32: prng mode; else null), z
// (b t, h), then the residuals xin, qkv, p, o, r1, f, r2 ((L, ...) with
// save; else xin (2, b t, h), one layer of qkv, o, r1, r2, and p, f null),
// and scratch y (b t, h), a (b t, inter). strides: elements between two
// layers' bits. dims: L, b, t, h, heads, inter, save. info: 3 host ints out.
TGFR_API int tgfr_tower_fwd(void* const* ptrs, const long long* strides,
                              const int* dims, int* info, unsigned thr,
                              float scale, float eps, int dtype,
                              void* stream) {
  TowerArgs a{};
  if (int e = fill(a, ptrs, F_COUNT, strides, dims, thr, scale, eps)) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const size_t gemm_ln = std::max(tgfr::gemm_smem_bytes<bf16>(),
                                  tgfr::ln_tile_stage_bytes<bf16, kWarps>());
  // the shared memory of this launch's t: the scalar tile's grows as t^2,
  // the tensor-core tile's as t (150 KB at t = 512)
  if (dtype == tgfr::kBF16 && a.t <= tgfr::kAttnScalarT)
    return launch(tower_fwd_kernel<bf16, false>, a,
                  std::max(gemm_ln, tgfr::attn_fwd_smem_bytes(a.t)),
                  kMinBlocks<bf16>, info, s);
#ifndef TGFR_PHASE_TIMES  // the measurement build times bf16 at short t
  if (dtype == tgfr::kBF16)
    return launch(tower_fwd_kernel<bf16, true>, a,
                  std::max(gemm_ln, tgfr::attn_mma_smem_bytes(a.t, 1)),
                  kMinBlocks<bf16>, info, s);
  if (dtype == tgfr::kF32)
    return launch(tower_fwd_kernel<float, false>, a,
                  std::max({tgfr::gemm_smem_bytes<float>(),
                            tgfr::attn_strip_fwd_smem_bytes(),
                            tgfr::ln_tile_stage_bytes<float, kWarps>()}),
                  kMinBlocks<float>, info, s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // TGFR_TOWER_FWD
#if TGFR_TOWER_BWD
// ptrs: B_COUNT device pointers in BwdPtr order: dz (b t, h), mask, the
// saved residuals xin, qkv, p, o, r1, f, r2 (L, ...), the stacked leaves
// wqkv, wo, g1, b1, w1, w2, g2 of type T, bits p / h / f, seed; outputs dx
// (b t, h) and the 12 stacked gradients of type T in the leaves' shapes;
// scratch dr, dd (b t, h; dd only with bits), a (b t, inter), y (b t, h),
// df (b t, inter), dy, dout (b t, h), dqkv (b t, 3h), part
// (ceil(b t / 4), 3h) f32.
TGFR_API int tgfr_tower_bwd(void* const* ptrs, const long long* strides,
                              const int* dims, int* info, unsigned thr,
                              float scale, float eps, int dtype,
                              void* stream) {
  TowerArgs a{};
  if (int e = fill(a, ptrs, B_COUNT, strides, dims, thr, scale, eps)) return e;
  const auto s = static_cast<cudaStream_t>(stream);
  // the LN tiles: their sums, then their staging
  const size_t red = (size_t)kLnRed * sizeof(float);
  const size_t attn =
      dtype == tgfr::kBF16
          ? tgfr::attn_bwd_mma_smem_bytes(
                a.t, attn_bwd_pairs<__nv_bfloat16>(a.t))
          : tgfr::attn_strip_bwd_smem_bytes(a.t);
  if (dtype == tgfr::kBF16)
    return launch(tower_bwd_kernel<__nv_bfloat16>, a,
                  std::max({tgfr::gemm_smem_bytes<__nv_bfloat16>(), attn,
                            red + tgfr::ln_tile_stage_bytes<__nv_bfloat16,
                                                            kWarps>()}),
                  kMinBlocks<__nv_bfloat16>, info, s);
#ifndef TGFR_PHASE_TIMES
  if (dtype == tgfr::kF32)
    return launch(tower_bwd_kernel<float>, a,
                  std::max({tgfr::gemm_smem_bytes<float>(), attn,
                            red + tgfr::ln_tile_stage_bytes<float, kWarps>()}),
                  kMinBlocks<float>, info, s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // TGFR_TOWER_BWD
#ifdef TGFR_PHASE_TIMES
// Measurement build: zero the stamps of both passes.
TGFR_API int tgfr_tower_phase_reset(void* stream) {
  static const unsigned long long zeros[2 * kMaxStamps] = {};
  cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  cudaError_t e = cudaMemcpyToSymbol(g_start, zeros, sizeof(g_start));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_arrive, zeros, sizeof(g_arrive));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_release, zeros, sizeof(g_release));
  return static_cast<int>(e);
}

// Measurement build: out (1 + 2 n) = the start, n arrivals and n releases
// (ns, %globaltimer) of pass dir (0 forward, 1 backward); smid (1024): the
// SM each block ran on.
TGFR_API int tgfr_tower_phase_read(int dir, void* out, void* smid, int n,
                                     void* stream) {
  if (dir < 0 || dir > 1 || n < 1 || n > kMaxStamps)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<unsigned long long*>(out);
  const size_t row = sizeof(unsigned long long) * kMaxStamps;
  cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  cudaError_t e = cudaMemcpyFromSymbol(o, g_start, sizeof(*o),
                                       dir * sizeof(*o));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(o + 1, g_arrive, n * sizeof(*o), dir * row);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(o + 1 + n, g_release, n * sizeof(*o),
                             dir * row);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(smid, g_smid, sizeof(unsigned) * kMaxStamps,
                             dir * sizeof(unsigned) * kMaxStamps);
  return static_cast<int>(e);
}
#endif
