// DAMSM word-region similarity matrix (K9 of the port): for every caption i
// and image j, attend i's words over j's regions and gamma2-smooth the
// per-word cosines into sim[j, i].
//
// Replaces: text_guided_face_recognition_tpu/ops/damsm_pallas.py, `_kernel`
// reached through `damsm_similarity_pallas` (the forward of the custom VJP
// `damsm_similarity_fused`; its backward recomputes through the plain
// function, in the port as in JAX).
//
// Bound on the H100: operations. At B = 32, D = 256, T = 22, R = 196 the
// two contractions of the B^2 pairs (logits R x T x D and the attended
// context T x R x D) are 4.5 GFLOP against < 7 MB of inputs: 0.0675 ms as
// f32 FMA at 67 TFLOP/s, 0.027 ms as the 3xTF32 products this kernel runs
// (three TF32 products for each f32 one) at 495 TFLOP/s.
//
// Design, for this card. A block (16 warps) takes one image j and a group
// of captions: their words stay in shared memory as N word columns (N 96,
// 4 captions at the flagship; 32 where D > 256), while image j's regions
// stream through a double-buffered ring, 32 regions a block, by cp.async.
// What it does about each fault of the one-block-per-pair FMA kernel:
// - Tensor cores, at f32 accuracy (3xTF32): an f32 operand x splits into
//   hi (x cut to TF32) and lo = x - hi, and the f32 accumulator takes
//   lo.hi + hi.lo + hi.hi, small terms first, so the kernel holds to the
//   f32 plain version at 1e-4. The context product ctx' (D x N) +=
//   regions_block (D x 32) . E (32 x N) runs on wgmma: its B operand, the
//   gamma1 weights E, is what the kernel computes, so the softmax writes it
//   K-major (wgmma takes TF32 only K-major) into a 128-byte-swizzled tile,
//   hi and lo; A, the regions, comes from registers, where any layout
//   loads. The logits product stays on mma.sync.m16n8k8: both of its
//   operands (regions (B, D, R) and words (B, D, T)) lie MN-major, so
//   wgmma would need them transposed and split in shared memory, two more
//   copies that do not fit beside the word tile; mma.sync loads its
//   fragments from the layouts as they are. The feature sum is split over
//   the warps' two halves (two logit tiles) so that the 24 tiles of a
//   region block spread evenly.
// - Register blocking, no bank conflicts: each A fragment serves a warp's
//   column tiles; the tile rows gid and gid + 8 are regions 2 gid, 2 gid + 1,
//   one 8-byte load; the ring, word and weight tiles are XOR-swizzled (see
//   rsw, wsw, eix) so that every fragment load of both products is free of
//   bank conflicts. A split is two instructions (a mask and a subtraction):
//   the tensor core ignores the low 13 bits of a TF32 operand.
// - Image j's regions are read once a block from L2 (256 blocks at the
//   flagship: 51 MB, where one block per pair read 410 MB).
// - The gamma1 softmax over streamed regions subtracts an offset from
//   gamma1 p (p is a softmax over words, in [0, 1]); the sums S are divided
//   out once, at the end. While |gamma1| <= kFixedGamma1 (60) the offset is
//   the fixed bound max(gamma1, 0): every term is at least exp(-|gamma1|),
//   a normal f32 number, so the sums cannot underflow and the context
//   accumulator needs no rescaling. Past it (ONLINE, an instantiation of
//   its own, so that the fixed offset's keeps its registers free of
//   spills: in one kernel the flagship took 9 % longer) the offset of a word
//   column is the running maximum of gamma1 p over the region blocks seen,
//   as an online softmax keeps it: each block's exponents first go to E
//   raw, the column maxima over the block's regions raise the running
//   ones, and where a maximum rises the column's context sums and S are
//   scaled by exp of the rise before the block's products; so the largest
//   term of every column is 1 and no sum underflows at any gamma1 (the TPU
//   kernel subtracts the true maximum). Either way the plain version's eps
//   clamp on the sums (a sum of at least 1) never acts. S rides on the
//   tensor cores too: a row of ones times E (mma.sync).
// - No limit on regions x words: the logit tiles are 32 x N whatever R and
//   T. Where one caption's T words do not fit in N columns (the long
//   path), a block takes one caption in chunks of N words: a first pass
//   keeps each region's running maximum and sum of the softmax over words
//   (`stats`) and the masked logits (`kept`, global scratch of the block's
//   own rows); the second reads the logits back into the two logit tiles
//   in turn (cp.async, beside the ring), normalises them, accumulates the
//   context, and folds each chunk's cosines into an online gamma2
//   log-sum-exp. The two paths are separate instantiations, so the short
//   one keeps its 48 context sums a thread in registers without spills.
// - The softmax works in base 2 (exp2 of v log2 e), a lane's words of a
//   segment in registers; the cosine partials are summed over a warp's
//   lanes by a transpose-reduce (7 exchanges for 6 values).
// - Any feature width D. Up to 512 features a block holds the whole of D:
//   its word tile (D x N) and the region ring (2 x D x 32) are what grow,
//   and the context sums a thread holds in registers (N 96 up to D 256,
//   N 32 up to 512). Past 512 (the wide path) D is split into `slices` of
//   at most 512 rows, the blocks of one launch a slice: the logits
//   need the whole of D before the softmax over words, but the cosine's
//   three sums (word . context, |word|^2, |context|^2) add over D. So a
//   first kernel (damsm_logits_kernel, f32 FMA, 32 regions by 32 words a
//   tile) writes the long path's scratch, every pair's masked logits and
//   each region's softmax statistics over words, over the whole of D;
//   then the long path's second pass runs on each slice of D, a launch a
//   slice (its words and regions rows, the logits read back, the same
//   tiling as D 512), each block writing its three cosine sums per word
//   (`wpart`); a last
//   kernel (damsm_finish_kernel) adds the slices' sums in order and takes
//   the cosines and the gamma2 log-sum-exp. Fewer word columns a block
//   would have kept D in one block only to a bound (the ring alone is
//   256 KB at D 1024), and a cluster would hold the slices' partial sums in
//   distributed shared memory only while a cluster's blocks fit the card;
//   the split over blocks takes any D at the cost of the logits' scratch
//   (4 B B R T, the long path's) and a region block read once a slice.
// Deterministic: no float atomics; every sum runs in a fixed order.
// The launch plan (path, captions a block, shared memory) comes from
// ops/damsm.py `damsm_plan`; the launcher checks only that a tiling takes
// it and that it stays inside its buffers.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRC = 32;          // regions a block of the ring
constexpr float kBig = 1e30f;    // masking without -inf, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
// the largest |gamma1| whose gamma1 softmax takes the fixed offset
// max(gamma1, 0): exp(-60) ~ 8.8e-27 is a normal f32 number
constexpr float kFixedGamma1 = 60.f;
constexpr int kMaxSliceD = 512;  // features a block holds (the wide path's slice)

struct Shape {
  int b, d, t, r;   // words (b, d, t), regions (b, d, r); on the wide path
                    // d is the rows of the block's slice
  int dld;          // the features of a caption or image (the long path's
                    // row stride; the short path's is d)
  int dp;           // d rounded up to a multiple of 16 (wide: the slice's)
  int g;            // captions a block (short path); 1 on the long path
  int lng;          // 1: the long path
  int vec;          // 1: regions copied 16 bytes at a time; 2: words 8
  int tp;           // long path: t rounded up to 8, a kept logits row
  int slices;       // slices of D (the wide path: more than 1)
  float gamma1, gamma2, eps, off1;   // off1 = max(gamma1, 0)
};

// x = hi + lo: hi is x cut to TF32 (its low 13 mantissa bits cleared), so
// a product with hi is exact; lo = x - hi is exact in f32, and the tensor
// core reads it to TF32 precision (2^-10 of lo, 2^-20 of x)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy (3xTF32), the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0,
                                     unsigned bh1, unsigned bl0,
                                     unsigned bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// D (64 x NW, f32) += A (64 x 8, TF32, in registers: a warp's rows as the
// m16n8k8 fragment) . B (8 x NW, TF32, shared memory, K-major, 128-byte
// swizzle, through descriptor b)
template <int NW> struct WgTf32;

template <> struct WgTf32<32> {
  __device__ static void mma(float (&d)[16], const unsigned (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct WgTf32<48> {
  __device__ static void mma(float (&d)[24], const unsigned (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct WgTf32<96> {
  __device__ static void mma(float (&d)[48], const unsigned (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, int src_bytes) {
  const unsigned s = tgfr::smem_u32(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory layouts, each free of bank conflicts for the fragment
// loads that read it:
// - a ring slot, regions (dp, 32): (d, r) at d 32 + (r ^ rsw(d));
__device__ __forceinline__ int rsw(int d) {
  return ((d & 3) << 3) | (d & 4);
}
// - the word tile (dp, N), N a multiple of 32: (d, n) at d N + (n ^ wsw(d));
__device__ __forceinline__ int wsw(int d) { return (d & 3) << 3; }
// - the gamma1 weights E (N, 32) for wgmma, K-major, 128-byte swizzle:
//   (n, r) at n 32 + (((r / 4) ^ (n % 8)) 4) + r % 4, hi then lo.
__device__ __forceinline__ int eix(int n, int r) {
  return n * 32 + ((((r >> 2) ^ (n & 7))) << 2) + (r & 3);
}

// regions_j rows d < dp, columns r0 .. r0 + 32 into a ring slot; zeros
// past d and r
__device__ void load_regions(float* dst, const float* rj, const Shape& s,
                             int r0) {
  if (s.vec & 1) {
    for (int e = threadIdx.x; e < s.dp << 3; e += kThreads) {
      const int dd = e >> 3, c = (e & 7) * 4, rr = r0 + c;
      const bool in = dd < s.d && rr < s.r;
      cp_async(dst + dd * kRC + (c ^ rsw(dd)),
               in ? rj + (size_t)dd * s.r + rr : rj, 16, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < s.dp << 5; e += kThreads) {
      const int dd = e >> 5, c = e & 31, rr = r0 + c;
      const bool in = dd < s.d && rr < s.r;
      cp_async(dst + dd * kRC + (c ^ rsw(dd)),
               in ? rj + (size_t)dd * s.r + rr : rj, 4, in ? 4 : 0);
    }
  }
  cp_commit();
}

// The block's word columns into ws (dp x ncp, zeros past d and ncols):
// column n is word n % t of caption i0 + n / t (short path), or word
// c0 + n of caption i0 (long path); cm[n] its mask (0 for padding). A
// warp takes rows, a lane pairs of columns: two words of one caption in
// one 8-byte copy where t is even (s.vec & 2).
template <int N, bool LNG>
__device__ void load_words(float* ws, float* cm, const float* words,
                           const float* mask, const Shape& s, int i0, int c0,
                           int ncols, int ncp) {
  constexpr int PER = (N + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool two = s.vec & 2;
  long long off[PER][2];   // each column's word in a feature row, or -1
#pragma unroll
  for (int k = 0; k < PER; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * (lane + 32 * k) + h;
      const int i = LNG ? i0 : i0 + n / s.t, tt = LNG ? c0 + n : n % s.t;
      off[k][h] = n < ncols ? (long long)i * (LNG ? s.dld : s.d) * s.t + tt
                            : -1;
    }
  for (int dd = warp; dd < s.dp; dd += kWarps) {
    const bool row = dd < s.d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int n = 2 * (lane + 32 * k);
      if (n >= ncp) continue;
      float* dst = ws + dd * N + (n ^ wsw(dd));
      if (two) {
        const int in = row ? (off[k][0] >= 0) + (off[k][1] >= 0) : 0;
        cp_async(dst, in ? words + off[k][0] + (size_t)dd * s.t : words, 8,
                 4 * in);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in = row && off[k][h] >= 0;
          cp_async(dst + h, in ? words + off[k][h] + (size_t)dd * s.t : words,
                   4, in ? 4 : 0);
        }
      }
    }
  }
  cp_commit();
  for (int n = threadIdx.x; n < ncp; n += kThreads) {
    float m = 0.f;
    if (n < ncols) {
      const int i = LNG ? i0 : i0 + n / s.t, tt = LNG ? c0 + n : n % s.t;
      m = mask ? mask[(size_t)i * s.t + tt] : 1.f;
    }
    cm[n] = m;
  }
}

// The long path's second pass: the kept logits of regions r0 .. r0 + rows,
// words c0 .. c0 + ncp of the pair (lgp: (r, tp)) into a logit tile
__device__ void load_logits(float* dst, const float* lgp, const Shape& s,
                            int r0, int rows, int c0, int ncp, int ld) {
  const int q = ncp / 4;
  for (int e = threadIdx.x; e < rows * q; e += kThreads) {
    const int rr = e / q, c = (e % q) * 4;
    cp_async(dst + rr * ld + c, lgp + (size_t)(r0 + rr) * s.tp + c0 + c, 16,
             16);
  }
  cp_commit();
}

// logits (32 x ntu 8) = regions_block^T (32 x dp) . ws (dp x ntu 8), on
// mma.sync, the feature sum split in two halves: warps 0-7 write the first
// half's sums to l0, warps 8-15 the second's to l1 (rows of LDL floats).
// A warp takes one 16-region row tile and every eighth column tile (no
// branch between the loads and the products; only the tiles in use are
// stored); row tiles at or past `rows` are skipped. The tile's rows gid and
// gid + 8 are regions 2 gid and 2 gid + 1, next to each other in a ring
// row: one 8-byte load for both.
template <int N>
__device__ void logits(const float* rb, const float* ws, float* l0, float* l1,
                       const Shape& s, int ntu, int rows) {
  constexpr int NT = N / 8, LDL = N + 4, LNT = (NT + 3) / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int half = warp / 8, wm = warp % 2, wn = (warp % 8) / 2;
  if (wm * 16 >= rows || wn >= ntu) return;
  float c[LNT][4];
#pragma unroll
  for (int l = 0; l < LNT; ++l)
    c[l][0] = c[l][1] = c[l][2] = c[l][3] = 0.f;
  const int rr = wm * 16 + 2 * gid;
  const int kb = half * (s.dp / 2), ke = kb + s.dp / 2;
  // feature rows k0 + tig (rsw = tig 8) and k0 + tig + 4 (tig 8 + 4); word
  // rows k0 + tig and k0 + tig + 4 (wsw = tig 8 for both)
  const float* pa = rb + tig * kRC + (rr ^ (tig << 3));
  const int o2 = 4 * kRC + (rr ^ ((tig << 3) | 4)) - (rr ^ (tig << 3));
  const float* pw = ws + tig * N;
#pragma unroll 2
  for (int k0 = kb; k0 < ke; k0 += 8) {
    const float* a = pa + k0 * kRC;
    const float2 a01 = *reinterpret_cast<const float2*>(a);
    const float2 a23 = *reinterpret_cast<const float2*>(a + o2);
    unsigned ah[4], al[4];
    split(a01.x, ah[0], al[0]);
    split(a01.y, ah[1], al[1]);
    split(a23.x, ah[2], al[2]);
    split(a23.y, ah[3], al[3]);
#pragma unroll
    for (int l = 0; l < LNT; ++l) {
      const float* w =
          pw + k0 * N + ((min(wn + 4 * l, NT - 1) * 8 + gid) ^ (tig << 3));
      unsigned bh0, bl0, bh1, bl1;
      split(w[0], bh0, bl0);
      split(w[4 * N], bh1, bl1);
      mma3(c[l], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  float* out = half ? l1 : l0;
#pragma unroll
  for (int l = 0; l < LNT; ++l) {
    const int nt = wn + 4 * l;
    if (nt < ntu) {
      const int n = nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(out + rr * LDL + n) =
          make_float2(c[l][0], c[l][1]);
      *reinterpret_cast<float2*>(out + (rr + 1) * LDL + n) =
          make_float2(c[l][2], c[l][3]);
    }
  }
}

// Lanes a softmax segment of len words takes: a power of two, at most
// kPerLane words a lane (len <= 32 kPerLane = 256 >= N)
constexpr int kPerLane = 8;
__device__ __forceinline__ int seg_lanes(int len) {
  int k = 1;
  while (k < 32 && k * kPerLane < len) k *= 2;
  return k;
}

__device__ __forceinline__ float group_max(float v, int k) {
  for (int o = 1; o < k; o *= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int k) {
  for (int o = 1; o < k; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block: image j and a group of captions (N word columns). The context
// ctx' (dp x N) runs on wgmma, a warpgroup's 64 feature rows (and 256 more
// for MTW = 2) by N / WN columns: warp w has row tiles w % WM (+ 16), column
// tiles (w / WM) NTW + l, l < NTW, in wgmma's accumulator layout.
// On the wide path (s.slices > 1, the long path) a launch takes one slice
// of D (words and regions at the slice's first row, s.d its rows) and runs
// the second pass alone, from the logits and statistics of
// damsm_logits_kernel, writing its cosine sums to the slice's wpart.
// ONLINE: the gamma1 offset is each column's running maximum (|gamma1|
// past kFixedGamma1), an instantiation of its own, so that the fixed
// offset's keeps its registers (48 context sums a thread) free of spills.
template <int MTW, int NTW, int WN, bool LNG, bool ONLINE>
__global__ void __launch_bounds__(kThreads, 1)
damsm_kernel(const float* __restrict__ words,
             const float* __restrict__ regions,
             const float* __restrict__ mask, float* __restrict__ sim,
             float* __restrict__ stats, float* __restrict__ kept,
             float* __restrict__ wpart, Shape s) {
  constexpr int N = 8 * NTW * WN, NW = N / WN, LDL = N + 4, WM = kWarps / WN;
  constexpr int OT = (N / 8 + kWarps - 1) / kWarps;  // ones tiles a warp
  extern __shared__ __align__(128) unsigned char dsm[];
  const uint32_t raw = tgfr::smem_u32(dsm);
  float* E = reinterpret_cast<float*>(dsm + (((raw + 1023u) & ~1023u) - raw));
  const uint32_t e_u32 = tgfr::smem_u32(E);
  float* ws = E + 2 * N * kRC;          // (dp, N) the block's word columns
  float* rg = ws + s.dp * N;            // 2 x (dp, 32) regions ring
  float* part = rg;                     // (3, kWarps, N) cosine partials,
                                        // over the ring once it is done
  float* l0 = rg + max(2 * s.dp * kRC, 3 * kWarps * N);   // (32, LDL)
  float* l1 = l0 + kRC * LDL;           // (32, LDL) logits, second half
  float* S = l1 + kRC * LDL;            // (N) gamma1 sums per word
  float* cm = S + N;                    // (N) word mask, 0 for padding
  float* zs = cm + N;                   // (N) smoothed cosines
  float* gm = zs + N;                   // (N) online: running gamma1 maxima
  float* gf = gm + N;                   // (N) online: their rescale factors
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool wide = LNG && s.slices > 1;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % WM, wn = warp / WM;
  const int j = blockIdx.y;
  const int i0 = LNG ? blockIdx.x : blockIdx.x * s.g;
  const int gcount = LNG ? 1 : min(s.g, s.b - i0);
  const int nwc = LNG ? (s.t + N - 1) / N : 1;
  const int nrc = (s.r + kRC - 1) / kRC;
  const float* rj = regions + (size_t)j * (LNG ? s.dld : s.d) * s.r;
  float* st = LNG ? stats + ((size_t)j * s.b + i0) * s.r * 2 : nullptr;
  float* lgp = LNG ? kept + ((size_t)j * s.b + i0) * s.r * s.tp : nullptr;
  float zmax = -FLT_MAX, zsum = 0.f;    // the long path's online LSE

  // pass 0: the long path's softmax statistics over words, per region;
  // pass 1: the context, the cosines and the log-sum-exp
  for (int pass = LNG && !wide ? 0 : 1; pass < 2; ++pass) {
    for (int wc = 0; wc < nwc; ++wc) {
      const int c0 = wc * N;
      const int ncols = LNG ? min(N, s.t - c0) : gcount * s.t;
      const int ntu = (ncols + 7) / 8, ncp = ntu * 8;
      // softmax segments: a caption's words (short), a chunk (long)
      const int slen = LNG ? ncols : s.t, nseg = LNG ? 1 : gcount;
      const int sk = seg_lanes(slen), groups = kThreads / sk;
      const int sg = tid / sk, sl = tid % sk;
      // the long path's second pass reads its logits back (tiles l0, l1
      // in turn) rather than recomputing them
      const bool reread = LNG && pass == 1;
      __syncthreads();   // the previous chunk is done with every buffer
      load_words<N, LNG>(ws, cm, words, mask, s, i0, c0, ncols, ncp);
      if constexpr (ONLINE)
        for (int n = tid; n < N; n += kThreads) gm[n] = -FLT_MAX;
      load_regions(rg, rj, s, 0);
      if (reread) load_logits(l0, lgp, s, 0, min(kRC, s.r), c0, ncp, LDL);
      float acc[MTW][4 * NTW], sacc[OT][4];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int k = 0; k < 4 * NTW; ++k) acc[mi][k] = 0.f;
#pragma unroll
      for (int o = 0; o < OT; ++o)
        sacc[o][0] = sacc[o][1] = sacc[o][2] = sacc[o][3] = 0.f;
      for (int c = 0; c < nrc; ++c) {
        cp_wait_all();
        __syncthreads();   // block c landed; block c - 1 is done with
        if (c + 1 < nrc) {
          load_regions(rg + ((c + 1) & 1) * s.dp * kRC, rj, s,
                       (c + 1) * kRC);
          if (reread)
            load_logits((c & 1) ? l0 : l1, lgp, s, (c + 1) * kRC,
                        min(kRC, s.r - (c + 1) * kRC), c0, ncp, LDL);
        }
        const float* rb = rg + (c & 1) * s.dp * kRC;
        const int r0 = c * kRC, rows = min(kRC, s.r - r0);
        // this chunk's logits: l0 (+ l1), or on a reread l1 for odd chunks
        const float* lt = reread && (c & 1) ? l1 : l0;
        if (!reread) {
          logits<N>(rb, ws, l0, l1, s, ntu, rows);
          __syncthreads();
        }
        // per (region, segment): lanes sl of group sg, sk lanes a segment,
        // a lane's (at most kPerLane) words in registers; every lane runs
        // the same rounds (the shuffles take all lanes). Exponents in base
        // 2: v log2 e, the statistics too. The gamma1 weights go to E,
        // split in hi and lo
        const float g1 = s.gamma1 * kLog2e, o1 = s.off1 * kLog2e;
        const int nq = rows * nseg;
        for (int q0 = 0; q0 < nq; q0 += groups) {
          const int q = q0 + sg;
          const bool act = q < nq;
          const int rr = act ? q / nseg : 0, g = act ? q % nseg : 0;
          const float* row = lt + rr * LDL + g * slen;
          const float* row1 = l1 + rr * LDL + g * slen;
          const float* mg = cm + g * slen;
          float v[kPerLane], mx = -FLT_MAX, sum = 0.f;
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            const int n = sl + u * sk;
            v[u] = !(act && n < slen) ? -FLT_MAX
                   : reread ? row[n]
                   : (row[n] + row1[n] + (mg[n] - 1.f) * kBig) * kLog2e;
            mx = fmaxf(mx, v[u]);
          }
          if (pass == 0 && act) {
            // keep the logits (masked, in base 2) for the second pass
            float* keep = lgp + (size_t)(r0 + rr) * s.tp + c0;
#pragma unroll
            for (int u = 0; u < kPerLane; ++u)
              if (sl + u * sk < slen) keep[sl + u * sk] = v[u];
          }
          float inv = 1.f;
          if (reread) {
            // the statistics of pass 0
            if (act) {
              const float* o = st + (size_t)(r0 + rr) * 2;
              mx = o[0];
              inv = 1.f / fmaxf(o[1], s.eps);
            }
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) v[u] = exp2f(v[u] - mx);
          } else {
            mx = group_max(mx, sk);
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
              v[u] = exp2f(v[u] - mx);
              sum += v[u];
            }
            sum = group_sum(sum, sk);
            if (!act) continue;
            if (pass == 0) {
              if (sl == 0) {
                float* o = st + (size_t)(r0 + rr) * 2;
                if (wc == 0) {
                  o[0] = mx;
                  o[1] = sum;
                } else {
                  const float m = fmaxf(o[0], mx);
                  o[1] = o[1] * exp2f(o[0] - m) + sum * exp2f(mx - m);
                  o[0] = m;
                }
              }
              continue;
            }
            inv = 1.f / fmaxf(sum, s.eps);
          }
          if (!act) continue;
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            const int n = sl + u * sk;
            if (n < slen) {
              if constexpr (ONLINE) {     // the exponent, raw, until the offset
                E[eix(g * slen + n, rr)] = g1 * (v[u] * inv);
              } else {
                const float e = exp2f(g1 * (v[u] * inv) - o1);
                unsigned hi, lo;
                split(e, hi, lo);
                const int at = eix(g * slen + n, rr);
                E[at] = __uint_as_float(hi);
                E[N * kRC + at] = __uint_as_float(lo);
              }
            }
          }
        }
        if (pass == 0) continue;
        if constexpr (ONLINE) {
          // each column's maximum over the block's regions raises its
          // running one (the rise's factor kept for the sums); then the
          // terms exp2(x - max), split
          __syncthreads();
          for (int n = tid; n < ncols; n += kThreads) {
            float m = -FLT_MAX;
            for (int q = 0; q < rows; ++q) m = fmaxf(m, E[eix(n, q)]);
            const float mo = gm[n], mn = fmaxf(mo, m);
            gm[n] = mn;
            gf[n] = exp2f(mo - mn);
          }
          __syncthreads();
          for (int e = tid; e < rows * ncols; e += kThreads) {
            const int n = e % ncols, at = eix(n, e / ncols);
            unsigned hi, lo;
            split(exp2f(E[at] - gm[n]), hi, lo);
            E[at] = __uint_as_float(hi);
            E[N * kRC + at] = __uint_as_float(lo);
          }
        }
        // regions past the last one weigh nothing
        const int kp = (rows + 7) / 8 * 8;
        for (int e = tid; e < (kp - rows) * N; e += kThreads) {
          const int at = eix(e % N, rows + e / N);
          E[at] = 0.f;
          E[N * kRC + at] = 0.f;
        }
        tgfr::fence_proxy_async();   // E, to wgmma's proxy
        __syncthreads();
        if constexpr (ONLINE) {
          // the context sums and S of a column whose maximum rose, scaled
          // (accumulator layouts: acc columns (wn NTW + l) 8 + 2 tig + h,
          // sacc columns (warp + 16 o) 8 + 2 tig + h)
#pragma unroll
          for (int l = 0; l < NTW; ++l)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = (wn * NTW + l) * 8 + 2 * tig + h;
              const float f = n < ncols ? gf[n] : 1.f;
#pragma unroll
              for (int mi = 0; mi < MTW; ++mi) {
                acc[mi][4 * l + h] *= f;
                acc[mi][4 * l + 2 + h] *= f;
              }
            }
#pragma unroll
          for (int o = 0; o < OT; ++o)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = (warp + kWarps * o) * 8 + 2 * tig + h;
              const float f = n < ncols ? gf[n] : 1.f;
              sacc[o][h] *= f;
              sacc[o][2 + h] *= f;
            }
        }
        // ctx' (dp x N) += regions_block (dp x 32) . E (32 x N), 3xTF32 on
        // wgmma, k-step by k-step: the A fragment (the warp's rows, a row
        // tile past dp reading the last one's rows, never read; regions
        // k0 + tig (+ 4), the ring swizzle fixed by d % 8 = gid) from the
        // ring, hi and lo in registers; E hi and lo through descriptors
        // (k-step k0 at byte 4 k0 of each row)
        const int sw = rsw(gid);
        const int x0 = tig ^ (sw & 4), x2 = (tig + 4) ^ (sw & 4);
#pragma unroll
        for (int k0 = 0; k0 < kRC; k0 += 8) {
          if (k0 >= kp) break;
          unsigned ah[MTW][4], al[MTW][4];
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            const int row = min((wm + WM * mi) * 16, s.dp - 16) + gid;
            const float* a = rb + row * kRC + (k0 ^ (sw & 24));
            split(a[x0], ah[mi][0], al[mi][0]);
            split(a[8 * kRC + x0], ah[mi][1], al[mi][1]);
            split(a[x2], ah[mi][2], al[mi][2]);
            split(a[8 * kRC + x2], ah[mi][3], al[mi][3]);
          }
          const uint32_t eb = e_u32 + wn * NW * 128 + k0 * 4;
          const uint64_t dh = tgfr::wg_desc(eb, 16, 1024);
          const uint64_t dl = tgfr::wg_desc(eb + N * 128, 16, 1024);
          tgfr::wgmma_fence();
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            WgTf32<NW>::mma(acc[mi], al[mi], dh);
            WgTf32<NW>::mma(acc[mi], ah[mi], dl);
            WgTf32<NW>::mma(acc[mi], ah[mi], dh);
          }
          tgfr::wgmma_commit();
          // the gamma1 sums S: a row of ones times E on mma.sync (ones are
          // exact in TF32: the low part, then the high), column tile
          // warp + 16 o of warp `warp`
#pragma unroll
          for (int o = 0; o < OT; ++o) {
            const int nt = warp + kWarps * o;
            if (nt < N / 8) {
              const int n = nt * 8 + gid;
              const unsigned h0 = __float_as_uint(E[eix(n, k0 + tig)]);
              const unsigned h1 = __float_as_uint(E[eix(n, k0 + tig + 4)]);
              const unsigned q0 =
                  __float_as_uint(E[N * kRC + eix(n, k0 + tig)]);
              const unsigned q1 =
                  __float_as_uint(E[N * kRC + eix(n, k0 + tig + 4)]);
              const unsigned one = 0x3f800000u;   // 1.0 in TF32
              const unsigned ones[4] = {one, one, one, one};
              mma(sacc[o], ones, q0, q1);
              mma(sacc[o], ones, h0, h1);
            }
          }
          tgfr::wgmma_wait<0>();
        }
      }
      if (pass == 0) continue;
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        const int nt = warp + kWarps * o;
        if (nt < N / 8 && gid == 0)
          *reinterpret_cast<float2*>(S + nt * 8 + 2 * tig) =
              make_float2(sacc[o][0], sacc[o][1]);
      }
      __syncthreads();   // S complete; the ring is free for the partials
      // cosine partials over the warp's feature rows, per word column
#pragma unroll
      for (int l = 0; l < NTW; ++l) {
        const int nt = wn * NTW + l;
        float q[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        if (nt < ntu) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = nt * 8 + 2 * tig + h;
            const float inv = 1.f / (n < ncols ? S[n] : 1.f);
#pragma unroll
            for (int mi = 0; mi < MTW; ++mi) {
              const int dd = (wm + WM * mi) * 16 + gid;
              if (dd < s.dp) {
                const float w0 = ws[dd * N + (n ^ wsw(dd))];
                const float w1 = ws[(dd + 8) * N + (n ^ wsw(dd + 8))];
                const float x0 = acc[mi][4 * l + h] * inv;
                const float x1 = acc[mi][4 * l + 2 + h] * inv;
                q[h][0] += w0 * x0 + w1 * x1;
                q[h][1] += w0 * w0 + w1 * w1;
                q[h][2] += x0 * x0 + x1 * x1;
              }
            }
          }
        }
        // sum the six values over the 8 lanes of a tig (lane bits 2-4):
        // each exchange halves the values a lane keeps, so lane gid ends
        // with value gid (h = gid / 3, k = gid % 3)
        const float v8[8] = {q[0][0], q[0][1], q[0][2], q[1][0], q[1][1],
                             q[1][2], 0.f, 0.f};
        float v4[4], v2[2];
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v4[i] = (b4 ? v8[i + 4] : v8[i]) +
                  __shfl_xor_sync(0xffffffffu, b4 ? v8[i] : v8[i + 4], 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          v2[i] = (b3 ? v4[i + 2] : v4[i]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? v4[i] : v4[i + 2], 8);
        const float y = (b2 ? v2[1] : v2[0]) +
                        __shfl_xor_sync(0xffffffffu, b2 ? v2[0] : v2[1], 4);
        if (gid < 6 && nt < ntu)
          part[((gid % 3) * kWarps + warp) * N + nt * 8 + 2 * tig + gid / 3] =
              y;
      }
      __syncthreads();
      // the WM warps of a column tile's owner set each wrote it
      for (int n = tid; n < ncols; n += kThreads) {
        const int own = (n / 8) / NTW;
        float num = 0.f, nw = 0.f, nc = 0.f;
        for (int w = 0; w < WM; ++w) {
          const int ww = own * WM + w;
          num += part[ww * N + n];
          nw += part[(kWarps + ww) * N + n];
          nc += part[(2 * kWarps + ww) * N + n];
        }
        if (wide) {   // the slice's three sums, for damsm_finish_kernel
          float* o = wpart + (((size_t)j * s.b + i0) * s.tp + c0 + n) * 3;
          o[0] = num;
          o[1] = nw;
          o[2] = nc;
          continue;
        }
        const float cs = num / fmaxf(sqrtf(nw) * sqrtf(nc), s.eps);
        zs[n] = cs * s.gamma2 + (cm[n] - 1.f) * kBig;
      }
      __syncthreads();
      // gamma2 log-sum-exp over each caption's words
      if (wide) continue;
      if (LNG) {
        if (warp == 0) {
          float mx = -FLT_MAX;
          for (int n = lane; n < ncols; n += 32) mx = fmaxf(mx, zs[n]);
          mx = tgfr::warp_max(mx);
          float sum = 0.f;
          for (int n = lane; n < ncols; n += 32) sum += expf(zs[n] - mx);
          sum = tgfr::warp_sum(sum);
          const float m = fmaxf(zmax, mx);
          zsum = zsum * expf(zmax - m) + sum * expf(mx - m);
          zmax = m;
          if (wc == nwc - 1 && lane == 0)
            sim[(size_t)j * s.b + i0] = logf(fmaxf(zsum, 1e-38f)) + zmax;
        }
      } else {
        for (int g = warp; g < gcount; g += kWarps) {
          const float* z = zs + g * s.t;
          float mx = -FLT_MAX;
          for (int n = lane; n < s.t; n += 32) mx = fmaxf(mx, z[n]);
          mx = tgfr::warp_max(mx);
          float sum = 0.f;
          for (int n = lane; n < s.t; n += 32) sum += expf(z[n] - mx);
          sum = tgfr::warp_sum(sum);
          if (lane == 0)
            sim[(size_t)j * s.b + i0 + g] = logf(fmaxf(sum, 1e-38f)) + mx;
        }
      }
    }
  }
}

// The wide path's first kernel: for pair (image j, caption i) and regions
// r0 .. r0 + 31 (blockIdx x, y, z = region block, caption, image), the
// logits over the whole of D, f32 FMA, words in tiles of 32 (a thread: 4
// regions by 2 words, D in chunks of 32 rows through shared memory),
// masked and in base 2 as the long path's first pass keeps them (`kept`),
// and each region's maximum and sum of exp2 over the words, merged over
// the word tiles as that pass merges its chunks (`stats`).
constexpr int kLgThreads = 128, kLgR = 32, kLgW = 32, kLgD = 32;

__global__ void __launch_bounds__(kLgThreads)
damsm_logits_kernel(const float* __restrict__ words,
                    const float* __restrict__ regions,
                    const float* __restrict__ mask, float* __restrict__ stats,
                    float* __restrict__ kept, Shape s) {
  __shared__ float rs[kLgD][kLgR];
  __shared__ float wt[kLgD][kLgW];
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int r0 = blockIdx.x * kLgR, i = blockIdx.y, j = blockIdx.z;
  const float* rj = regions + (size_t)j * s.dld * s.r;
  const float* wi = words + (size_t)i * s.dld * s.t;
  const size_t pair = (size_t)j * s.b + i;
  float mx[4], sum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    mx[a] = -FLT_MAX;
    sum[a] = 0.f;
  }
  for (int w0 = 0; w0 < s.t; w0 += kLgW) {
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int d0 = 0; d0 < s.dld; d0 += kLgD) {
      __syncthreads();   // the previous chunk is read
      for (int e = tid; e < kLgD * kLgR; e += kLgThreads) {
        const int dd = d0 + e / kLgR, rr = r0 + e % kLgR;
        rs[e / kLgR][e % kLgR] =
            dd < s.dld && rr < s.r ? rj[(size_t)dd * s.r + rr] : 0.f;
      }
      for (int e = tid; e < kLgD * kLgW; e += kLgThreads) {
        const int dd = d0 + e / kLgW, ww = w0 + e % kLgW;
        wt[e / kLgW][e % kLgW] =
            dd < s.dld && ww < s.t ? wi[(size_t)dd * s.t + ww] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kLgD; ++dd) {
        float rv[4], wv[2];
#pragma unroll
        for (int a = 0; a < 4; ++a) rv[a] = rs[dd][4 * rg + a];
#pragma unroll
        for (int c = 0; c < 2; ++c) wv[c] = wt[dd][cg + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[a][c] = fmaf(rv[a], wv[c], acc[a][c]);
      }
    }
    // masked, base 2; kept; the tile's maximum and sum merged per region
    // (the 16 lanes of a region group: lane bits 0-3)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = r0 + 4 * rg + a;
      float v[2], m = -FLT_MAX;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ww = w0 + cg + 16 * c;
        v[c] = -FLT_MAX;
        if (ww < s.t) {
          const float mk = mask ? mask[(size_t)i * s.t + ww] : 1.f;
          v[c] = (acc[a][c] + (mk - 1.f) * kBig) * kLog2e;
          if (rr < s.r) kept[(pair * s.r + rr) * s.tp + ww] = v[c];
        }
        m = fmaxf(m, v[c]);
      }
      for (int o = 1; o < 16; o *= 2)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float add = exp2f(v[0] - m) + exp2f(v[1] - m);
      for (int o = 1; o < 16; o *= 2)
        add += __shfl_xor_sync(0xffffffffu, add, o);
      const float mn = fmaxf(mx[a], m);
      sum[a] = sum[a] * exp2f(mx[a] - mn) + add * exp2f(m - mn);
      mx[a] = mn;
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rr = r0 + 4 * rg + a;
      if (rr < s.r) {
        stats[(pair * s.r + rr) * 2] = mx[a];
        stats[(pair * s.r + rr) * 2 + 1] = sum[a];
      }
    }
  }
}

// The wide path's last kernel: pair (image j = blockIdx.y, caption
// i = blockIdx.x), one warp: each word's three sums added over the slices
// in order, its cosine, and the gamma2 log-sum-exp over the words.
__global__ void __launch_bounds__(32)
damsm_finish_kernel(const float* __restrict__ wpart,
                    const float* __restrict__ mask, float* __restrict__ sim,
                    Shape s) {
  const int i = blockIdx.x, j = blockIdx.y, lane = threadIdx.x;
  const size_t slice = (size_t)s.b * s.b * s.tp * 3;
  const float* p = wpart + ((size_t)j * s.b + i) * s.tp * 3;
  auto z = [&](int n) {
    float num = 0.f, nw = 0.f, nc = 0.f;
    for (int k = 0; k < s.slices; ++k) {
      const float* o = p + k * slice + (size_t)n * 3;
      num += o[0];
      nw += o[1];
      nc += o[2];
    }
    const float cs = num / fmaxf(sqrtf(nw) * sqrtf(nc), s.eps);
    const float mk = mask ? mask[(size_t)i * s.t + n] : 1.f;
    return cs * s.gamma2 + (mk - 1.f) * kBig;
  };
  float mx = -FLT_MAX;
  for (int n = lane; n < s.t; n += 32) mx = fmaxf(mx, z(n));
  mx = tgfr::warp_max(mx);
  float sum = 0.f;
  for (int n = lane; n < s.t; n += 32) sum += expf(z(n) - mx);
  sum = tgfr::warp_sum(sum);
  if (lane == 0) sim[(size_t)j * s.b + i] = logf(fmaxf(sum, 1e-38f)) + mx;
}

// The tiling that takes dp features and n word columns: 0 (N 96, two
// warps a column tile), 1 (N 96), 2 (N 32, two 64-row context tiles a
// warpgroup), or -1 where none does
int tiling(int dp, int n) {
  return n == 96 && dp <= 128                ? 0
         : n == 96 && dp <= 256              ? 1
         : n == 32 && dp > 256 && dp <= 512  ? 2
                                             : -1;
}

// One launch, or on the wide path one a slice of D: its words and regions
// from the slice's first row, its rows in s.d, its share of wpart.
template <int MTW, int NTW, int WN>
cudaError_t launch(const float* words, const float* regions,
                   const float* mask, float* sim, float* stats, float* kept,
                   float* wpart, const Shape& s, size_t smem,
                   cudaStream_t stream) {
  const bool online = fabsf(s.gamma1) > kFixedGamma1;
  auto* k = s.lng ? (online ? damsm_kernel<MTW, NTW, WN, true, true>
                            : damsm_kernel<MTW, NTW, WN, true, false>)
                  : (online ? damsm_kernel<MTW, NTW, WN, false, true>
                            : damsm_kernel<MTW, NTW, WN, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(s.lng ? s.b : (s.b + s.g - 1) / s.g, s.b);
  for (int z = 0; z < s.slices && err == cudaSuccess; ++z) {
    Shape sz = s;
    sz.d = s.slices > 1 ? std::min(s.dp, s.d - z * s.dp) : s.d;
    k<<<grid, kThreads, smem, stream>>>(
        words + (size_t)z * s.dp * s.t, regions + (size_t)z * s.dp * s.r,
        mask, sim, stats, kept,
        wpart ? wpart + (size_t)z * s.b * s.b * s.tp * 3 : nullptr, sz);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Shared memory of a block, in bytes, as the kernel lays it out: 1024 to
// align E for wgmma, E's hi and lo tiles, the word tile, the region ring
// (reused by the cosine partials), the two logit tiles, and per word column
// its sum, mask, cosine, running gamma1 maximum and rescale factor; 0
// where no tiling takes (dp, n). ops/damsm.py `damsm_smem` is its copy for
// the CPU tests; a card test holds the two equal.
TGFR_API int tgfr_damsm_smem(int dp, int n) {
  if (dp < 16 || dp % 16 != 0 || tiling(dp, n) < 0) return 0;
  const int ring = std::max(2 * dp * kRC, 3 * kWarps * n);
  return 1024 + static_cast<int>(sizeof(float)) *
                    (2 * n * kRC + dp * n + ring + 2 * kRC * (n + 4) + 5 * n);
}

// words (b, d, t), regions (b, d, r), mask (b, t) f32 (1 = valid word) or
// null (all valid); sim (b, b), sim[j, i] for image j and caption i; on
// the long path f32 scratch stats (b, b, r, 2) and kept (b, b, r, t
// rounded up to 8), else null; on the wide path (slices > 1) also wpart
// (slices, b, b, t rounded up to 8, 3), else null. The plan (n: a block's
// word columns; g: captions a block; lng: the long path; slices: of D;
// smem) is ops/damsm.py `damsm_plan`, which holds its rules; this checks
// only that a tiling takes it and that its blocks stay inside their
// buffers.
TGFR_API int tgfr_damsm_similarity(const void* words, const void* regions,
                                   const void* mask, void* sim, void* stats,
                                   void* kept, void* wpart, int b, int d,
                                   int t, int r, int n, int g, int lng,
                                   int slices, long long smem, float gamma1,
                                   float gamma2, float eps, void* stream) {
  if (slices < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the rows of a slice of D (all of D where slices is 1)
  const int dp = ((d + slices - 1) / slices + 15) / 16 * 16;
  const int tile = tiling(dp, n);
  const bool wide = slices > 1;
  const bool ok = b >= 1 && t >= 1 && r >= 1 && tile >= 0 &&
                  (lng ? g == 1 && stats != nullptr && kept != nullptr
                       : g >= 1 && g * t <= n) &&
                  (!wide || (lng && wpart != nullptr &&
                             (slices - 1) * dp < d && dp <= kMaxSliceD)) &&
                  smem == tgfr_damsm_smem(dp, n);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Shape s{b, d, t, r, d, dp, g, lng,
          (r % 4 == 0 && reinterpret_cast<uintptr_t>(regions) % 16 == 0) |
              (t % 2 == 0 && reinterpret_cast<uintptr_t>(words) % 8 == 0) << 1,
          (t + 7) / 8 * 8, slices, gamma1, gamma2, eps, fmaxf(gamma1, 0.f)};
  const auto* w = static_cast<const float*>(words);
  const auto* rg = static_cast<const float*>(regions);
  const auto* m = static_cast<const float*>(mask);
  auto* out = static_cast<float*>(sim);
  auto* st = static_cast<float*>(stats);
  auto* kp = static_cast<float*>(kept);
  auto* wp = static_cast<float*>(wpart);
  const auto strm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wide) {
    damsm_logits_kernel<<<dim3((r + kLgR - 1) / kLgR, b, b), kLgThreads, 0,
                          strm>>>(w, rg, m, st, kp, s);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (tile == 0)
    err = launch<1, 6, 2>(w, rg, m, out, st, kp, wp, s, smem, strm);
  else if (tile == 1)
    err = launch<1, 12, 1>(w, rg, m, out, st, kp, wp, s, smem, strm);
  else
    err = launch<2, 4, 1>(w, rg, m, out, st, kp, wp, s, smem, strm);
  if (err == cudaSuccess && wide) {
    damsm_finish_kernel<<<dim3(b, b), 32, 0, strm>>>(wp, m, out, s);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
