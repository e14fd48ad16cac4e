// DAMSM word-region similarity matrix (K9 of the port): for every caption i
// and image j, attend i's words over j's regions and gamma2-smooth the
// per-word cosines into sim[j, i].
//
// Replaces: text_guided_face_recognition_tpu/ops/damsm_pallas.py, `_kernel`
// reached through `damsm_similarity_pallas` (the forward of the custom VJP
// `damsm_similarity_fused`; its backward recomputes through the plain
// function, in the port as in JAX).
//
// Bound on the H100: operations, in f32. At B = 32, D = 256, T = 22,
// R = 196 the two contractions per (i, j) pair (logits R x T x D and the
// attended context T x R x D) are 4.5 GFLOP of f32 FMA against < 7 MB of
// inputs. Both stay f32 FMA (no TF32), so the kernel holds to the f32 plain
// version at 1e-4.
// Design: the TPU kernel keeps one image's (R, B*T) logits in VMEM
// (550 KB), more than an SM's shared memory. Here one block runs one
// (caption i, image j) pair, 32 x 32 = 1024 blocks, with a (R, T) logit
// tile (17 KB at the shapes above) in shared memory:
//   (1) logits[r, t] = regions_j[:, r] . words_i[:, t], the regions
//       streamed through shared memory 32 feature rows at a time, each
//       thread accumulating up to 20 (r, t) pairs in registers;
//   (2) the softmax over words per region (invalid words at -1e30, the
//       sum clamped at eps); (3) the gamma1 softmax over regions per word;
//   (4) the attended context w[t] = sum_r q[r, t] regions_j[:, r], a second
//       pass over the regions;
//   (5) the cosine of each word with its context (norms clamped at eps);
//   (6) the gamma2 log-sum-exp over valid words, written to sim[j, i].
// Image j's regions (200 KB) are read twice by each of its 32 blocks; all
// regions (6.4 MB) stay in the 50 MB L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 20;      // (r, t) logits per thread: r * t <= 5120
constexpr int kDChunk = 32;   // feature rows of regions staged at a time
constexpr float kBig = 1e30f; // masking without -inf, as the TPU kernel

__global__ void __launch_bounds__(kThreads)
damsm_kernel(const float* __restrict__ words, const float* __restrict__ regions,
             const float* __restrict__ mask, float* __restrict__ sim, int nb,
             int d, int t, int r, float gamma1, float gamma2, float eps) {
  extern __shared__ float sm[];
  const int i = blockIdx.x, j = blockIdx.y;  // caption i, image j
  const int rl = r + 1;                      // padded region-chunk row
  float* ws = sm;                  // (d, t) words of caption i
  float* at = ws + d * t;          // (r, t) logits -> both softmaxes
  float* rc = at + r * t;          // (kDChunk, r + 1) regions chunk
  float* wc = rc + kDChunk * rl;   // (t, d) attended context
  float* zs = wc + t * d;          // (t) smoothed cosines
  const float* wi = words + (size_t)i * d * t;
  const float* rj = regions + (size_t)j * d * r;
  const float* mi = mask ? mask + (size_t)i * t : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < d * t; e += kThreads) ws[e] = wi[e];

  auto stage = [&](int d0, int nd) {   // regions_j rows d0 .. d0 + nd
    __syncthreads();
    for (int e = tid; e < nd * r; e += kThreads) {
      const int dd = e / r, rr = e % r;
      rc[dd * rl + rr] = rj[(size_t)(d0 + dd) * r + rr];
    }
    __syncthreads();
  };

  // (1) logits
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    const int nd = min(kDChunk, d - d0);
    stage(d0, nd);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kThreads;
      if (e < r * t) {
        const int rr = e / t, tt = e % t;
        float s = acc[k];
        for (int dd = 0; dd < nd; ++dd)
          s = fmaf(rc[dd * rl + rr], ws[(d0 + dd) * t + tt], s);
        acc[k] = s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < r * t) {
      const float m = mi ? mi[e % t] : 1.f;
      at[e] = acc[k] + (m - 1.f) * kBig;
    }
  }
  __syncthreads();

  // (2) softmax over words, per region
  for (int rr = tid; rr < r; rr += kThreads) {
    float* row = at + rr * t;
    float mx = -FLT_MAX;
    for (int tt = 0; tt < t; ++tt) mx = fmaxf(mx, row[tt]);
    float sum = 0.f;
    for (int tt = 0; tt < t; ++tt) {
      row[tt] = expf(row[tt] - mx);
      sum += row[tt];
    }
    sum = fmaxf(sum, eps);
    for (int tt = 0; tt < t; ++tt) row[tt] /= sum;
  }
  __syncthreads();

  // (3) gamma1 softmax over regions, per word: one warp per word
  for (int tt = warp; tt < t; tt += kThreads / 32) {
    float mx = -FLT_MAX;
    for (int rr = lane; rr < r; rr += 32) mx = fmaxf(mx, at[rr * t + tt]);
    mx = tgfr::warp_max(mx * gamma1);
    float sum = 0.f;
    for (int rr = lane; rr < r; rr += 32) {
      const float e = expf(at[rr * t + tt] * gamma1 - mx);
      at[rr * t + tt] = e;
      sum += e;
    }
    sum = fmaxf(tgfr::warp_sum(sum), eps);
    for (int rr = lane; rr < r; rr += 32) at[rr * t + tt] /= sum;
  }

  // (4) attended context: lane = feature row in the chunk, warp = word
  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    const int nd = min(kDChunk, d - d0);
    stage(d0, nd);
    if (lane < nd) {
      const float* reg = rc + lane * rl;
      for (int tt = warp; tt < t; tt += kThreads / 32) {
        float s = 0.f;
        for (int rr = 0; rr < r; ++rr) s = fmaf(at[rr * t + tt], reg[rr], s);
        wc[tt * d + d0 + lane] = s;
      }
    }
  }
  __syncthreads();

  // (5) cosine of each word with its context: one warp per word
  for (int tt = warp; tt < t; tt += kThreads / 32) {
    float num = 0.f, nw = 0.f, nc = 0.f;
    for (int dd = lane; dd < d; dd += 32) {
      const float a = ws[dd * t + tt], c = wc[tt * d + dd];
      num = fmaf(a, c, num);
      nw = fmaf(a, a, nw);
      nc = fmaf(c, c, nc);
    }
    num = tgfr::warp_sum(num);
    nw = tgfr::warp_sum(nw);
    nc = tgfr::warp_sum(nc);
    if (lane == 0) {
      const float cs = num / fmaxf(sqrtf(nw) * sqrtf(nc), eps);
      const float m = mi ? mi[tt] : 1.f;
      zs[tt] = cs * gamma2 + (m - 1.f) * kBig;
    }
  }
  __syncthreads();

  // (6) log-sum-exp over words
  if (warp == 0) {
    float mx = -FLT_MAX;
    for (int tt = lane; tt < t; tt += 32) mx = fmaxf(mx, zs[tt]);
    mx = tgfr::warp_max(mx);
    float sum = 0.f;
    for (int tt = lane; tt < t; tt += 32) sum += expf(zs[tt] - mx);
    sum = tgfr::warp_sum(sum);
    if (lane == 0) sim[(size_t)j * nb + i] = logf(fmaxf(sum, 1e-38f)) + mx;
  }
}

}  // namespace

// words (b, d, t), regions (b, d, r), mask (b, t) f32 (1 = valid word) or
// null (all valid); sim (b, b), sim[j, i] for image j and caption i.
TGFR_API int tgfr_damsm_similarity(const void* words, const void* regions,
                                     const void* mask, void* sim, int b,
                                     int d, int t, int r, float gamma1,
                                     float gamma2, float eps, void* stream) {
  if (r * t > kPer * kThreads || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)(2 * d * t + r * t + kDChunk * (r + 1) + t) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(damsm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  damsm_kernel<<<dim3(b, b), kThreads, smem, s>>>(
      static_cast<const float*>(words), static_cast<const float*>(regions),
      static_cast<const float*>(mask), static_cast<float*>(sim), b, d, t, r,
      gamma1, gamma2, eps);
  return static_cast<int>(cudaGetLastError());
}
