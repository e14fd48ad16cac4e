// Philox bit dumps (K10-K12 of the port): words [0, per) of the streams
// seed + j, j < layers, into out (layers, per) uint32. The one kernel behind
// ops/philox.py `attn_stream_bits` (K10: layers 1, the attention stream),
// `ffn_stream_bits` (K11: layers 1, the FFN stream, whose seed the wrapper
// xors) and `tower_stream_bits` (K12: one row per layer).
//
// Replaces: tools/verify_block_prng.py, `dump_bits` (K10), the
// `dump1_kernel` call (K11) and `dumpL` (K12): the TPU kernels that dump
// the Mosaic PRNG's stream so that prng mode can be held bit for bit
// against host-bits mode fed the same bits. Here they dump the port's own
// stream (ops/philox.py states the contract), the one the half-layer and
// tower kernels draw in-kernel (csrc/common.cuh `philox_word`).
//
// Bound on the H100: operations, narrowly. A 4-word Philox4x32-10 block is
// about 100 integer operations (10 rounds of two 32 x 32 products, four
// xors and two key additions), 25 a word, against the 4 bytes a word
// writes: 25 / 16.75e12 s against 4 / 3.35e12 s. Design: one thread per
// 4-word block, the four words stored as one 16-byte vector where the row
// length allows; no shared memory; a grid-stride loop.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_dump_kernel(const int* __restrict__ seed, int layers, long long per,
                   unsigned* __restrict__ out) {
  const long long blocks = (per + 3) / 4;   // Philox blocks per layer
  const long long total = blocks * layers;
  const unsigned s = static_cast<unsigned>(__ldg(seed));
  const bool vec = per % 4 == 0;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
       q < total; q += (long long)gridDim.x * kThreads) {
    const int j = static_cast<int>(q / blocks);
    const unsigned long long c = q - (long long)j * blocks;
    const uint4 w = tgfr::philox4x32_10(
        make_uint4(static_cast<unsigned>(c), static_cast<unsigned>(c >> 32),
                   0u, 0u), s + static_cast<unsigned>(j), 0u);
    unsigned* dst = out + (size_t)j * per + 4 * c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = w;
    } else {
      const unsigned v[4] = {w.x, w.y, w.z, w.w};
      for (int k = 0; k < 4 && 4 * (long long)c + k < per; ++k) dst[k] = v[k];
    }
  }
}

}  // namespace

// seed: (1,) int32 on the device; out: (layers, per) uint32, 16-byte
// aligned.
TGFR_API int tgfr_philox_dump(const void* seed, int layers, long long per,
                                void* out, void* stream) {
  if (layers < 1 || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (per + 3) / 4 * layers;
  const long long want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  philox_dump_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), layers, per, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
