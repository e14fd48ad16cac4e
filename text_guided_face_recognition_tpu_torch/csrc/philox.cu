// Philox bit dumps (K10-K12 of the port): words [0, per) of the streams
// (seed ^ key_xor) + j, j < layers, into out (layers, per) uint32. The one
// kernel behind ops/philox.py `attn_stream_bits` (K10: layers 1, the
// attention stream, key_xor 0), `ffn_stream_bits` (K11: layers 1, the FFN
// stream, key_xor 0x5BD1E995) and `tower_stream_bits` (K12: one row per
// layer, key_xor 0).
//
// Replaces: tools/verify_block_prng.py, `dump_bits` (K10), the
// `dump1_kernel` call (K11) and `dumpL` (K12): the TPU kernels that dump
// the Mosaic PRNG's stream so that prng mode can be held bit for bit
// against host-bits mode fed the same bits. Here they dump the port's own
// stream (ops/philox.py states the contract), the one the half-layer and
// tower kernels draw in-kernel (csrc/common.cuh `philox4x32_10`).
//
// Bound on the H100: the bytes written, 4 a word at 3.35e12 B/s. The work
// is 20 integer operations a word (a 4-word Philox4x32-10 block: 10 rounds
// of two 32 x 32 products, each a high and a low half, and four xors; the
// key schedule is the row's, once a thread), but NVIDIA's data sheet gives
// no 32-bit integer rate, so that count enters no bound (chip_smoke.py
// holds the same account).
//
// Design. One launch a dump: the FFN site's xor is applied to the key here,
// not by a separate elementwise kernel on the seed. A row is a grid row
// (blockIdx.y = j), so no thread divides a 64-bit counter by the row
// length; inside a row the block counter is 32 bits (the host refuses a
// row of 2^32 blocks or more), its high counter word 0. Each thread takes
// one Philox block, so every store of a warp writes 512 consecutive bytes
// as 16-byte vectors (on the H100 2, 4 and 8 blocks a thread were slower
// for K10 and K11 and at most 2.3 % faster for K12; PERF.md, K10-K12). A
// row whose length is not a multiple of 4 stores its last block word by
// word, every other block as a vector (a row that starts off a 16-byte
// boundary, j per not a multiple of 4, stores all its words one by one).
// `tgfr_empty_kernel` launches a kernel that does nothing: the floor of a
// kernel node in a CUDA graph, which chip_smoke.py prints beside K10-K12.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_dump_kernel(const int* __restrict__ seed, unsigned key_xor,
                   unsigned blocks, unsigned tail, unsigned long long per,
                   unsigned* __restrict__ out) {
  const unsigned c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= blocks) return;
  const unsigned key =
      (static_cast<unsigned>(__ldg(seed)) ^ key_xor) + blockIdx.y;
  const uint4 w = tgfr::philox4x32_10(make_uint4(c, 0u, 0u, 0u), key, 0u);
  unsigned* row = out + blockIdx.y * per;
  unsigned* dst = row + 4ull * c;
  const unsigned n = c + 1 < blocks ? 4u : tail;
  if (n == 4 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = w;
  } else {
    dst[0] = w.x;
    if (n > 1) dst[1] = w.y;
    if (n > 2) dst[2] = w.z;
    if (n > 3) dst[3] = w.w;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// seed: (1,) int32 on the device; out: (layers, per) uint32. Row j holds
// words [0, per) of stream (seed ^ key_xor) + j.
TGFR_API int tgfr_philox_dump(const void* seed, unsigned key_xor, int layers,
                              long long per, void* out, void* stream) {
  // a row's Philox blocks fit a 32-bit counter; rows fit the grid's y
  if (layers < 1 || layers > 65535 || per < 1 || per > 4 * 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long blocks = (per + 3) / 4;
  const unsigned tiles =
      static_cast<unsigned>((blocks + kThreads - 1) / kThreads);
  philox_dump_kernel<<<dim3(tiles, layers), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), key_xor,
      static_cast<unsigned>(blocks),
      static_cast<unsigned>(per - 4 * (blocks - 1)),
      static_cast<unsigned long long>(per), static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

TGFR_API int tgfr_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
