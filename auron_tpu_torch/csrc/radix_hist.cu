// Per-tile radix bucket histogram of u32 words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// auron_tpu/ops/kernels_pallas.py::radix_bucket_hist (body
// _radix_hist_kernel): out[t, d] = the number of words of tile t whose top
// b_bits bits are d.  A tile is tile_rows x 128 consecutive words, and the
// caller picks tile_rows by the Pallas kernel's rule (min(n/128, 256),
// lowered until it divides n/128), so the output has the Pallas kernel's
// shape int32[n_tiles, 2^b_bits] for every n % 128 == 0.  b_bits is 0..8;
// 0 is one bucket that counts every word (no shift by 32, which C++ leaves
// undefined; XLA gives 0 there).
//
// The TPU kernel unrolled a compare-and-sum over all 2^b_bits buckets for
// every word, which suits a vector unit with no scatter.  Here one thread
// block owns one tile, its threads stride over the tile's words, and each
// word adds one to its bucket's counter in shared memory with an atomic;
// the block then writes its counters as one output row.  The work per
// word is a load, a shift and one shared-memory atomic, whatever b_bits.
//
// Bound: 4 bytes in per word and 4 * 2^b_bits bytes out per tile, so at
// 3.35 TB/s the kernel is bound by memory: 2^24 words take at least 20 us.
// At the shuffle writer's shapes (8,192 and ~0.5M words) the launch and
// one block's latency, not the bytes, set the time.  Warp-aggregated
// atomics or wider loads are later work, once a measurement asks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 256;
constexpr int kLanes = 128;

__global__ void radix_hist_kernel(const uint32_t* __restrict__ words,
                                  int32_t* __restrict__ out,
                                  int64_t tile_len, int b_bits) {
  __shared__ int32_t counts[kMaxBuckets];
  const int n_buckets = 1 << b_bits;
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const uint32_t* tile = words + (int64_t)blockIdx.x * tile_len;
  for (int64_t i = threadIdx.x; i < tile_len; i += blockDim.x) {
    const uint32_t w = tile[i];
    const uint32_t digit = b_bits ? (w >> (32 - b_bits)) : 0u;
    atomicAdd(&counts[digit], 1);
  }
  __syncthreads();
  int32_t* row = out + (int64_t)blockIdx.x * n_buckets;
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) row[i] = counts[i];
}

}  // namespace

// words: n u32 words (an int32 tensor's storage), out: int32[n_tiles,
// 2^b_bits], both on the device of `stream`; n is a multiple of
// tile_rows * 128.  Returns the launch's cudaGetLastError() code
// (0 = success), or cudaErrorInvalidValue for arguments outside the
// contract.
extern "C" int auron_radix_bucket_hist(const void* words, void* out,
                                       int64_t n, int tile_rows, int b_bits,
                                       void* stream) {
  if (b_bits < 0 || b_bits > 8 || tile_rows <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tile_len = (int64_t)tile_rows * kLanes;
  if (n % tile_len) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = n / tile_len;
  if (n_tiles == 0) return 0;
  radix_hist_kernel<<<(unsigned)n_tiles, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t*)out, tile_len, b_bits);
  return (int)cudaGetLastError();
}
