// Per-tile radix bucket histogram of u32 words, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// auron_tpu/ops/kernels_pallas.py::radix_bucket_hist (body
// _radix_hist_kernel): out[t, d] = the number of words of tile t whose top
// b_bits bits are d.  A tile is tile_rows x 128 consecutive words, and the
// caller picks tile_rows by the Pallas kernel's rule (min(n/128, 256),
// lowered until it divides n/128), so the output has the Pallas kernel's
// shape int32[n_tiles, 2^b_bits] for every n % 128 == 0.  b_bits is 0..8;
// 0 is one bucket that counts every word.
//
// Bound: 4 bytes in per word and 4 * 2^b_bits bytes out per tile, a few
// integer operations per word, so the bound is bytes: 2^24 words take at
// least 20 us at 3.35 TB/s.  At the shuffle writers' shapes (8,192 and
// 524,288 words: 10 ns and 0.63 us of bytes) a single launch's floor, a
// few microseconds, sets the time, and what a design can cut is the chain
// of dependent memory round trips inside it.
//
// Design.  The Pallas tile rule gives a range map batch of 8,192 words
// one tile, so one block per tile would leave 131 of the 132 SMs idle.
// Instead each tile gets a thread-block cluster of C blocks (C, the
// largest power of two <= 8 dividing tile_rows, is chosen by the caller),
// and each block counts one slice of the tile, a whole number of 16-byte
// vectors:
// - each thread issues all of its uint4 loads (up to 4 at a time) before
//   its first atomic, so it waits for one memory latency, not one per
//   word;
// - each word adds one to its digit's shared counter with atomicAdd(p, 1),
//   which nvcc compiles to ATOMS.POPC.INC: the hardware adds the number of
//   a warp's lanes that hit one address in one operation, so padding or a
//   null partition (a warp of one digit) is not serialized.  Aggregating
//   by hand with __match_any_sync was measured 1.4x slower at 8,192 words
//   and 5x slower at 2^24 on an H100 (MATCH.ANY per word);
// - after a cluster barrier, block r sums its share of the buckets over
//   all C blocks' shared counters through distributed shared memory
//   (cluster.map_shared_rank) and writes that share of the tile's row; a
//   second barrier keeps every block's shared memory alive until the
//   other blocks have read it.
// One launch, no global atomics and no memset; the counts are exact, so
// the output is bit-identical to the plain version.
//
// Not used, and why: TMA / cp.async.bulk, because every word is read once
// straight into registers, so staging it through shared memory saves
// nothing; tensor cores, because a digit count has no matrix product in
// it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 256;
constexpr int kLanes = 128;
constexpr int kBatch = 4;          // uint4 loads in flight per thread
constexpr int kMaxCluster = 8;     // the portable cluster size

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint4* __restrict__ words, int32_t* __restrict__ out,
                  int64_t slice_vecs, int b_bits) {
  __shared__ int32_t counts[kMaxBuckets];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t n_buckets = 1u << b_bits;
  for (uint32_t i = threadIdx.x; i < n_buckets; i += blockDim.x)
    counts[i] = 0;
  __syncthreads();

  // a shift of the word in 64 bits, so b_bits 0 shifts by 32 and gives 0
  const int shift = 32 - b_bits;
  const uint4* slice = words + (int64_t)blockIdx.x * slice_vecs;
  for (int64_t base = 0; base < slice_vecs; base += kBatch * kThreads) {
    uint4 v[kBatch];
    bool have[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      have[j] = i < slice_vecs;
      v[j] = have[j] ? slice[i] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (!have[j]) continue;
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        atomicAdd(&counts[(uint64_t)w[k] >> shift], 1);
    }
  }

  cluster.sync();
  const unsigned c = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  // block r owns buckets [r * share, (r + 1) * share); with fewer buckets
  // than blocks, block 0 owns them all
  const uint32_t share = n_buckets >= c ? n_buckets / c : n_buckets;
  const uint32_t d = rank * share + threadIdx.x;
  if (threadIdx.x < share && d < n_buckets) {
    int32_t sum = 0;
    // unrolled, so the C remote reads are in flight together
#pragma unroll
    for (unsigned q = 0; q < kMaxCluster; ++q)
      if (q < c) sum += cluster.map_shared_rank(counts, q)[d];
    out[(int64_t)(blockIdx.x / c) * n_buckets + d] = sum;
  }
  cluster.sync();
}

}  // namespace

// words: n u32 words (an int32 tensor's storage, 16-byte aligned), out:
// int32[n_tiles, 2^b_bits], both on the device of `stream`; n is a
// multiple of tile_rows * 128, and `cluster` (1, 2, 4 or 8) divides
// tile_rows.  Launches n_tiles clusters of `cluster` blocks.  Returns the
// launch's error code (0 = success), or cudaErrorInvalidValue for
// arguments outside the contract.
extern "C" int auron_radix_bucket_hist(const void* words, void* out,
                                       int64_t n, int tile_rows, int cluster,
                                       int b_bits, void* stream) {
  if (b_bits < 0 || b_bits > 8 || tile_rows <= 0 || n < 0 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      tile_rows % cluster || (uintptr_t)words % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t tile_len = (int64_t)tile_rows * kLanes;
  if (n % tile_len) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = n / tile_len;
  if (n_tiles == 0) return 0;
  const int64_t slice_vecs = tile_len / cluster / 4;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, radix_hist_kernel, (const uint4*)words, (int32_t*)out,
      slice_vecs, b_bits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
