// Hash partition ids for one int64 shuffle key, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// auron_tpu/ops/kernels_pallas.py::hash_partition_ids_i64 (body
// _pid_kernel): pid = pmod(murmur3_x86_32_spark(key, seed 42), n_parts),
// with a null key keeping the seed, so its pid is 42 % n_parts.
//
// The TPU kernel needed a host pre-pass that split the keys into (lo, hi)
// uint32 planes, viewed rows as (rows/128, 128) lanes and required
// cap % 128 == 0.  None of that carries over: the kernel reads the int64
// keys and the bool validity straight from the column tensors, splits the
// words in registers and writes the int32 pids.  Any n >= 0 and any
// n_parts >= 1 are taken.
//
// Bound: 13 bytes a row (8 key + 1 validity + 4 pid) and about 30 integer
// operations a row, so the bound is bytes: 2^24 rows take at least 65 us
// at 3.35 TB/s, and the shuffle writer's 499,499 rows 1.9 us.
//
// Design: a streaming pass with 16-byte accesses that fits in one wave.
// Each thread takes four rows: two 16-byte key loads, one 4-byte load of
// the four validity bytes and one 16-byte store of the four pids, so a
// warp moves whole 128-byte lines with a quarter of the instructions of
// one row per thread.  The grid is ceil(n / 1024) blocks of 256 threads
// (488 at 499,499 rows, under one wave of 132 SMs x 8 blocks), capped at
// one wave, with a grid-stride loop beyond.  Rows past the last group of
// four, and a whole launch whose three base pointers are not all 16-byte
// aligned (a view such as keys[1:]), go through a scalar loop of one row
// per thread; both paths call one hash function.  No shared memory, TMA
// or tensor cores: each byte is used once and the work per row is a few
// integer operations, so there is nothing to stage or to multiply.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int64_t kMaxBlocks = 132 * 8;    // one wave of resident blocks

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

// The pid of one row: the one hash both paths call.
__device__ __forceinline__ int32_t pid_of(int64_t key, bool valid,
                                          int n_parts) {
  uint32_t h = 42u;
  if (valid) {
    const uint64_t v = (uint64_t)key;
    h = mix_h1(h, mix_k1((uint32_t)v));
    h = mix_h1(h, mix_k1((uint32_t)(v >> 32)));
    h = fmix(h, 8u);
  }
  // Spark's pmod of the signed hash: the C remainder, moved to >= 0
  const int32_t r = (int32_t)h % n_parts;
  return r < 0 ? r + n_parts : r;
}

// Rows [first, n), one per thread of the grid, in a grid-stride loop.
__device__ __forceinline__ void scalar_rows(const int64_t* keys,
                                            const bool* valid, int32_t* out,
                                            int64_t first, int64_t n,
                                            int n_parts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = pid_of(keys[i], valid[i], n_parts);
}

// keys, valid and out 16-byte aligned: groups of four rows by vectors,
// then the tail of n % 4 rows.
__global__ void __launch_bounds__(kThreads)
hash_pid_i64_vec_kernel(const int64_t* __restrict__ keys,
                        const bool* __restrict__ valid,
                        int32_t* __restrict__ out, int64_t n, int n_parts) {
  const int64_t n_groups = n / kRowsPerThread;
  const longlong2* keys2 = reinterpret_cast<const longlong2*>(keys);
  const uint32_t* valid4 = reinterpret_cast<const uint32_t*>(valid);
  int4* out4 = reinterpret_cast<int4*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_groups; g += stride) {
    const longlong2 a = keys2[2 * g];
    const longlong2 b = keys2[2 * g + 1];
    const uint32_t v = valid4[g];
    int4 r;
    r.x = pid_of(a.x, v & 0xFFu, n_parts);
    r.y = pid_of(a.y, (v >> 8) & 0xFFu, n_parts);
    r.z = pid_of(b.x, (v >> 16) & 0xFFu, n_parts);
    r.w = pid_of(b.y, v >> 24, n_parts);
    out4[g] = r;
  }
  scalar_rows(keys, valid, out, n_groups * kRowsPerThread, n, n_parts);
}

// Any alignment: one row per thread.
__global__ void __launch_bounds__(kThreads)
hash_pid_i64_scalar_kernel(const int64_t* __restrict__ keys,
                           const bool* __restrict__ valid,
                           int32_t* __restrict__ out, int64_t n,
                           int n_parts) {
  scalar_rows(keys, valid, out, 0, n, n_parts);
}

}  // namespace

// keys: int64[n], valid: bool[n], out: int32[n], all on the device of
// `stream`.  Returns the launch's cudaGetLastError() code (0 = success).
extern "C" int auron_hash_pid_i64(void* keys, void* valid, void* out,
                                  int64_t n, int n_parts, void* stream) {
  if (n <= 0) return 0;
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)keys | (uintptr_t)valid |
                        (uintptr_t)out) % 16 == 0;
  const int64_t rows_per_block =
      (int64_t)kThreads * (aligned ? kRowsPerThread : 1);
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (aligned)
    hash_pid_i64_vec_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const bool*)valid, (int32_t*)out, n,
        n_parts);
  else
    hash_pid_i64_scalar_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const bool*)valid, (int32_t*)out, n,
        n_parts);
  return (int)cudaGetLastError();
}
