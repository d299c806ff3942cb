// Hash partition ids for one int64 shuffle key, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// auron_tpu/ops/kernels_pallas.py::hash_partition_ids_i64 (body
// _pid_kernel): pid = pmod(murmur3_x86_32_spark(key, seed 42), n_parts),
// with a null key keeping the seed, so its pid is 42 % n_parts.
//
// The TPU kernel needed a host pre-pass that split the keys into (lo, hi)
// uint32 planes, viewed rows as (rows/128, 128) lanes and required
// cap % 128 == 0.  None of that carries over: here one thread owns one row
// in a grid-stride loop, reads the int64 key and the bool validity
// straight from the column tensors, splits the words in registers and
// writes the int32 pid.  Any n >= 0 and any n_parts >= 1 are taken.
//
// Bound: the kernel moves 13 bytes a row (8 key + 1 validity + 4 pid) and
// does about 30 integer operations a row, so at 3.35 TB/s it is bound by
// memory: 2^24 rows take at least 65 us.  A batch of 8192 rows is ~106 KB,
// about 32 ns of memory time, so there the launch latency, not the bytes,
// sets the time.  The design is the simple one on purpose: coalesced
// 8-byte loads per warp and no shared memory.  Wider loads or fusing the
// pid into the producer are later work, once a measurement asks for them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void hash_pid_i64_kernel(const int64_t* __restrict__ keys,
                                    const bool* __restrict__ valid,
                                    int32_t* __restrict__ out, int64_t n,
                                    int n_parts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = 42u;
    if (valid[i]) {
      const uint64_t v = (uint64_t)keys[i];
      h = mix_h1(h, mix_k1((uint32_t)v));
      h = mix_h1(h, mix_k1((uint32_t)(v >> 32)));
      h = fmix(h, 8u);
    }
    // Spark's pmod of the signed hash: the C remainder, moved to >= 0
    const int32_t r = (int32_t)h % n_parts;
    out[i] = r < 0 ? r + n_parts : r;
  }
}

}  // namespace

// keys: int64[n], valid: bool[n], out: int32[n], all on the device of
// `stream`.  Returns the launch's cudaGetLastError() code (0 = success).
extern "C" int auron_hash_pid_i64(void* keys, void* valid, void* out,
                                  int64_t n, int n_parts, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; larger n loops
  if (blocks > 132 * 32) blocks = 132 * 32;
  hash_pid_i64_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const bool*)valid, (int32_t*)out, n, n_parts);
  return (int)cudaGetLastError();
}
