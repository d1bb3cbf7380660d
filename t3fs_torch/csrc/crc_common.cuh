// The CRC32C pieces of the word kernel (crc_words.cu, B1) and the byte
// kernel (crc_bytes.cu, B6).  Both use the block shape, the warp reductions,
// the GF(2) matrix-vector product and the kernel that XORs a chunk's run
// partials; the nibble table, its lookups and grid_for are B6's only (B1
// multiplies on the tensor cores).  _build.py hashes this header into every
// library's name, so an edit here rebuilds both.
//
// Raw CRC32C (init 0, no final xor) is GF(2)-linear in the message bits, so
// a 512-byte segment's CRC is the XOR of one 32-bit column per set bit.  The
// nibble table holds, per (word w of the segment, nibble j of the word,
// nibble value v), the XOR of that nibble's columns: 128 * 8 * 16 u32 = 64
// KiB of dynamic shared memory, laid out [j][v][w % 4][w / 4] so that when
// lane l holds words 4l..4l+3 the 32 lanes of a lookup hit 32 distinct banks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTableWords = 8 * 16 * 4 * 32;
constexpr int kTableBytes = kTableWords * 4;
constexpr int kBlocksPerSm = 3;   // 64 KiB of table each fits three per SM

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = M . x over GF(2); lane i holds column i of M.
__device__ __forceinline__ uint32_t matvec(uint32_t col, uint32_t x, int lane) {
  return warp_xor(((x >> lane) & 1u) ? col : 0u);
}

// XOR of the table terms of one word: i = w % 4 (vector component).
__device__ __forceinline__ uint32_t word_terms(const uint32_t* T, uint32_t w,
                                               int i, int lane) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t nib = (w >> (4 * j)) & 15u;
    acc ^= T[((j * 16 + nib) * 4 + i) * 32 + lane];
  }
  return acc;
}

// The warp's XOR of its lanes' 16 bytes: the raw CRC of one segment.
__device__ __forceinline__ uint32_t segment_crc(const uint32_t* T, uint4 v,
                                                int lane) {
  return warp_xor(word_terms(T, v.x, 0, lane) ^ word_terms(T, v.y, 1, lane) ^
                  word_terms(T, v.z, 2, lane) ^ word_terms(T, v.w, 3, lane));
}

__device__ __forceinline__ void load_table(uint32_t* T,
                                           const uint32_t* __restrict__ table) {
  for (int i = threadIdx.x; i < kTableWords; i += kThreads) T[i] = table[i];
  __syncthreads();
}

// out[c] = XOR of the runs_per_chunk partials of chunk c (one block each).
__global__ void __launch_bounds__(kThreads)
crc_fold_kernel(const uint32_t* __restrict__ partial, int runs_per_chunk,
                uint32_t* __restrict__ out) {
  __shared__ uint32_t red[kWarps];
  const uint32_t* p = partial + (long long)blockIdx.x * runs_per_chunk;
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < runs_per_chunk; i += kThreads) acc ^= p[i];
  acc = warp_xor(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t r = 0;
    for (int w = 0; w < kWarps; ++w) r ^= red[w];
    out[blockIdx.x] = r;
  }
}

// Blocks for `nruns` warp-sized work items, at most kBlocksPerSm per SM.
inline int grid_for(long long nruns) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (nruns + kWarps - 1) / kWarps;
  const long long cap = (long long)kBlocksPerSm * (sms > 0 ? sms : 1);
  return (int)(want < cap ? want : cap);
}

}  // namespace
