// SWAR helpers shared by the word kernels (RAID-6 encode, RAID-6 decode,
// repair): GF(2^8) multiply-by-x on four packed bytes, and XOR on 16-byte
// vectors.  _build.py hashes this header into every library's name, so an
// edit here rebuilds every kernel that includes it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Multiply each of the four bytes of x by x in GF(2^8): shift each byte
// left and, where its high bit was set, XOR the poly's low byte (0x1D for
// 0x11D) into it.  The per-byte 0/1 high-bit mask times `low` carries no
// bit across bytes.
__device__ __forceinline__ uint32_t xtimes(uint32_t x, uint32_t low) {
  return ((x << 1) & 0xFEFEFEFEu) ^ (((x >> 7) & 0x01010101u) * low);
}
__device__ __forceinline__ uint4 xtimes(uint4 v, uint32_t low) {
  return make_uint4(xtimes(v.x, low), xtimes(v.y, low), xtimes(v.z, low),
                    xtimes(v.w, low));
}
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4& operator^=(uint4& a, uint4 b) {
  a = a ^ b;
  return a;
}

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ uint32_t zero<uint32_t>() { return 0u; }
template <> __device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// Blocks for a grid-stride loop over `total` items: enough to cover them,
// at most `per_sm` per SM.
inline int grid_blocks(long long total, int threads, int per_sm = 16) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (total + threads - 1) / threads;
  const long long cap = (long long)per_sm * (sms > 0 ? sms : 1);
  return (int)(want < cap ? want : cap);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
