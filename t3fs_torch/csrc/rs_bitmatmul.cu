// Byte-plane GF(2) bit-matmul for any RS(k+m) code, for sm_90a.
//
// Replaces the TPU kernel _rs_kernel (t3fs/ops/pallas_codec.py:68), which
// serves both make_rs_encode_pallas (the parity bit matrix) and
// make_rs_reconstruct_pallas (a decode bit matrix).
//
// What it computes: out[j] = XOR over input shards i of M_ij(x[i]) for every
// byte position, where M_ij is the 8x8 GF(2) block of the (8w, 8k)
// plane-major bit matrix that maps bit plane b' of input shard i to bit
// plane b of output shard j.  The TPU kernel unpacked bytes to bit planes
// and ran a bf16 matrix product on the MXU.  The map is GF(2)-linear per
// byte, so on Hopper it is a table lookup instead: the host folds the bit
// matrix into, per input shard i and group g of up to four output shards,
// a table of 256 u32 entries whose byte jj is output shard 4g+jj's
// contribution of input byte value x (tables.bitmatmul_lut).  The tables,
// ceil(w/4) * k KiB, sit in shared memory; a thread XORs one entry per
// input byte into a u32 accumulator per byte position and finally
// transposes the accumulators' bytes into the output shards' words.
//
// One launch is one tile of the map (tables.b5_tile_plan): input shards
// i0..i0+ki-1 of the (n, k, L) input to output rows j0..j0+wj-1 of the (n,
// w, L) output, wj <= 8, its tables at most the 227 KiB of opt-in dynamic
// shared memory.  The offsets index the full tensors, so no slice is
// copied; with `accumulate` the tile XORs into the rows an earlier tile of
// its row group wrote.  Most codes are one tile; RAID-6 at k = 254 decodes
// in two, RS(12+12) encodes in two row groups.
//
// Bound on the H100: at RS(6+3) it is near the crossover between its two
// limits.  Bytes: (k + w) per byte position over 3.35 TB/s of HBM.  Shared
// memory: k * ceil(w/4) random 4-byte lookups per byte position; random
// indices put about 3.5 lanes of a warp on the busiest bank, so an SM serves
// about 9 lookups a clock, ~2.3e12 a second on the card, which is 3.5 TB/s
// of RS(6+3) traffic (6 lookups per 9 bytes).  Codes with larger k / (k+w)
// are bound by the lookups.  The measured time is in PERF.md.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 2;                  // wj <= 8 output shards a tile
constexpr int kMaxTableBytes = 227 * 1024;     // opt-in shared memory of a block

__device__ __forceinline__ void load_tables(uint32_t* T, const uint32_t* lut,
                                            int words) {
  for (int t = threadIdx.x; t < words; t += kThreads) T[t] = lut[t];
  __syncthreads();
}

// byte t of each of a0..a3, packed a0's lowest
__device__ __forceinline__ uint32_t gather_byte(uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3,
                                                int t) {
  const int sh = 8 * t;
  return ((a0 >> sh) & 0xFFu) | (((a1 >> sh) & 0xFFu) << 8) |
         (((a2 >> sh) & 0xFFu) << 16) | (((a3 >> sh) & 0xFFu) << 24);
}

// 16 byte positions per thread.  in: the tile's first input shard of an
// (n, k, lv) uint4 tensor; out: the tile's first output row of an (n, w, lv)
// one; lut: (NG, ki, 256) u32.
template <int NG>
__global__ void __launch_bounds__(kThreads)
bitmatmul_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                     const uint32_t* __restrict__ lut, int k, int ki, int w,
                     int wj, long long lv, long long total, bool accumulate) {
  extern __shared__ uint32_t T[];
  load_tables(T, lut, NG * ki * 256);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long s = idx / lv;
    const long long c = idx - s * lv;
    const uint4* x = in + s * k * lv + c;
    uint32_t acc[NG][16];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int p = 0; p < 16; ++p) acc[g][p] = 0u;
    for (int i = 0; i < ki; ++i) {
      const uint4 v = x[i * lv];
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      const uint32_t* Ti = T + i * 256;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t byte = (wd[q] >> (8 * p)) & 0xFFu;
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[g][4 * q + p] ^= Ti[g * ki * 256 + byte];
        }
    }
    uint4* o = out + s * w * lv + c;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) {
      if (j >= wj) break;
      const int g = j / 4, t = j % 4;
      uint4 r = make_uint4(
          gather_byte(acc[g][0], acc[g][1], acc[g][2], acc[g][3], t),
          gather_byte(acc[g][4], acc[g][5], acc[g][6], acc[g][7], t),
          gather_byte(acc[g][8], acc[g][9], acc[g][10], acc[g][11], t),
          gather_byte(acc[g][12], acc[g][13], acc[g][14], acc[g][15], t));
      if (accumulate) r ^= o[j * lv];
      o[j * lv] = r;
    }
  }
}

// One byte position per thread (lengths that are not a multiple of 16 or
// unaligned pointers).  in, out: the tile's first shard / row of (n, k, L)
// and (n, w, L) u8 tensors.
template <int NG>
__global__ void __launch_bounds__(kThreads)
bitmatmul_byte_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                      const uint32_t* __restrict__ lut, int k, int ki, int w,
                      int wj, long long L, long long total, bool accumulate) {
  extern __shared__ uint32_t T[];
  load_tables(T, lut, NG * ki * 256);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long s = idx / L;
    const long long c = idx - s * L;
    const uint8_t* x = in + s * k * L + c;
    uint32_t acc[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[g] = 0u;
    for (int i = 0; i < ki; ++i) {
      const uint32_t byte = x[i * L];
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[g] ^= T[(g * ki + i) * 256 + byte];
    }
    uint8_t* o = out + s * w * L + c;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) {
      if (j >= wj) break;
      uint8_t r = (uint8_t)(acc[j / 4] >> (8 * (j % 4)));
      if (accumulate) r ^= o[j * L];
      o[j * L] = r;
    }
  }
}

// Blocks for a grid-stride loop over `total` items: as many as are resident
// at once with `smem` bytes of tables each (at most 8 an SM: more would only
// reload the tables), fewer if they would have nothing to do.
template <typename K>
cudaError_t tile_grid(K kernel, size_t smem, long long total, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = grid_blocks(total, kThreads, per_sm < 8 ? per_sm : 8);
  return cudaSuccess;
}

template <int NG>
cudaError_t launch(const uint8_t* in, uint8_t* out, const uint32_t* lut,
                   long long n, int k, int ki, int w, int wj, long long L,
                   bool accumulate, cudaStream_t stream) {
  const size_t smem = (size_t)NG * ki * 256 * sizeof(uint32_t);
  const bool vec = (L % 16 == 0) && aligned16(in) && aligned16(out);
  int grid = 0;
  cudaError_t e;
  if (vec) {
    const long long lv = L / 16, total = n * lv;
    e = tile_grid(bitmatmul_vec_kernel<NG>, smem, total, &grid);
    if (e != cudaSuccess) return e;
    bitmatmul_vec_kernel<NG><<<grid, kThreads, smem, stream>>>(
        reinterpret_cast<const uint4*>(in), reinterpret_cast<uint4*>(out), lut,
        k, ki, w, wj, lv, total, accumulate);
  } else {
    const long long total = n * L;
    e = tile_grid(bitmatmul_byte_kernel<NG>, smem, total, &grid);
    if (e != cudaSuccess) return e;
    bitmatmul_byte_kernel<NG><<<grid, kThreads, smem, stream>>>(
        in, out, lut, k, ki, w, wj, L, total, accumulate);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One tile: shards (n, k, L) u8 inputs i0..i0+ki-1 -> rows j0..j0+wj-1 of
// out (n, w, L) u8, written, or XORed in when `accumulate` is nonzero; lut:
// (ceil(wj/4), ki, 256) u32 from tables.bitmatmul_lut of the tile's block.
// Takes the 16-byte path when L % 16 == 0 and both tile pointers are
// 16-byte aligned.
int t3fs_rs_bitmatmul(const void* shards, void* out, const void* lut,
                      long long n, int k, int i0, int ki, int w, int j0, int wj,
                      long long L, int accumulate, void* stream) {
  if (n <= 0 || L <= 0) return 0;
  const int groups = (wj + 3) / 4;
  if (ki < 1 || wj < 1 || i0 < 0 || i0 + ki > k || j0 < 0 || j0 + wj > w ||
      groups > kMaxGroups ||
      (size_t)groups * ki * 256 * sizeof(uint32_t) > kMaxTableBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(shards) + (long long)i0 * L;
  uint8_t* o = static_cast<uint8_t*>(out) + (long long)j0 * L;
  const uint32_t* T = static_cast<const uint32_t*>(lut);
  if (groups == 1)
    return (int)launch<1>(in, o, T, n, k, ki, w, wj, L, accumulate != 0, st);
  return (int)launch<2>(in, o, T, n, k, ki, w, wj, L, accumulate != 0, st);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
