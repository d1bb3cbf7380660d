// CRC32C of byte rows of any length, for sm_90a.
//
// Replaces the TPU kernel _crc_seg_kernel (t3fs/ops/pallas_codec.py:116,
// launched by make_crc_seg_pallas) and the segment-combine einsum that
// make_crc32c_raw_fast runs after it (pallas_codec.py:170-191).
//
// What it computes: for each of n rows of L bytes, packed back to back, the
// raw CRC32C (init 0, no final xor) of the row front-padded with zero bytes
// to S = ceil(L / 512) whole segments -- the front pad of
// jax_codec.make_crc32c_batch.  Raw CRC is zero-preserving, so the caller
// XORs the affine constant of the true length L and gets the CRC32C of the
// row.  The TPU unpacked each (R, 512) block to plane-major bits and ran a
// bf16 (R, 4096) @ (4096, 32) product on the MXU; here, as in the word
// kernel (crc_words.cu, B1), it is a nibble-table lookup with the tables and
// warp reductions of crc_common.cuh.
//
// Why a kernel of its own: a row of L bytes starts at byte r * L, which for
// odd L is not 4- or 16-byte aligned, and the first segment of a row whose
// L is not a multiple of 512 is partial.  So:
//   - segments are counted from the row's end: segment s covers row bytes
//     [L - (S - s) * 512, L - (S - s - 1) * 512).  Only segment 0 can start
//     before the row; its missing bytes are zero, read as such and never
//     copied into a padded buffer;
//   - lane l of the segment's warp takes segment bytes 16l..16l+15 (the
//     words 4l..4l+3 of B1's layout).  Where they lie 16-byte aligned it
//     loads one uint4; otherwise five aligned u32 loads and four funnel
//     shifts (every aligned word it touches holds one of its own bytes, so
//     no load leaves the row's allocation); lanes in the front pad load byte
//     by byte under a bound check.
// The segment combine is B1's: a warp folds a run of `spw` segments of one
// row by Horner (acc = Mb^512 . acc ^ seg), applies P[last segment of the
// run], and crc_fold_kernel XORs each row's runs (skipped when a row is one
// run).
//
// Bound on the H100: memory, as B1.  Every input byte is read once; the
// unaligned path issues five 4-byte loads per 16 bytes, which coalesce into
// the same sectors.

#include "crc_common.cuh"

namespace {

constexpr int kSegBytes = 512;

// The 16 bytes at row offset q (q may be negative: the front pad).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row,
                                        long long q) {
  if (q >= 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + q);
    if ((a & 15u) == 0) return *reinterpret_cast<const uint4*>(a);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const uint32_t sh = (uint32_t)(a & 3u) * 8u;
    if (sh == 0) return make_uint4(w[0], w[1], w[2], w[3]);
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
    return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                      __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const long long o = q + b;
    if (o >= 0) v[b >> 2] |= (uint32_t)row[o] << (8 * (b & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
crc_bytes_kernel(const uint8_t* __restrict__ rows, long long L, int nseg,
                 int spw, long long nruns, const uint32_t* __restrict__ table,
                 const uint32_t* __restrict__ comb_cols,
                 const uint32_t* __restrict__ shift_cols,
                 uint32_t* __restrict__ out) {
  extern __shared__ uint32_t T[];
  load_table(T, table);

  const int lane = threadIdx.x & 31;
  const uint32_t shift_col = shift_cols[lane];
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long run = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       run < nruns; run += stride) {
    // spw divides nseg, so a run's segments lie in one row
    const long long seg0 = run * spw;
    const long long r = seg0 / nseg;
    const int s0 = (int)(seg0 - r * nseg);
    const uint8_t* row = rows + r * L;
    // row offset of this lane's first byte in segment s0
    long long q = L - (long long)(nseg - s0) * kSegBytes + 16 * lane;
    uint32_t acc = 0;
    uint4 v = load16(row, q);
    for (int t = 0; t < spw; ++t) {
      // issue the next segment's load before this one's lookups
      const uint4 next = (t + 1 < spw) ? load16(row, q + kSegBytes) : v;
      acc = matvec(shift_col, acc, lane) ^ segment_crc(T, v, lane);
      v = next;
      q += kSegBytes;
    }
    acc = matvec(comb_cols[(s0 + spw - 1) * 32 + lane], acc, lane);
    if (lane == 0) out[run] = acc;
  }
}

}  // namespace

extern "C" {

// rows: (n, L) u8 back to back, any L >= 1 and any base address -> out:
// (n,) raw CRC of each row front-padded to nseg = ceil(L / 512) segments.
// spw divides nseg; partial is scratch of n * nseg / spw u32 (unused when
// spw == nseg).  comb_cols: (nseg, 32) packed columns of the combine stack,
// shift_cols: (32,) of Mb^512, table: the nibble table (crc_common.cuh).
int t3fs_crc32c_bytes_raw(const void* rows, long long n, long long L, int nseg,
                          int spw, const void* table, const void* comb_cols,
                          const void* shift_cols, void* partial, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  if (L <= 0 || nseg != (int)((L + kSegBytes - 1) / kSegBytes) || spw <= 0 ||
      nseg % spw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      crc_bytes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTableBytes);
  if (e != cudaSuccess) return (int)e;
  const int runs_per_row = nseg / spw;
  const long long nruns = n * (long long)runs_per_row;
  uint32_t* dst = static_cast<uint32_t*>(runs_per_row == 1 ? out : partial);
  crc_bytes_kernel<<<grid_for(nruns), kThreads, kTableBytes, s>>>(
      static_cast<const uint8_t*>(rows), L, nseg, spw, nruns,
      static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(comb_cols),
      static_cast<const uint32_t*>(shift_cols), dst);
  e = cudaGetLastError();
  if (e != cudaSuccess || runs_per_row == 1) return (int)e;
  crc_fold_kernel<<<(unsigned)n, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(partial), runs_per_row,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
