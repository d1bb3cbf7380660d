// CRC32C of byte rows of any length, for sm_90a, as a binary tensor-core
// product.
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
// bf16 (R, 4096) @ (4096, 32) product on the MXU; here it is the word
// kernel's (crc_words.cu, B1) binary tensor-core product, its operand A,
// epilogue and run fold, all from crc_common.cuh: bit i of word w of a
// segment is bit i % 8 of its byte 4w + i / 8, so B1's A reads the bytes as
// they lie.
//
// What is this kernel's own:
//   - segments are counted from the row's end: segment s covers row bytes
//     [L - (S - s) * 512, L - (S - s - 1) * 512).  Only segment 0 can start
//     before the row; its missing bytes read as zero, never copied into a
//     padded buffer;
//   - a row of L bytes starts at byte r * L, which for L % 16 != 0 is not
//     16-byte aligned, so lane (g, t) assembles its chunks 4q + t of
//     segments g and 8 + g (load_unit below);
//   - a row is ceil(S / 16) runs, a warp's unit each: the row's first run is
//     ragged (S % 16 segments, or 16), so it holds the front-padded segment
//     0 and P[last segment] of the row's last run is the identity.  Each
//     unit's folded partial goes to partial[unit], and crc_fold_kernel XORs
//     each row's runs (skipped when a row is one run).
//
// Bound on the H100: bytes, every input byte read once, 64 x 4 MiB /
// 3.35 TB/s = 80.1 us.  The tables (20 KiB) are read once per block; the
// product costs 4 mma a segment.  No ring: B goes straight into registers
// (116 of them a thread), so two blocks of 8 warps share an SM and one
// warp's loads fly while another multiplies.
//
// Why this design (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 14 and
// t3fs_torch/benchmarks/b1_probe.py, see PERF.md): the nibble-lookup design
// it replaces read 179.2-180.4 us at 64 x 4 MiB and 209.9-210.1 us with the
// rows unaligned; this kernel reads 103.0-105.0 and 110.8-114.8 us there.
// With each chunk loaded as the lookup design did (one uint4 where aligned,
// else five aligned u32 loads and four funnel shifts that wait on them,
// chunk by chunk) it read 117.2-118.6 and 214.3-217.7 us.

#include "crc_common.cuh"

namespace {

constexpr int kSegBytes = 512;
constexpr int kBlocksPerSm = 2;

// Bytes sh..sh+15 of the 32 bytes lo:hi (little-endian).
__device__ __forceinline__ uint4 byte_shift(const uint4& lo, const uint4& hi,
                                            int sh) {
  uint32_t w0, w1, w2, w3, w4;
  switch (sh >> 2) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  const uint32_t b = 8u * (uint32_t)(sh & 3);
  return make_uint4(__funnelshift_r(w0, w1, b), __funnelshift_r(w1, w2, b),
                    __funnelshift_r(w2, w3, b), __funnelshift_r(w3, w4, b));
}

// The bytes of the word at row offset o that lie in the row (o >= 0).
__device__ __forceinline__ uint32_t in_row(long long o) {
  return o >= 0 ? ~0u : o <= -4 ? 0u : ~0u << (8 * (int)(-o));
}

__device__ __forceinline__ uint4 shfl4(const uint4& v, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src),
                    __shfl_sync(0xffffffffu, v.w, src));
}

// B of one unit: x[nt][q] = chunk 4q + t of the unit's segment 8 nt + g,
// whose first byte lies at row offset off0 + (8 nt + g) * 512; zeros for
// columns past ncols and for row offsets below 0 (the front pad).
//
// The chunks of a row share one misalignment sh.  Each lane loads the
// aligned uint4 that holds its chunk's first byte, the lanes t = 0 also the
// 33rd aligned uint4 that ends the segment (when sh != 0), and each lane
// takes the next aligned uint4 from the lane that holds it (t + 1, or for
// t = 3 the lane t = 0 of the next q) by shuffles, then shifts the pair by
// sh bytes.  Every load is an aligned uint4 holding at least one byte of
// the row (aligned uint4s wholly before the row are not loaded but read as
// zero), so none leaves the row's allocation; bytes before the row start
// are masked to zero after the shift.
__device__ __forceinline__ void load_unit(const uint8_t* __restrict__ row,
                                          long long off0, int ncols, int lane,
                                          uint4 (&x)[2][8]) {
  const int g = lane >> 2, t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15u);
  const int sh = (int)((mis + off0) & 15);
  uint4 last[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 8 * nt + g;
    const bool valid = col < ncols;
    // row offset of the aligned uint4 holding the segment's first byte
    const long long p0 =
        ((mis + off0 + (long long)col * kSegBytes) & ~15LL) - mis;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long long p = p0 + 16 * (4 * q + t);
      x[nt][q] = valid && p > -16 ? *reinterpret_cast<const uint4*>(row + p)
                                  : zero;
    }
    last[nt] = valid && sh && t == 0
                   ? *reinterpret_cast<const uint4*>(row + p0 + kSegBytes)
                   : zero;
  }
  if (sh) {
    const int src = (lane & ~3) | ((t + 1) & 3);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 give = t ? x[nt][q] : q < 7 ? x[nt][q + 1] : last[nt];
        x[nt][q] = byte_shift(x[nt][q], shfl4(give, src), sh);
      }
  }
  if (off0 < 0) {                              // the row's first run only
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long o =
            off0 + (long long)(8 * nt + g) * kSegBytes + 16 * (4 * q + t);
        x[nt][q].x &= in_row(o);
        x[nt][q].y &= in_row(o + 4);
        x[nt][q].z &= in_row(o + 8);
        x[nt][q].w &= in_row(o + 12);
      }
  }
}

// A warp takes units [nunits * w / W, nunits * (w + 1) / W) of the W warps:
// an even deal.  Unit u is run j = u % runs of row u / runs; run j covers
// the row's segments [max(0, e - 16), e), e = nseg - 16 (runs - 1 - j).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
crc_bytes_kernel(const uint8_t* __restrict__ rows, long long L, int nseg,
                 int runs, long long nunits, const uint32_t* __restrict__ amat,
                 const uint32_t* __restrict__ shift_bytes,
                 const uint32_t* __restrict__ comb_cols,
                 uint32_t* __restrict__ out) {
  __shared__ Tables T;
  load_tables(T, amat, shift_bytes);
  const int lane = threadIdx.x & 31;
  const long long nw = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long begin = nunits * w / nw, end = nunits * (w + 1) / nw;
  for (long long u = begin; u < end; ++u) {
    const long long r = u / runs;
    const int j = (int)(u - r * runs);
    const int s_end = nseg - kUnitSegs * (runs - 1 - j);
    const int s0 = s_end > kUnitSegs ? s_end - kUnitSegs : 0;
    const int ncols = s_end - s0;
    uint4 x[2][8];
    load_unit(rows + r * L, L - (long long)(nseg - s0) * kSegBytes, ncols,
              lane, x);
    int d[2][2][4] = {};                       // [m-tile][n-tile][c0..c3]
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 xq[2] = {x[0][q], x[1][q]};
      mma_chunk(T, q, xq, ncols > 8, lane, d);
    }
    uint32_t v[2][2];
    unit_epilogue(d, lane, v);
    const uint32_t acc =
        fold_run(T, v, ncols, comb_cols[(s_end - 1) * 32 + lane], lane);
    if (lane == 0) out[u] = acc;
  }
}

}  // namespace

extern "C" {

// rows: (n, L) u8 back to back, any L >= 1 and any base address -> out:
// (n,) raw CRC of each row front-padded to nseg = ceil(L / 512) segments.
// partial is scratch of n * ceil(nseg / 16) u32 (unused when nseg <= 16).
// amat: the (32, 128) u32 CRC matrix (CodecTables.crc_mma_a); comb_cols:
// (nseg, 32) packed columns of P[s]; shift_bytes: Mb^512 as four byte
// tables (CodecTables.seg_shift_bytes).
int t3fs_crc32c_bytes_raw(const void* rows, long long n, long long L, int nseg,
                          const void* amat, const void* comb_cols,
                          const void* shift_bytes, void* partial, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  if (L <= 0 || nseg != (int)((L + kSegBytes - 1) / kSegBytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int runs = (nseg + kUnitSegs - 1) / kUnitSegs;
  const long long nunits = n * (long long)runs;
  const long long want = (nunits + kWarps - 1) / kWarps;
  const long long cap = (long long)kBlocksPerSm * sm_count();
  crc_bytes_kernel<<<(int)(want < cap ? want : cap), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(rows), L, nseg, runs, nunits,
      static_cast<const uint32_t*>(amat),
      static_cast<const uint32_t*>(shift_bytes),
      static_cast<const uint32_t*>(comb_cols),
      static_cast<uint32_t*>(runs == 1 ? out : partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || runs == 1) return (int)e;
  crc_fold_kernel<<<(unsigned)n, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(partial), runs, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
