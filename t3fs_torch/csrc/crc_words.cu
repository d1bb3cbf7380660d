// CRC32C of 512-byte segments on packed little-endian words, for sm_90a.
//
// Replaces the TPU kernel _crc_words_kernel (t3fs/ops/pallas_codec.py:310,
// launched by make_crc_seg_words_pallas) and the segment-combine matmul
// that make_crc32c_words_raw runs after it (pallas_codec.py:385-402).
//
// What it computes: the raw CRC32C (init 0, no final xor, zero-preserving)
// of each 512-byte segment, and for t3fs_crc32c_words_raw the raw CRC of
// each whole chunk of `nseg` segments.  Raw CRC is GF(2)-linear in the
// message bits, so a segment's CRC is the XOR of one 32-bit column per set
// bit.  The TPU ran that as 32 int8 bit-plane matmuls on the MXU; here it is
// a table lookup per 4-bit nibble:
//
//   - one warp per segment; lane l loads words 4l..4l+3 as one 16-byte
//     vector (a warp reads the segment's 512 bytes in one coalesced load);
//   - the table holds, per (word, nibble position, nibble value), the XOR of
//     that nibble's columns: 64 KiB of dynamic shared memory, laid out as
//     crc_common.cuh says (shared with the byte kernel, crc_bytes.cu);
//   - 32 lookups per lane, then an XOR reduction over the warp (shuffles).
//
// Chunk combine: raw(chunk) = XOR_s P[s] . raw(seg_s), P[s] = Mb^(512(S-1-s)).
// A warp folds a run of `spw` consecutive segments of one chunk by Horner
// (acc = Mb^512 . acc ^ seg), then applies P[last segment of the run]; a
// GF(2) matrix-vector product is one AND per lane (lane i holds column i)
// and a warp XOR reduction.  A second small kernel XORs each chunk's runs.
//
// Bound on the H100: memory.  The work is a few integer operations per
// byte against 3.35 TB/s of HBM; every input byte is read once, the table
// is read from L2 once per block, and the outputs are 4 bytes per run.

#include "crc_common.cuh"

namespace {

template <bool kFold>
__global__ void __launch_bounds__(kThreads)
crc_seg_kernel(const uint4* __restrict__ words, long long nruns, int spw,
               int nseg, const uint32_t* __restrict__ table,
               const uint32_t* __restrict__ comb_cols,
               const uint32_t* __restrict__ shift_cols,
               uint32_t* __restrict__ out) {
  extern __shared__ uint32_t T[];
  load_table(T, table);

  const int lane = threadIdx.x & 31;
  const uint32_t shift_col = kFold ? shift_cols[lane] : 0u;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long run = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       run < nruns; run += stride) {
    const long long seg0 = run * spw;
    uint32_t acc = 0;
    uint4 v = words[seg0 * 32 + lane];
    for (int t = 0; t < spw; ++t) {
      // issue the next segment's load before this one's lookups
      const uint4 next = (t + 1 < spw) ? words[(seg0 + t + 1) * 32 + lane] : v;
      const uint32_t x = segment_crc(T, v, lane);
      acc = kFold ? (matvec(shift_col, acc, lane) ^ x) : x;
      v = next;
    }
    if (kFold) {
      const long long s_last = (seg0 + spw - 1) % nseg;
      acc = matvec(comb_cols[s_last * 32 + lane], acc, lane);
    }
    if (lane == 0) out[run] = acc;
  }
}

template <bool kFold>
cudaError_t launch_seg(const void* words, long long nruns, int spw, int nseg,
                       const void* table, const void* comb_cols,
                       const void* shift_cols, void* out, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      crc_seg_kernel<kFold>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTableBytes);
  if (e != cudaSuccess) return e;
  crc_seg_kernel<kFold><<<grid_for(nruns), kThreads, kTableBytes, stream>>>(
      static_cast<const uint4*>(words), nruns, spw, nseg,
      static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(comb_cols),
      static_cast<const uint32_t*>(shift_cols), static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: (R, 128) u32, 16-byte aligned -> out: (R,) raw CRC of each segment.
int t3fs_crc_seg_words(const void* rows, long long R, const void* table,
                       void* out, void* stream) {
  if (R <= 0) return 0;
  return (int)launch_seg<false>(rows, R, 1, 1, table, nullptr, nullptr, out,
                                static_cast<cudaStream_t>(stream));
}

// words: (n, nseg * 128) u32, 16-byte aligned -> out: (n,) raw CRC of each
// chunk.  spw divides nseg; partial is scratch of n * nseg / spw u32.
int t3fs_crc32c_words_raw(const void* words, long long n, int nseg, int spw,
                          const void* table, const void* comb_cols,
                          const void* shift_cols, void* partial, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  if (spw <= 0 || nseg % spw) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nruns = n * (long long)(nseg / spw);
  cudaError_t e = launch_seg<true>(words, nruns, spw, nseg, table, comb_cols,
                                   shift_cols, partial, s);
  if (e != cudaSuccess) return (int)e;
  crc_fold_kernel<<<(unsigned)n, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(partial), nseg / spw,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
