// CRC32C of 512-byte segments on packed little-endian words, for sm_90a, as
// a binary tensor-core product.
//
// Replaces the TPU kernel _crc_words_kernel (t3fs/ops/pallas_codec.py:310,
// launched by make_crc_seg_words_pallas) and the segment-combine matmul
// that make_crc32c_words_raw runs after it (pallas_codec.py:366-402).
//
// What it computes: the raw CRC32C (init 0, no final xor, zero-preserving)
// of each 512-byte segment, and for t3fs_crc32c_words_raw the raw CRC of
// each whole chunk of `nseg` segments.  The TPU ran the segment CRC as 32
// int8 bit-plane matmuls on the MXU.  Here it is the binary tensor-core
// product of crc_common.cuh (mma.sync.m16n8k256.b1.and.popc, 4 mma a
// segment, its operand A, epilogue and run fold shared with the byte
// kernel B6), which reads the packed words as they lie in memory.  What is
// this kernel's own is the feed:
//
//   - each warp streams its units through its own ring of 3 stages of 8 KiB
//     in shared memory, cp.async 16 bytes a lane (a warp instruction copies
//     one whole segment) two units ahead of the one it multiplies, so 16 KiB
//     a warp, 128 KiB an SM, stay in flight; odd segments swap their 64-byte
//     halves in the ring so the fragment reads of a quarter-warp hit
//     distinct banks;
//   - a unit is one run of `spw` (<= 16, dividing nseg) consecutive
//     segments of one chunk, folded as crc_common.cuh says;
//     t3fs_crc_seg_words takes units of 16 rows of any R, the last one
//     ragged (its missing columns load zeros and are not stored).
//
// Why this design (NVIDIA H100 80GB HBM3, 700 W; measured by
// t3fs_torch/benchmarks/b1_probe.py and chip_smoke.py, see PERF.md): the
// nibble-lookup design it replaces read 167.9-168.1 us at 64 x 4 MiB
// against the 80.1 us byte bound, and 306 / 184 / 167 us with its grid
// capped at 1 / 2 / 3 blocks an SM: past two blocks more warps bought
// little, as it sat near the rate of its ~160 integer instructions a
// segment.  mma.sync m16n8k256 b1 sustains 0.666 mma a clock per SM (the s8
// rate), so the 2.1 M mma of that call cost ~14 us of tensor-core time.
// This kernel reads 106.7-109.5 us there; with B loaded straight into
// registers instead of through the ring it read the same, 108.4-109.0 us.
//
// Bound on the H100: bytes.  Every input byte is read once from HBM, 64 x
// 4 MiB / 3.35 TB/s = 80.1 us; the tables are read from L2 once per block
// (one block an SM) and the outputs are 4 bytes a run.

#include "crc_common.cuh"

namespace {

constexpr int kStages = 3;          // a warp's ring: one unit in use, two loading
constexpr int kStageU4 = kUnitSegs * 32;   // one unit, 8 KiB

// dynamic shared memory: the tables, then each warp's ring (212 KiB)
constexpr size_t kSmemBytes =
    sizeof(Tables) + sizeof(uint4) * kWarps * kStages * kStageU4;

// Where chunk c (16 bytes) of segment j of a unit sits in its ring stage:
// segments 512 bytes apart start on one bank, so odd segments swap their
// chunk halves of 64 bytes, and the 8 lanes of a quarter-warp (segments g,
// g + 1, chunks 4q..4q+3) read 8 distinct bank quads.
__device__ __forceinline__ int ring_at(int j, int c) {
  return j * 32 + (c ^ ((j & 1) << 2));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// One unit into a ring stage: lane l copies chunk l of each of the unit's
// 16 segments, so a warp's copy instruction reads one whole segment.
__device__ __forceinline__ void load_unit(uint4* stage,
                                          const uint4* __restrict__ words,
                                          long long seg0, int ncols, int lane) {
#pragma unroll
  for (int j = 0; j < kUnitSegs; ++j) {
    const bool valid = j < ncols;
    cp_async16(stage + ring_at(j, lane),
               valid ? words + (seg0 + j) * 32 + lane : words, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The CRCs of the unit's ncols (<= 16) segments in `stage`: on return lane
// (g, t) holds column 8 nt + 2 t + p in v[nt][p].
__device__ __forceinline__ void unit_crcs(const Tables& T, const uint4* stage,
                                          int ncols, int lane,
                                          uint32_t (&v)[2][2]) {
  const int g = lane >> 2, t = lane & 3;
  int d[2][2][4] = {};                         // [m-tile][n-tile][c0..c3]
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 x[2] = {stage[ring_at(g, 4 * q + t)],
                        stage[ring_at(8 + g, 4 * q + t)]};
    mma_chunk(T, q, x, ncols > 8, lane, d);
  }
  unit_epilogue(d, lane, v);
}

__device__ __forceinline__ int unit_cols(long long u, long long total,
                                         int unit_segs) {
  const long long left = total - u * unit_segs;
  return left < unit_segs ? (int)left : unit_segs;
}

// A warp takes units [nunits * w / W, nunits * (w + 1) / W) of the W warps:
// an even deal, with no ragged last wave.  kFold: a unit is one run of spw
// segments, its folded partial written to out[unit]; else a unit is 16 rows
// of the `total` rows, each row's CRC written to out[row].  Each warp keeps
// its own ring of kStages units, filled by cp.async kStages - 1 units ahead
// of the one it multiplies.
template <bool kFold>
__global__ void __launch_bounds__(kThreads, 1)
crc_mma_kernel(const uint4* __restrict__ words, long long nunits,
               long long total, int unit_segs, int nseg,
               const uint32_t* __restrict__ amat,
               const uint32_t* __restrict__ shift_bytes,
               const uint32_t* __restrict__ comb_cols,
               uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  Tables& T = *reinterpret_cast<Tables*>(smem);
  load_tables(T, amat, shift_bytes);
  const int lane = threadIdx.x & 31;
  uint4* ring = smem + sizeof(Tables) / sizeof(uint4) +
                (threadIdx.x >> 5) * kStages * kStageU4;
  const long long nw = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long begin = nunits * w / nw, end = nunits * (w + 1) / nw;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const long long u = begin + s;
    if (u < end)
      load_unit(ring + s * kStageU4, words, u * unit_segs,
                unit_cols(u, total, unit_segs), lane);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (long long u = begin; u < end; ++u) {
    const int st = (int)((u - begin) % kStages);
    const long long next = u + kStages - 1;  // into the stage used last round
    if (next < end)
      load_unit(ring + ((st + kStages - 1) % kStages) * kStageU4, words,
                next * unit_segs, unit_cols(next, total, unit_segs), lane);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncwarp();
    const long long seg0 = u * unit_segs;
    const int ncols = unit_cols(u, total, unit_segs);
    uint32_t v[2][2];
    unit_crcs(T, ring + st * kStageU4, ncols, lane, v);
    __syncwarp();                              // the stage is refilled next round
    if (!kFold) {
      if (lane < 4)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int col = 8 * nt + 2 * lane + p;
            if (col < ncols) out[seg0 + col] = v[nt][p];
          }
      continue;
    }
    const long long s_last = (seg0 + ncols - 1) % nseg;
    const uint32_t acc =
        fold_run(T, v, ncols, comb_cols[s_last * 32 + lane], lane);
    if (lane == 0) out[u] = acc;
  }
}

template <bool kFold>
cudaError_t launch_mma(const void* words, long long nunits, long long total,
                       int unit_segs, int nseg, const void* amat,
                       const void* shift_bytes, const void* comb_cols, void* out,
                       cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      crc_mma_kernel<kFold>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  // one block an SM: the rings take most of its shared memory
  const long long want = (nunits + kWarps - 1) / kWarps;
  const long long cap = sm_count();
  crc_mma_kernel<kFold><<<(int)(want < cap ? want : cap), kThreads, kSmemBytes,
                          stream>>>(
      static_cast<const uint4*>(words), nunits, total, unit_segs, nseg,
      static_cast<const uint32_t*>(amat),
      static_cast<const uint32_t*>(shift_bytes),
      static_cast<const uint32_t*>(comb_cols), static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: (R, 128) u32, 16-byte aligned -> out: (R,) raw CRC of each segment.
// amat: the (32, 128) u32 CRC matrix (CodecTables.crc_mma_a).
int t3fs_crc_seg_words(const void* rows, long long R, const void* amat,
                       void* out, void* stream) {
  if (R <= 0) return 0;
  return (int)launch_mma<false>(rows, (R + kUnitSegs - 1) / kUnitSegs, R,
                                kUnitSegs, 1, amat, nullptr, nullptr, out,
                                static_cast<cudaStream_t>(stream));
}

// words: (n, nseg * 128) u32, 16-byte aligned -> out: (n,) raw CRC of each
// chunk.  spw (<= 16) divides nseg; partial is scratch of n * nseg / spw
// u32; shift_bytes: Mb^512 as four byte tables (CodecTables.seg_shift_bytes);
// comb_cols: P[s] as packed columns.
int t3fs_crc32c_words_raw(const void* words, long long n, int nseg, int spw,
                          const void* amat, const void* comb_cols,
                          const void* shift_bytes, void* partial, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  if (spw <= 0 || spw > kUnitSegs || nseg % spw) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nruns = n * (long long)(nseg / spw);
  cudaError_t e = launch_mma<true>(words, nruns, n * (long long)nseg, spw, nseg,
                                   amat, shift_bytes, comb_cols, partial, s);
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
