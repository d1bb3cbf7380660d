// CRC32C of 512-byte segments on packed little-endian words, for sm_90a, as
// a binary tensor-core product.
//
// Replaces the TPU kernel _crc_words_kernel (t3fs/ops/pallas_codec.py:310,
// launched by make_crc_seg_words_pallas) and the segment-combine matmul
// that make_crc32c_words_raw runs after it (pallas_codec.py:366-402).
//
// What it computes: the raw CRC32C (init 0, no final xor, zero-preserving)
// of each 512-byte segment, and for t3fs_crc32c_words_raw the raw CRC of
// each whole chunk of `nseg` segments.  Raw CRC is GF(2)-linear in the
// message bits, so bit r of a segment's CRC is the parity of (row r of the
// 32 x 4096 CRC matrix) AND (the segment's 4096 bits).  The TPU ran that as
// 32 int8 bit-plane matmuls on the MXU.  Here it is one binary tensor-core
// product, mma.sync.m16n8k256.b1.and.popc, which reads the packed words as
// they lie in memory:
//
//   - A is the CRC matrix, 32 rows of 128 u32 (CodecTables.crc_mma_a, bit
//     i of word w of row r = Lseg[32w + i][r]), two m-tiles of 16 rows, in
//     shared memory for the block's life, laid out per (m-tile, k-step,
//     lane) so that each k-step's fragment is one conflict-free 16-byte
//     load;
//   - B is 8 segments an n-tile, one a column.  The order in which the 4096
//     bits meet the k axis is free as long as A follows it, so lane (g, t)
//     of the warp reads words 16q+4t .. 16q+4t+3 of segment g (q = 0..7) as
//     one uint4, and k-step ks takes words w0 = 16(ks/2) + 4t + 2(ks%2) and
//     w0+1 as its b0, b1;
//   - a warp takes a unit of up to 16 segments (two n-tiles) at once: 16
//     k-steps x 2 m-tiles x 2 n-tiles = 64 mma in four independent chains,
//     4 mma a segment (about 160 lookup instructions a segment before);
//   - the data moves by asynchronous copies: each warp streams its units
//     through its own ring of 3 stages of 8 KiB in shared memory, cp.async
//     16 bytes a lane (a warp instruction copies one whole segment) two
//     units ahead of the one it multiplies, so 16 KiB a warp, 128 KiB an SM,
//     stay in flight; odd segments swap their 64-byte halves in the ring so
//     the fragment reads of a quarter-warp hit distinct banks;
//   - epilogue: bit 0 of each s32 sum is a CRC bit; each lane places its
//     four sums' bits at rows g, g+8, g+16, g+24 of its two columns and
//     three shuffles OR the 8 lanes of a column together.
//
// Chunk combine: raw(chunk) = XOR_s P[s] . raw(seg_s), P[s] = Mb^(512(S-1-s)).
// A unit is one run of `spw` (<= 16) consecutive segments of one chunk; the
// warp folds it by Horner (acc = Mb^512 . acc ^ seg), Mb^512 applied as four
// byte lookups in a 4 KiB shared table (CodecTables.seg_shift_bytes), then
// applies P[last segment of the run] as one GF(2) matrix-vector product
// (lane i holds column i, a warp XOR reduction).  crc_fold_kernel XORs
// each chunk's runs.  t3fs_crc_seg_words takes units of 16 rows of any R,
// the last one ragged (its missing columns load zeros and are not stored).
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

constexpr int kUnitSegs = 16;       // segments a warp takes at once: two n-tiles
constexpr int kKSteps = 16;         // 4096 bits / 256 a k-step
constexpr int kStages = 3;          // a warp's ring: one unit in use, two loading
constexpr int kStageU4 = kUnitSegs * 32;   // one unit, 8 KiB

struct Tables {
  uint4 a[2][kKSteps][32];          // A fragments [m-tile][k-step][lane]: 16 KiB
  uint32_t shift[4][256];           // Mb^512 . (v << 8j) at [j][v]: 4 KiB
};
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

// D += popc(A AND B) over 256 k: A 16 x 256 bits (a.x..a.w), B 256 x 8.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Word of the segment that k-step ks of lane t pairs with its b0 (b1: +1).
__device__ __forceinline__ int k_word(int ks, int t) {
  return 16 * (ks >> 1) + 4 * t + 2 * (ks & 1);
}

__device__ void load_tables(Tables& T, const uint32_t* __restrict__ amat,
                            const uint32_t* __restrict__ shift_bytes) {
  uint32_t* a = reinterpret_cast<uint32_t*>(T.a);
  // all 16 loads of a thread in flight at once
#pragma unroll
  for (int j = 0; j < 2 * kKSteps * 32 * 4 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i & 3, lane = (i >> 2) & 31, ks = (i >> 7) & 15, mt = i >> 11;
    // a0: row g, b0's words; a1: row g + 8; a2, a3: the same rows, b1's words
    const int row = 16 * mt + (lane >> 2) + 8 * (r & 1);
    a[i] = amat[row * 128 + k_word(ks, lane & 3) + (r >> 1)];
  }
  uint32_t* s = &T.shift[0][0];
  if (shift_bytes)                             // the folding entry's only
#pragma unroll
    for (int j = 0; j < 4 * 256 / kThreads; ++j)
      s[threadIdx.x + j * kThreads] = shift_bytes[threadIdx.x + j * kThreads];
  __syncthreads();
}

__device__ __forceinline__ uint32_t shift512(const Tables& T, uint32_t x) {
  return T.shift[0][x & 0xFFu] ^ T.shift[1][(x >> 8) & 0xFFu] ^
         T.shift[2][(x >> 16) & 0xFFu] ^ T.shift[3][x >> 24];
}

// The CRCs of the unit's ncols (<= 16) segments in `stage`: on return lane
// (g, t) holds column 8 nt + 2 t + p in v[nt][p].
__device__ __forceinline__ void unit_crcs(const Tables& T, const uint4* stage,
                                          int ncols, int lane,
                                          uint32_t (&v)[2][2]) {
  const int g = lane >> 2, t = lane & 3;
  int d[2][2][4] = {};                         // [m-tile][n-tile][c0..c3]
  const bool two = ncols > 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    // words 16q + 4t .. +3 of segments g and 8 + g: k-steps 2q and 2q + 1
    const uint4 x[2] = {stage[ring_at(g, 4 * q + t)],
                        stage[ring_at(8 + g, 4 * q + t)]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ks = 2 * q + h;
      const uint4 a0 = T.a[0][ks][lane], a1 = T.a[1][ks][lane];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt == 1 && !two) break;
        const uint32_t b0 = h ? x[nt].z : x[nt].x, b1 = h ? x[nt].w : x[nt].y;
        mma_b1(d[0][nt], a0, b0, b1);
        mma_b1(d[1][nt], a1, b0, b1);
      }
    }
  }
  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8; m-tile 1: rows + 16
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t x = ((uint32_t)(d[0][nt][p] & 1) << g) |
                   ((uint32_t)(d[0][nt][p + 2] & 1) << (g + 8)) |
                   ((uint32_t)(d[1][nt][p] & 1) << (g + 16)) |
                   ((uint32_t)(d[1][nt][p + 2] & 1) << (g + 24));
      x |= __shfl_xor_sync(0xffffffffu, x, 4);
      x |= __shfl_xor_sync(0xffffffffu, x, 8);
      x |= __shfl_xor_sync(0xffffffffu, x, 16);
      v[nt][p] = x;
    }
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
    uint32_t acc = 0;
#pragma unroll
    for (int c = 0; c < kUnitSegs; ++c) {
      if (c >= ncols) break;
      const uint32_t mine = (c & 8) ? v[1][c & 1] : v[0][c & 1];
      acc = shift512(T, acc) ^ __shfl_sync(0xffffffffu, mine, (c >> 1) & 3);
    }
    const long long s_last = (seg0 + ncols - 1) % nseg;
    acc = matvec(comb_cols[s_last * 32 + lane], acc, lane);
    if (lane == 0) out[u] = acc;
  }
}

template <bool kFold>
cudaError_t launch_mma(const void* words, long long nunits, long long total,
                       int unit_segs, int nseg, const void* amat,
                       const void* shift_bytes, const void* comb_cols, void* out,
                       cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crc_mma_kernel<kFold>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  // one block an SM: the rings take most of its shared memory
  const long long want = (nunits + kWarps - 1) / kWarps;
  const long long cap = sms > 0 ? sms : 1;
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
