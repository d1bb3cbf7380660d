// The CRC32C pieces that the word kernel (crc_words.cu, B1) and the byte
// kernel (crc_bytes.cu, B6) share: the binary tensor-core product of 16
// segments, its operand A, its epilogue, and the segment combine.
// _build.py hashes this header into every library's name, so an edit here
// rebuilds both.
//
// Raw CRC32C (init 0, no final xor) is GF(2)-linear in the message bits, so
// bit r of a 512-byte segment's CRC is the parity of (row r of the 32 x 4096
// CRC matrix) AND (the segment's 4096 bits): one mma.sync m16n8k256 b1
// and.popc product, with the CRC matrix as A and the segments as B's
// columns.
//
//   - A is the CRC matrix, 32 rows of 128 u32 (CodecTables.crc_mma_a, bit
//     i of word w of row r = Lseg[32w + i][r]), two m-tiles of 16 rows, in
//     shared memory for the block's life, laid out per (m-tile, k-step,
//     lane) so that each k-step's fragment is one conflict-free 16-byte
//     load.  Bit i of word w of a segment is bit i % 8 of its byte
//     4w + i / 8, so the same A serves a segment of words and of bytes;
//   - B is 8 segments an n-tile, one a column.  The order in which the 4096
//     bits meet the k axis is free as long as A follows it, so lane (g, t)
//     of the warp holds the segment's 16-byte chunks 4q + t (words 16q + 4t
//     .. +3, q = 0..7) of segments g and 8 + g, and k-step ks takes words
//     w0 = 16(ks/2) + 4t + 2(ks%2) and w0 + 1 as its b0, b1;
//   - a warp takes a unit of up to 16 segments (two n-tiles) at once: 16
//     k-steps x 2 m-tiles x 2 n-tiles = 64 mma in four independent chains;
//   - epilogue: bit 0 of each s32 sum is a CRC bit; each lane places its
//     four sums' bits at rows g, g+8, g+16, g+24 of its two columns and
//     three shuffles OR the 8 lanes of a column together.
//
// Chunk combine: raw(chunk) = XOR_s P[s] . raw(seg_s), P[s] = Mb^(512(S-1-s)).
// A run of consecutive segments of one chunk is folded by Horner (acc =
// Mb^512 . acc ^ seg), Mb^512 applied as four byte lookups in a 4 KiB
// shared table (CodecTables.seg_shift_bytes), then P[last segment of the
// run] as one GF(2) matrix-vector product (lane i holds column i, a warp
// XOR reduction); crc_fold_kernel XORs each chunk's runs.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitSegs = 16;       // segments a warp takes at once: two n-tiles
constexpr int kKSteps = 16;         // 4096 bits / 256 a k-step

struct Tables {
  uint4 a[2][kKSteps][32];          // A fragments [m-tile][k-step][lane]: 16 KiB
  uint32_t shift[4][256];           // Mb^512 . (v << 8j) at [j][v]: 4 KiB
};

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = M . x over GF(2); lane i holds column i of M.
__device__ __forceinline__ uint32_t matvec(uint32_t col, uint32_t x, int lane) {
  return warp_xor(((x >> lane) & 1u) ? col : 0u);
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

// Fills T from the (32, 128) u32 CRC matrix and, where given, the Mb^512
// byte tables; ends with __syncthreads.
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
  if (shift_bytes)                             // the folding entries' only
#pragma unroll
    for (int j = 0; j < 4 * 256 / kThreads; ++j)
      s[threadIdx.x + j * kThreads] = shift_bytes[threadIdx.x + j * kThreads];
  __syncthreads();
}

__device__ __forceinline__ uint32_t shift512(const Tables& T, uint32_t x) {
  return T.shift[0][x & 0xFFu] ^ T.shift[1][(x >> 8) & 0xFFu] ^
         T.shift[2][(x >> 16) & 0xFFu] ^ T.shift[3][x >> 24];
}

// The two k-steps 2q, 2q + 1 of a unit: x[nt] is the lane's chunk 4q + t
// of segment 8 nt + g.  `two`: the unit has more than 8 columns.
__device__ __forceinline__ void mma_chunk(const Tables& T, int q,
                                          const uint4 (&x)[2], bool two,
                                          int lane, int (&d)[2][2][4]) {
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

// Epilogue of d[m-tile][n-tile][c0..c3]: on return lane (g, t) holds the
// CRC of column 8 nt + 2 t + p in v[nt][p].
__device__ __forceinline__ void unit_epilogue(const int (&d)[2][2][4], int lane,
                                              uint32_t (&v)[2][2]) {
  const int g = lane >> 2;
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

// A run of the unit's first ncols segments: the Horner fold of their CRCs
// (v from unit_epilogue), then P[the run's last segment] (comb_col: lane's
// column of it).  Every lane returns the run's partial.
__device__ __forceinline__ uint32_t fold_run(const Tables& T,
                                             const uint32_t (&v)[2][2],
                                             int ncols, uint32_t comb_col,
                                             int lane) {
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < kUnitSegs; ++c) {
    if (c >= ncols) break;
    const uint32_t mine = (c & 8) ? v[1][c & 1] : v[0][c & 1];
    acc = shift512(T, acc) ^ __shfl_sync(0xffffffffu, mine, (c >> 1) & 3);
  }
  return matvec(comb_col, acc, lane);
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

// The SMs of the current device (1 if it cannot be read).
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  return sms > 0 ? sms : 1;
}

}  // namespace
