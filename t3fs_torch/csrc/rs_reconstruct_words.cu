// RAID-6 RS(k+2) decode on packed little-endian words, for sm_90a.
//
// Replaces the TPU kernel _rs_reconstruct_words_kernel
// (t3fs/ops/pallas_codec.py:502, launched by make_rs_reconstruct_words_pallas
// and fused by make_stripe_decode_step_words).
//
// What it computes, for every word position c of every stripe i: each of the
// |want| (1 or 2) rebuilt shards is sum_s C[r][s] * x[s] over GF(2^8), the
// C from RSCode.reconstruct_gfmatrix(present, want).
//
// Why not a ladder per survivor.  c * x is the XOR over the set bits b of c
// of xtimes^b(x), so the first design walked one xtimes ladder per survivor
// up to its column's highest bit, in a runtime loop over the bits: 56 SWAR
// xtimes per word for want (0, 9), each 4-5 integer instructions, plus the
// loop's tests and branches.  That was bound by integer issue, not memory:
// 84-86 us against a 37.6 us byte bound on the H100.
//
// The schedule here is B4's (repair_words.cu) for two rows at once:
//
//   S[r][b] = XOR of the survivors whose C[r][s] has bit b set  (plane b)
//   out[r]  = Horner from row r's top plane down: acc = xtimes(acc) ^ S[r][b]
//
// so at most 7 xtimes per row whatever k, and one XOR per set coefficient
// bit.  An all-ones row (top plane 0: the P side of want (0, 9), every
// single data erasure) is a pure XOR fold.  The C entry builds the program
// from the coefficient matrix (one survivor bitmask per row and plane, each
// row's top plane) and passes it by value, so one binary serves every
// erasure pattern and the branches on it are uniform across the warp.
//
// Each thread reads its position's survivors once, 16 bytes each, in groups
// of 8 whose loads are all issued before any XOR.  With k <= 8 (every RS(8+2)
// pattern) one group is the whole stripe and each row folds straight from the
// registers (63 registers for two rows on the uint4 path); past 8 the groups'
// plane sums S[r][b] accumulate in registers and fold at the end (128).  The
// k <= 8 kernel is worth its second instantiation: at (12, 8, 256Ki words) on
// the H100 the plane-sum kernel alone read 63.4-65.2 us at the RS(8+2)
// patterns with two Horner rows against 51.7-52.3, and 51.4-51.9 at want
// (0, 9) against 47.5-47.7 (b1_probe.py, PERF.md).  Every index into a
// register array is a compile-time one (unrolled loops guarded by the
// program's masks), so nothing spills to local memory.  The grid is
// grid_blocks' 16 blocks an SM, each walking the positions by grid stride: on
// the H100 a grid of one wave of the blocks that fit read 3-6% slower on
// double erasures, and a grid that covers the input once read the same.
//
// Bound on the H100: memory.  Per word position the kernel reads k words and
// writes |want|: want (0, 9) at (12, 8, 256Ki words) reads ~47 us against a
// 37.6 us byte bound, the patterns with two Horner rows ~51 us, a single
// erasure ~41 us against 33.8.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr int kPlanes = 8;
constexpr int kGroup = 8;   // survivors whose loads go out together

// The decode program of up to two rows: bit s of plane[r][b] is set where
// bit b of C[r][s] is; top[r] is row r's highest nonempty plane (-1 for a
// zero row); bit s of `used` is set where any row reads survivor s.
struct Program {
  uint32_t plane[2][kPlanes];
  int top[2];
  uint32_t used;
};

// Survivors g*8 .. g*8+7 of one position, zero where no row reads them.
template <typename V>
__device__ __forceinline__ void load_group(V (&x)[kGroup], const V* p,
                                           long long wv, int g, uint32_t used) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int s = g * kGroup + j;
    x[j] = zero<V>();
    if ((used >> s) & 1u) x[j] = p[s * wv];
  }
}

// acc ^= the XOR of the group's survivors selected by the 8-bit mask m.
template <typename V>
__device__ __forceinline__ void xor_selected(V& acc, const V (&x)[kGroup],
                                             uint32_t m) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if ((m >> j) & 1u) acc ^= x[j];
}

// in: (n, k, wv) vectors, out: (n, NWANT, wv) vectors.  kOneGroup: k <= 8.
template <typename V, int NWANT, bool kOneGroup>
__global__ void __launch_bounds__(kThreads)
rs_reconstruct_kernel(const V* __restrict__ in, V* __restrict__ out, int k,
                      long long n, long long wv, uint32_t low,
                      const Program prog) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long step_i = stride / wv, step_c = stride - step_i * wv;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long i = idx / wv, c = idx - i * wv;
  while (i < n) {
    const V* p = in + i * k * wv + c;
    V acc[NWANT];
    if constexpr (kOneGroup) {
      V x[kGroup];
      load_group(x, p, wv, 0, prog.used);
#pragma unroll
      for (int r = 0; r < NWANT; ++r) {
        acc[r] = zero<V>();
#pragma unroll
        for (int b = kPlanes - 1; b >= 0; --b) {
          if (b < prog.top[r]) acc[r] = xtimes(acc[r], low);
          if (prog.plane[r][b]) xor_selected(acc[r], x, prog.plane[r][b]);
        }
      }
    } else {
      V S[NWANT][kPlanes];
#pragma unroll
      for (int r = 0; r < NWANT; ++r)
#pragma unroll
        for (int b = 0; b < kPlanes; ++b) S[r][b] = zero<V>();
      for (int g = 0; g * kGroup < k; ++g) {
        V x[kGroup];
        load_group(x, p, wv, g, prog.used);
#pragma unroll
        for (int r = 0; r < NWANT; ++r)
#pragma unroll
          for (int b = 0; b < kPlanes; ++b) {
            const uint32_t m = (prog.plane[r][b] >> (g * kGroup)) & 0xFFu;
            if (m) xor_selected(S[r][b], x, m);
          }
      }
#pragma unroll
      for (int r = 0; r < NWANT; ++r) {
        acc[r] = zero<V>();
#pragma unroll
        for (int b = kPlanes - 1; b >= 0; --b) {
          if (b < prog.top[r]) acc[r] = xtimes(acc[r], low);
          acc[r] ^= S[r][b];
        }
      }
    }
    V* o = out + i * NWANT * wv + c;
#pragma unroll
    for (int r = 0; r < NWANT; ++r) o[r * wv] = acc[r];
    c += step_c;
    i += step_i;
    if (c >= wv) {
      c -= wv;
      ++i;
    }
  }
}

template <typename V, int NWANT, bool kOneGroup>
cudaError_t launch(const void* in, void* out, long long n, int k, long long wv,
                   uint32_t low, const Program& prog, cudaStream_t stream) {
  rs_reconstruct_kernel<V, NWANT, kOneGroup>
      <<<grid_blocks(n * wv, kThreads), kThreads, 0, stream>>>(
          static_cast<const V*>(in), static_cast<V*>(out), k, n, wv, low, prog);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_want(const void* in, void* out, long long n, int k,
                        int nwant, long long wv, uint32_t low,
                        const Program& prog, cudaStream_t stream) {
  const bool one = k <= kGroup;
  if (nwant == 1)
    return one ? launch<V, 1, true>(in, out, n, k, wv, low, prog, stream)
               : launch<V, 1, false>(in, out, n, k, wv, low, prog, stream);
  return one ? launch<V, 2, true>(in, out, n, k, wv, low, prog, stream)
             : launch<V, 2, false>(in, out, n, k, wv, low, prog, stream);
}

}  // namespace

extern "C" {

// words: (n, k, w) u32 present shards -> out: (n, nwant, w) u32 rebuilt.
// coeffs: (nwant, k) u8 row-major, the decode matrix.  Takes the 16-byte
// path when w % 4 == 0 and both pointers are 16-byte aligned.
int t3fs_rs_reconstruct_words(const void* words, void* out, long long n, int k,
                              int nwant, long long w, const uint8_t* coeffs,
                              int poly_low, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (k < 1 || k > kMaxK || nwant < 1 || nwant > 2)
    return (int)cudaErrorInvalidValue;
  Program p{};
  for (int r = 0; r < 2; ++r) {
    p.top[r] = -1;
    for (int b = 0; b < kPlanes && r < nwant; ++b) {
      for (int s = 0; s < k; ++s)
        if ((coeffs[r * k + s] >> b) & 1u) p.plane[r][b] |= 1u << s;
      if (p.plane[r][b]) p.top[r] = b;
      p.used |= p.plane[r][b];
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t low = (uint32_t)poly_low & 0xFFu;
  const bool vec = (w % 4 == 0) && aligned16(words) && aligned16(out);
  if (vec)
    return (int)launch_want<uint4>(words, out, n, k, nwant, w / 4, low, p, st);
  return (int)launch_want<uint32_t>(words, out, n, k, nwant, w, low, p, st);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
