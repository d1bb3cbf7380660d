// RAID-6 RS(k+2) decode on packed little-endian words, for sm_90a.
//
// Replaces the TPU kernel _rs_reconstruct_words_kernel
// (t3fs/ops/pallas_codec.py:502, launched by make_rs_reconstruct_words_pallas
// and fused by make_stripe_decode_step_words).
//
// What it computes, for every word position c of every stripe i: each of the
// |want| (1 or 2) rebuilt shards is sum_s C[r][s] * x[s] over GF(2^8), the
// C from RSCode.reconstruct_gfmatrix(present, want).  Multiplying packed
// words by a constant needs no bit planes: c * x = XOR over the set bits b
// of c of xtimes^b(x).  Each present shard walks one xtimes ladder up to the
// highest set bit of its column, and rung b is XORed into accumulator r
// where bit b of C[r][s] is set; a shard whose column is all zero is skipped.
//
// The TPU kernel baked the coefficients in at compile time.  Here they are a
// kernel parameter (a small struct passed by value), so one binary serves
// all 55 erasure patterns of RS(8+2) and launches of different patterns on
// the same stream or on different streams never share mutable state.  The
// coefficients are the same for every thread, so the ladder's branches do
// not diverge.
//
// Bound on the H100: memory.  Per word position the kernel reads k words and
// writes |want|, with at most 7 xtimes and 8 XORs per shard and output; one
// thread handles 4 words with 16-byte loads and stores.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;

// C[0][s] | C[1][s] << 8 for each present shard s
struct Coeffs {
  uint32_t col[kMaxK];
};

// in: (n, k, wv) vectors, out: (n, NWANT, wv) vectors.
template <typename V, int NWANT>
__global__ void __launch_bounds__(kThreads)
rs_reconstruct_kernel(const V* __restrict__ in, V* __restrict__ out, int k,
                      long long wv, long long total, uint32_t low,
                      const Coeffs coeffs) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / wv;
    const long long c = idx - i * wv;
    const V* x = in + i * k * wv + c;
    V acc[NWANT];
#pragma unroll
    for (int r = 0; r < NWANT; ++r) acc[r] = zero<V>();
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s >= k) break;
      uint32_t col = coeffs.col[s];
      if (col == 0) continue;                    // shard unused by every row
      V t = x[s * wv];                           // rung 0 of the ladder
      while (true) {
#pragma unroll
        for (int r = 0; r < NWANT; ++r)
          if ((col >> (8 * r)) & 1u) acc[r] ^= t;
        col = (col >> 1) & 0x7F7F7F7Fu;          // next bit of every row
        if (col == 0) break;
        t = xtimes(t, low);
      }
    }
    V* o = out + i * NWANT * wv + c;
#pragma unroll
    for (int r = 0; r < NWANT; ++r) o[r * wv] = acc[r];
  }
}

template <typename V, int NWANT>
cudaError_t launch(const void* in, void* out, long long n, int k, long long wv,
                   uint32_t low, const Coeffs& coeffs, cudaStream_t stream) {
  const long long total = n * wv;
  rs_reconstruct_kernel<V, NWANT>
      <<<grid_blocks(total, kThreads), kThreads, 0, stream>>>(
          static_cast<const V*>(in), static_cast<V*>(out), k, wv, total, low,
          coeffs);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_want(const void* in, void* out, long long n, int k,
                        int nwant, long long wv, uint32_t low,
                        const Coeffs& coeffs, cudaStream_t stream) {
  if (nwant == 1) return launch<V, 1>(in, out, n, k, wv, low, coeffs, stream);
  return launch<V, 2>(in, out, n, k, wv, low, coeffs, stream);
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
  Coeffs c{};
  for (int r = 0; r < nwant; ++r)
    for (int s = 0; s < k; ++s)
      c.col[s] |= (uint32_t)coeffs[r * k + s] << (8 * r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t low = (uint32_t)poly_low & 0xFFu;
  const bool vec = (w % 4 == 0) && aligned16(words) && aligned16(out);
  if (vec)
    return (int)launch_want<uint4>(words, out, n, k, nwant, w / 4, low, c, st);
  return (int)launch_want<uint32_t>(words, out, n, k, nwant, w, low, c, st);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
