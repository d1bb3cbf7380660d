// One scheduled repair row on packed little-endian words, for sm_90a.
//
// Replaces the TPU kernel _repair_words_kernel (t3fs/ops/pallas_codec.py:587,
// launched by make_repair_subshard_words and fused by make_repair_step_words).
//
// What it computes, for every word position c of every row i: the rebuilt
// word sum_h coeff[h] * x[h] over GF(2^8), by the program that
// repair_program.schedule_repair_program built for the coefficient row:
//
//   S_b = XOR of the helpers whose coefficient has bit b set  (plane b)
//   out = Horner from the top plane down: acc = xtimes(acc) ^ S_b
//
// so at most 7 xtimes per word in total, whatever the number of helpers.
// The program arrives as a kernel parameter: one helper bitmask per plane
// and the top plane, for a group of at most 32 helpers.  A row over more
// helpers is linear in them, so tables.load_repair_tables cuts it into
// groups of <= 32, each with its own planes, and the wrapper launches once
// a group: the helper offset indexes the full (n, h, w) input, so no slice
// is copied, and every group after the first XORs into the output
// (`accumulate`).  Every thread reads each helper word once and
// XORs it into the plane sums its coefficient selects, then runs the Horner
// fold; the all-ones program (top == 0: RAID-6 P repair, LRC local parity)
// is a pure XOR fold.  The masks are the same for every thread, so the
// branches do not diverge.
//
// Bound on the H100: memory.  Per word position the kernel reads h words and
// writes one; one thread handles 4 words with 16-byte loads and stores.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 8;
constexpr int kMaxHelpers = 32;

struct Program {
  uint32_t plane[kPlanes];   // bit j of plane[b]: helper h0+j's coefficient has bit b
  int top;                   // highest nonempty plane
};

// in: the group's first helper of an (n, h, wv) vector tensor, hg helpers;
// out: (n, wv) vectors.
template <typename V>
__global__ void __launch_bounds__(kThreads)
repair_kernel(const V* __restrict__ in, V* __restrict__ out, int h, int hg,
              long long wv, long long total, uint32_t low, const Program prog,
              bool accumulate) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / wv;
    const long long c = idx - i * wv;
    const V* x = in + i * h * wv + c;
    V S[kPlanes];
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) S[b] = zero<V>();
    for (int j = 0; j < hg; ++j) {
      const V d = x[j * wv];
#pragma unroll
      for (int b = 0; b < kPlanes; ++b)
        if ((prog.plane[b] >> j) & 1u) S[b] ^= d;
    }
    V acc = zero<V>();
#pragma unroll
    for (int b = kPlanes - 1; b >= 0; --b) {
      if (b > prog.top) continue;
      acc = xtimes(acc, low) ^ S[b];
    }
    if (accumulate) acc ^= out[i * wv + c];
    out[i * wv + c] = acc;
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, long long n, int h, int hg,
                   long long wv, uint32_t low, const Program& prog,
                   bool accumulate, cudaStream_t stream) {
  const long long total = n * wv;
  repair_kernel<V><<<grid_blocks(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const V*>(in), static_cast<V*>(out), h, hg, wv, total, low,
      prog, accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words: (n, h, w) u32 helper words -> out: (n, w) u32, the group of
// helpers h0..h0+hg-1 (hg <= 32) written, or XORed in when `accumulate` is
// nonzero.  planes: the group's `top + 1` helper bitmasks (bit j: helper
// h0+j), plane 0 first.  Takes the 16-byte path when w % 4 == 0 and both
// pointers are 16-byte aligned.
int t3fs_repair_words(const void* words, void* out, long long n, int h, int h0,
                      int hg, long long w, const uint32_t* planes, int top,
                      int poly_low, int accumulate, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (hg < 1 || hg > kMaxHelpers || h0 < 0 || h0 + hg > h || top < 0 ||
      top >= kPlanes)
    return (int)cudaErrorInvalidValue;
  Program p{};
  for (int b = 0; b <= top; ++b) p.plane[b] = planes[b];
  p.top = top;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t low = (uint32_t)poly_low & 0xFFu;
  const uint32_t* in = static_cast<const uint32_t*>(words) + (long long)h0 * w;
  const bool acc = accumulate != 0;
  const bool vec = (w % 4 == 0) && aligned16(words) && aligned16(out);
  if (vec) return (int)launch<uint4>(in, out, n, h, hg, w / 4, low, p, acc, st);
  return (int)launch<uint32_t>(in, out, n, h, hg, w, low, p, acc, st);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
