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
// (h <= 32) and the top plane.  Every thread reads each helper word once and
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
  uint32_t plane[kPlanes];   // bit h of plane[b]: helper h's coefficient has bit b
  int top;                   // highest nonempty plane
};

// in: (n, h, wv) vectors, out: (n, wv) vectors.
template <typename V>
__global__ void __launch_bounds__(kThreads)
repair_kernel(const V* __restrict__ in, V* __restrict__ out, int h,
              long long wv, long long total, uint32_t low, const Program prog) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / wv;
    const long long c = idx - i * wv;
    const V* x = in + i * h * wv + c;
    V S[kPlanes];
#pragma unroll
    for (int b = 0; b < kPlanes; ++b) S[b] = zero<V>();
    for (int j = 0; j < h; ++j) {
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
    out[i * wv + c] = acc;
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, long long n, int h, long long wv,
                   uint32_t low, const Program& prog, cudaStream_t stream) {
  const long long total = n * wv;
  repair_kernel<V><<<grid_blocks(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const V*>(in), static_cast<V*>(out), h, wv, total, low, prog);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words: (n, h, w) u32 helper words -> out: (n, w) u32 rebuilt words.
// planes: the `top + 1` helper bitmasks, plane 0 first.  Takes the 16-byte
// path when w % 4 == 0 and both pointers are 16-byte aligned.
int t3fs_repair_words(const void* words, void* out, long long n, int h,
                      long long w, const uint32_t* planes, int top,
                      int poly_low, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (h < 1 || h > kMaxHelpers || top < 0 || top >= kPlanes)
    return (int)cudaErrorInvalidValue;
  Program p{};
  for (int b = 0; b <= top; ++b) p.plane[b] = planes[b];
  p.top = top;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t low = (uint32_t)poly_low & 0xFFu;
  const bool vec = (w % 4 == 0) && aligned16(words) && aligned16(out);
  if (vec) return (int)launch<uint4>(words, out, n, h, w / 4, low, p, st);
  return (int)launch<uint32_t>(words, out, n, h, w, low, p, st);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
