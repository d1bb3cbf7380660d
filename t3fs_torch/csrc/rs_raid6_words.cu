// RAID-6 RS(k+2) parity on packed little-endian words, for sm_90a.
//
// Replaces the TPU kernel _rs_raid6_words_kernel (t3fs/ops/pallas_codec.py:261,
// launched by make_rs_encode_words_pallas).
//
// What it computes, for every word position c of every stripe i:
//   P = XOR_s d[s]                       (the all-ones parity row)
//   Q = Horner fold: q = xtimes(q) ^ d[s] (coefficients g^(k-1-s), g = 2)
// xtimes is multiply-by-x on four packed GF(2^8) bytes (SWAR): shift each
// byte left and, where its high bit was set, XOR the poly's low byte (0x1D
// for 0x11D) into it.  Byte j of a shard is byte j % 4 of word j / 4, the
// same little-endian packing as the TPU kernel's input.
//
// Bound on the H100: memory.  Per word position the kernel reads k words
// and writes 2, with a handful of integer operations on each; one thread
// handles 4 words with 16-byte loads and stores, so (k+2) * W * 4 bytes
// per stripe cross HBM once.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;

// in: (n, k, wv) vectors, out: (n, 2, wv) vectors.
template <typename V>
__global__ void __launch_bounds__(kThreads)
rs_raid6_kernel(const V* __restrict__ in, V* __restrict__ out, int k,
                long long wv, long long total, uint32_t low) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / wv;
    const long long c = idx - i * wv;
    const V* x = in + i * k * wv + c;
    V p = x[0];
    V q = p;
#pragma unroll 8
    for (int s = 1; s < k; ++s) {
      const V d = x[s * wv];
      p = p ^ d;
      q = xtimes(q, low) ^ d;
    }
    V* o = out + i * 2 * wv + c;
    o[0] = p;
    o[wv] = q;
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, long long n, int k, long long wv,
                   uint32_t low, cudaStream_t stream) {
  const long long total = n * wv;
  rs_raid6_kernel<V><<<grid_blocks(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const V*>(in), static_cast<V*>(out), k, wv, total, low);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// words: (n, k, w) u32 -> parity: (n, 2, w) u32.  Takes the 16-byte path
// when w % 4 == 0 and both pointers are 16-byte aligned.
int t3fs_rs_raid6_words(const void* words, void* parity, long long n, int k,
                        long long w, int poly_low, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t low = (uint32_t)poly_low & 0xFFu;
  const bool vec = (w % 4 == 0) && aligned16(words) && aligned16(parity);
  if (vec) return (int)launch<uint4>(words, parity, n, k, w / 4, low, s);
  return (int)launch<uint32_t>(words, parity, n, k, w, low, s);
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
