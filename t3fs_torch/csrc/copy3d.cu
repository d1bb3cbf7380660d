// H1: the bench harness's calibration pass, out = x + 1 over (n, k, W)
// uint32 words (wrapping at 2^32), for sm_90a.
//
// Replaces the TPU kernel _copy_kernel (benchmarks/devbench.py:91, launched
// by make_copy3d, l.95).  It exists to calibrate the chained bench harness
// (t3fs_torch/benchmarks/devbench.py): each chained iteration XOR-perturbs
// its input in one elementwise pass, and a chain of this kernel is two such
// passes (perturb + copy), so half its time per iteration is the
// perturbation pass that the bench subtracts from the op's.
//
// Bound on the H100: memory, 2 * n*k*W * 4 bytes / 3.35 TB/s (each word read
// once and written once, one add on it).  One thread moves four 16-byte
// uint4, all four loads in flight before the first store; a block covers a
// tile of 4 * 256 consecutive vectors, and the grid covers the input once,
// up to kMaxWaves resident waves of the SMs, past which the grid-stride
// loop takes over.  The calibration wants it as fast as the XOR pass it
// stands for (a PyTorch elementwise kernel).  On an H100 80GB HBM3 at 700 W,
// at (12, 8, 256Ki words), a grid of one resident wave striding over the
// input took 76.0-76.5 us, 8% behind torch.add, and one of four waves
// 71.8-83.2 us within one run: blocks with an uneven number of strides
// leave SMs idle at the end, where one tile a block lets the block
// scheduler even the load out.  The first threads of block 0 take the
// n*k*W % 4 trailing words.  The TPU's (1, k, 8, 2048) blocks were its
// VMEM tiling and are not carried over.  Pointers that are not 16-byte
// aligned (views at an offset) take a scalar grid-stride loop.

#include "swar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // 2048 resident threads per SM
constexpr int kUnroll = 4;                      // uint4 loads in flight a thread
constexpr int kMaxWaves = 64;                   // grid cap, in resident waves

// The minimum-blocks bound holds the kernel to 32 registers a thread so
// kBlocksPerSm blocks are resident an SM.  Unbounded, the compiler took 34,
// only 6 blocks fit, and with a one-wave grid a thin extra wave trailed:
// 73.9-83.3 us from one H100 to the next where torch.add held 69.8-72.0.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
copy3d_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long nvec, const uint32_t* __restrict__ tail_in,
                  uint32_t* __restrict__ tail_out, int tail) {
  // a block step covers kUnroll * kThreads consecutive vectors; thread t
  // takes t, t + kThreads, ..., so each load and store is coalesced
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < nvec; base += stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < nvec) v[u] = in[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < nvec) {
        v[u].x += 1u;
        v[u].y += 1u;
        v[u].z += 1u;
        v[u].w += 1u;
        out[i] = v[u];
      }
    }
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    tail_out[threadIdx.x] = tail_in[threadIdx.x] + 1u;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
copy3d_scalar_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     long long count) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += stride) {
    out[i] = in[i] + 1u;
  }
}

}  // namespace

extern "C" {

// x: count u32 words -> out: count u32 words, out[i] = x[i] + 1.  Takes the
// 16-byte path when both pointers are 16-byte aligned.
int t3fs_copy3d(const void* x, void* out, long long count, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (aligned16(x) && aligned16(out)) {
    const long long nvec = count / 4;
    const int tail = (int)(count % 4);
    const long long steps = (nvec + kUnroll - 1) / kUnroll;
    const int blocks =
        grid_blocks(steps > 0 ? steps : 1, kThreads, kMaxWaves * kBlocksPerSm);
    copy3d_vec_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(in), reinterpret_cast<uint4*>(o), nvec,
        in + nvec * 4, o + nvec * 4, tail);
  } else {
    const int blocks = grid_blocks(count, kThreads, kMaxWaves * kBlocksPerSm);
    copy3d_scalar_kernel<<<blocks, kThreads, 0, s>>>(in, o, count);
  }
  return (int)cudaGetLastError();
}

const char* t3fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
