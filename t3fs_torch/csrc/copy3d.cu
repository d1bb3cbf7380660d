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
// once and written once, one add on it).  The calibration wants it as fast as
// the XOR pass it stands for (a PyTorch elementwise kernel), so it has the
// shape of PyTorch's own: 128-thread blocks, one uint4 a thread, and a grid
// that covers the input once (up to kMaxWaves resident waves of the SMs, past
// which the grid-stride loop takes over), so the block scheduler evens the load
// out.  The first threads of block 0 take the n*k*W % 4 trailing words.  The
// TPU's (1, k, 8, 2048) blocks were its VMEM tiling and are not carried
// over.  Pointers that are not 16-byte aligned (views at an offset) take a
// scalar grid-stride loop.
//
// How it got here (NVIDIA H100 80GB HBM3, 700 W, at (12, 8, 256Ki words);
// see PERF.md).  Host-launched CUDA events: one uint4 in flight a thread
// and 256-thread blocks 77.9 us against torch.add's 70.6; four in flight
// 73.9-83.3 (at 34 registers 6 of 8 blocks were resident, hence the
// minimum-blocks bound below); a one-wave grid-stride grid 76.0-76.5, four
// waves 71.8-83.2 (blocks with an uneven number of strides leave SMs idle
// at the end); a grid that covers the input once, four uint4 a thread in
// 256-thread blocks, 72.9-74.6, 1-4% behind torch.add.  Then H1 against
// torch.add in interleaved CUDA-graph replays (chip_smoke.py phase 16, one
// call, H1 / torch.add of the medians): that design 69.30 / 68.82 us
// (1.0070) and 69.36 / 68.53 (1.0122); 128-thread blocks, four uint4 a
// thread 68.76 / 68.25 (1.0074); streaming loads and stores (__ldcs /
// __stcs) 69.69 / 68.29 (1.0205); 128-thread blocks and one uint4 a thread,
// this design, 68.26 / 68.16 (1.0014), 0.1% behind: the closest of the
// three, kept as the budget for it allowed.

#include "swar.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 2048 / kThreads;  // 2048 resident threads per SM
constexpr int kMaxWaves = 64;                   // grid cap, in resident waves

// The minimum-blocks bound holds the kernel to 32 registers a thread so
// kBlocksPerSm blocks are resident an SM.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
copy3d_vec_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long nvec, const uint32_t* __restrict__ tail_in,
                  uint32_t* __restrict__ tail_out, int tail) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    uint4 v = in[i];
    v.x += 1u;
    v.y += 1u;
    v.z += 1u;
    v.w += 1u;
    out[i] = v;
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
    const int blocks =
        grid_blocks(nvec > 0 ? nvec : 1, kThreads, kMaxWaves * kBlocksPerSm);
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
