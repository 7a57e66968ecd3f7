// 256-bin histograms of a channels-last uint8 image, every channel in one
// launch, for Hopper (sm_90a).
//
// Replaces oadg_tpu/ops/pallas_hist.py:hist256 (the TPU kernel _hist_kernel).
// The TPU has no scatter: it keeps 256 per-lane accumulators in VMEM and
// compares every value with every bin. On the H100 a value increments its
// bin directly, so each value costs one shared-memory atomic.
//
// What bounds it on the H100: bytes. The function reads each value once
// (one byte) and writes C x 256 counts; there is no arithmetic to speak of.
// The design answers that with privatization: each block counts into its
// own C x 256 table in shared memory (atomicAdd on shared memory is a
// native instruction), then adds its non-zero bins to the global table with
// one atomicAdd each. Global atomics are therefore C x 256 per block, not
// one per value, and the image is read once, a warp at a time over
// consecutive bytes. A grid of a few blocks per SM walks the image with a
// grid-stride loop.
//
// Contract: x holds n values in [0, 255] of c interleaved channels (value i
// belongs to channel i % c); out is a zeroed (c, 256) int32 table on the
// same device. C interface, loaded with ctypes by
// oadg_tpu_torch/ops/_kernels.py; launched on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

__global__ void hist256_kernel(const uint8_t* __restrict__ x, long long n,
                               int c, int* __restrict__ out) {
  __shared__ int table[kMaxChannels * 256];
  for (int i = threadIdx.x; i < c * 256; i += blockDim.x) table[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    atomicAdd(&table[static_cast<int>(i % c) * 256 + x[i]], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c * 256; i += blockDim.x) {
    const int v = table[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

}  // namespace

extern "C" int oadg_hist256(const void* x, long long n, int c, void* out,
                            void* stream) {
  if (c < 1 || c > kMaxChannels || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  long long blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
  if (blocks > 132 * 8) blocks = 132 * 8;
  hist256_kernel<<<static_cast<int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, c, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
