// 256-bin histograms of a channels-last uint8 image, every channel in one
// launch, for Hopper (sm_90a).
//
// Replaces oadg_tpu/ops/pallas_hist.py:hist256 (the TPU kernel _hist_kernel).
// The TPU has no scatter: it keeps 256 per-lane accumulators in VMEM and
// compares every value with every bin. On the H100 a value increments its
// bin in shared memory directly.
//
// What bounds it on the H100: not the bytes (6.3 MB of a 1024 x 2048 x 3
// image is 0.0019 ms at 3.35 TB/s) but the time until the last of them has
// been read and counted, and the merge of the blocks' tables. The design:
//   - Loads that land one by one. Thread t of the grid reads the 8-byte
//     words t, t + S, t + 2S, ... of the 16-byte aligned body (S: threads in
//     the grid). A warp's load is then two 128-byte lines, which land
//     independently, so counting runs while the rest of the image streams
//     in. Longer per-thread pieces (48 bytes, or 12 KB stages copied by the
//     tensor memory accelerator) land all together at the end of the
//     stream and leave the counting behind it.
//   - The channel of a byte without a division: the grid has a multiple of
//     3 blocks, so 8 S is a multiple of every c in 1..4 and byte j of every
//     word of thread t has channel (head + 8 t + j) % c, computed once. The
//     unaligned head (< 16 bytes) and the ragged tail (< 8 bytes) are
//     counted one byte a thread. No 64-bit division is left in the kernel.
//   - Contention. Each value is one shared atomic into a table of c x 256
//     bins x 16 columns, column lane % 16: a warp's atomic spreads over 16
//     columns, and the counting still keeps pace with the loads.
//   - Grid. One block of 1024 threads an SM, launched cooperatively; about
//     6 words a thread at 1024 x 2048 x 3.
//   - Merge and no zero fill. Block 0 zeroes out and every block arrives at
//     the grid-wide barrier at the start; after counting, thread r sums row
//     r of its table, and each block adds its non-zero bins to out with one
//     64-bit atomic per pair of bins, once the barrier has let it through
//     (by then long passed). Nothing is kept from one call to the next.
//
// Contract: x holds n < 2^31 values in [0, 255] of c interleaved channels
// (value i belongs to channel i % c); out is a (c, 256) int32 table on the
// same device, written in full (its contents on entry are ignored). C
// interface, loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; launched
// on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCols = 16;            // table columns, lane % 16
constexpr int kBatch = 6;            // 8-byte words a thread loads at once
constexpr int kMaxChannels = 4;
constexpr int kMaxDevices = 64;

// head: bytes before the first 16-byte boundary; nwords: 8-byte words
// after it; tail: the bytes after those (< 8), whose first has channel
// tail_channel.
template <int C>
__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ x, int head, long long nwords, int tail,
               int tail_channel, int* __restrict__ out) {
  constexpr int kRows = C * 256;
  extern __shared__ uint4 smem_vec[];
  int* table = reinterpret_cast<int*>(smem_vec);       // (C, 256, kCols)
  const int col = threadIdx.x & (kCols - 1);
  const uint2* body = reinterpret_cast<const uint2*>(x + head);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint2 w[kBatch];
  auto load = [&](long long k0) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long i = t + (k0 + k) * stride;
      w[k] = i < nwords ? __ldg(body + i) : make_uint2(0, 0);
    }
  };
  load(0);                           // the loads go out first

  for (int i = threadIdx.x; i < kRows * kCols / 4; i += kThreads) {
    smem_vec[i] = make_uint4(0, 0, 0, 0);
  }
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < kRows; b += kThreads) out[b] = 0;
  }
  unsigned int token = grid.barrier_arrive();         // includes a block barrier

  int base[8];                       // byte j of a word: its channel's rows, column col
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    base[j] = static_cast<int>((head + 8 * (t % C) + j) % C) * 256 * kCols + col;
  }
  for (long long k0 = 0;; k0 += kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (t + (k0 + k) * stride < nwords) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t half = j < 4 ? w[k].x : w[k].y;
          atomicAdd(table + base[j] + ((half >> (8 * (j % 4))) & 0xff) * kCols, 1);
        }
      }
    }
    if (t + (k0 + kBatch) * stride >= nwords) break;
    load(k0 + kBatch);
  }
  // Head byte i is value i (channel i % C); tail byte j is value
  // head + 8 nwords + j.
  if (blockIdx.x == gridDim.x - 1) {
    if (threadIdx.x < head) {
      const int i = threadIdx.x;
      atomicAdd(table + ((i % C) * 256 + x[i]) * kCols + col, 1);
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 + tail) {
      const int j = threadIdx.x - 32;
      const uint8_t* tp = x + head + nwords * 8;
      atomicAdd(table + (((tail_channel + j) % C) * 256 + tp[j]) * kCols + col, 1);
    }
  }
  __syncthreads();

  // Thread r sums row r over the columns, starting at column r % kCols so
  // that a warp's reads hit distinct banks, and takes row r + 1's sum from
  // the next lane: one 64-bit atomic adds bins r and r + 1 (counts stay
  // below 2^31, so no carry crosses into the upper bin).
  const int r = threadIdx.x;
  unsigned sum = 0;
  if (r < kRows) {
#pragma unroll
    for (int l = 0; l < kCols; ++l) sum += table[r * kCols + ((r + l) & (kCols - 1))];
  }
  const unsigned next = __shfl_down_sync(0xffffffffu, sum, 1);
  const unsigned long long pair = static_cast<unsigned long long>(next) << 32 | sum;
  grid.barrier_wait(static_cast<unsigned int&&>(token));
  if (r < kRows && (r & 1) == 0 && pair != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out) + (r >> 1), pair);
  }
}

template <int C>
cudaError_t launch(const uint8_t* x, long long n, int* out, cudaStream_t stream) {
  constexpr size_t kSmem = static_cast<size_t>(C) * 256 * kCols * sizeof(int);
  static int blocks_for[kMaxDevices];  // per device, set at its first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidValue;
  const auto kernel = hist256_kernel<C>;
  int& blocks = blocks_for[dev];
  if (blocks == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 3) return cudaErrorInvalidConfiguration;
    blocks = sms - sms % 3;          // one an SM, a multiple of 3
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const long long align = static_cast<long long>((16 - addr % 16) % 16);
  const int head = static_cast<int>(n < align ? n : align);
  const long long nwords = (n - head) / 8;
  const int tail = static_cast<int>(n - head - nwords * 8);
  const int tail_channel = static_cast<int>((n - tail) % C);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, head, nwords, tail, tail_channel, out);
}

}  // namespace

extern "C" int oadg_hist256(const void* x, long long n, int c, void* out, void* stream) {
  if (c < 1 || c > kMaxChannels || n < 0 || n > 0x7fffffffLL || n % c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* px = static_cast<const uint8_t*>(x);
  auto* po = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (c) {
    case 1: err = launch<1>(px, n, po, s); break;
    case 2: err = launch<2>(px, n, po, s); break;
    case 3: err = launch<3>(px, n, po, s); break;
    default: err = launch<4>(px, n, po, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
