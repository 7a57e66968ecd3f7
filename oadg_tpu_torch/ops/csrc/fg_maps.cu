// OA-Mix foreground maps for Hopper (sm_90a): for G separable box masks
// m_i(y, x) = fy[i, y] * fx[i, x], one pass writes
//   best_id(y, x) = argmax_i m_i (int8; G where the best mask is below
//                   kBidEps, ties to the lowest index),
//   cover(y, x)   = clip(1 - prod_i (1 - m_i), 0, 1) (bf16),
//   union(y, x)   = max_i m_i (bf16).
//
// Replaces oadg_tpu/ops/pallas_fg.py:fg_maps_pallas (the TPU kernel
// _fg_kernel), whose plain counterpart is fg_maps_xla (:83-91).
//
// What bounds it on the H100: bytes written. The inputs are G x (H + W)
// floats; the outputs are 5 bytes per pixel (10.5 MB at 1024 x 2048) and the
// work is ~5 G flops per pixel, far below the card's rate. The design keeps
// everything but the three outputs out of device memory: a block of 32 x 8
// threads owns a 32 x 8 pixel tile, stages the tile's G x 32 fx values and
// G x 8 fy values in shared memory, and runs the G loop in registers. Each
// warp writes one row segment of 32 pixels (32 bytes of best_id, 64 of
// each bf16 map).
//
// Rounding: m is one f32 product (__fmul_rn, never contracted into the
// following 1 - m), and the product over i runs in index order, as the
// plain PyTorch version does; bf16 outputs are round-to-nearest-even.
//
// C interface, loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; the
// caller allocates the outputs and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxBoxes = 127;           // best_id is int8
constexpr float kBidEps = 1e-5f;

__global__ void fg_maps_kernel(const float* __restrict__ fx,
                               const float* __restrict__ fy, int g, int h,
                               int w, int8_t* __restrict__ best_id,
                               __nv_bfloat16* __restrict__ cover,
                               __nv_bfloat16* __restrict__ uni) {
  extern __shared__ float smem[];
  float* sx = smem;                      // (g, kTileX)
  float* sy = smem + g * kTileX;         // (g, kTileY)
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  for (int i = tid; i < g * kTileX; i += kTileX * kTileY) {
    const int x = x0 + i % kTileX;
    sx[i] = x < w ? fx[(i / kTileX) * w + x] : 0.f;
  }
  for (int i = tid; i < g * kTileY; i += kTileX * kTileY) {
    const int y = y0 + i % kTileY;
    sy[i] = y < h ? fy[(i / kTileY) * h + y] : 0.f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float best = -1.f, one_minus = 1.f, un = 0.f;
  int bid = g;
  for (int i = 0; i < g; ++i) {
    const float m = __fmul_rn(sy[i * kTileY + threadIdx.y], sx[i * kTileX + threadIdx.x]);
    if (m > best && m >= kBidEps) {
      best = m;
      bid = i;
    }
    one_minus = __fmul_rn(one_minus, __fsub_rn(1.f, m));
    un = fmaxf(un, m);
  }
  const long long o = static_cast<long long>(y) * w + x;
  best_id[o] = static_cast<int8_t>(bid);
  cover[o] = __float2bfloat16_rn(fminf(fmaxf(__fsub_rn(1.f, one_minus), 0.f), 1.f));
  uni[o] = __float2bfloat16_rn(un);
}

}  // namespace

extern "C" int oadg_fg_maps(const void* fx, const void* fy, int g, int h, int w,
                            void* best_id, void* cover, void* uni, void* stream) {
  if (g < 1 || g > kMaxBoxes || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const size_t smem = static_cast<size_t>(g) * (kTileX + kTileY) * sizeof(float);
  fg_maps_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fx), static_cast<const float*>(fy), g, h, w,
      static_cast<int8_t*>(best_id), static_cast<__nv_bfloat16*>(cover),
      static_cast<__nv_bfloat16*>(uni));
  return static_cast<int>(cudaGetLastError());
}
