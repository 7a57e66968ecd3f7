// Multilevel RoIAlign backward for Hopper (sm_90a): the gradient of the
// forward kernel roi_align_fwd.cu with respect to the FPN maps (7x7 bins,
// sampling_ratio 2, aligned=True, up to four levels). Rois get no gradient.
//
// Replaces oadg_tpu/ops/pallas_roi_bwd.py:roi_bwd_window_pallas (the TPU
// kernel _kernel, which read-modify-writes G = A . dy . B^T into each roi's
// DMA window, one roi after another) together with the violator passes and
// the exact tap-scatter loop that finish its work in
// oadg_tpu/ops/roi_align.py:_ml_bwd. Blocks on the H100 run in parallel and
// in no order, so the contributions of rois that overlap meet in f32
// atomicAdd instead of a sequential window walk, and no window classes exist.
//
// Each sample's dy / 4 is splatted into its four taps with the bilinear
// weights of the forward: (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx. The taps
// and weights come from roi_align_geometry.cuh, the header the forward
// kernel uses, so forward and backward agree bit for bit on both.
//
// What bounds it on the H100: memory traffic to the gradient table. The
// table is zeroed (by the caller) and every tap a roi touches is read and
// written once per contribution through L2 atomics; the FLOPs are
// negligible. The layout answers part of that: gradient maps are
// channels-last f32 and one thread owns one channel, so the 32 atomics of a
// warp land on one 128-byte line. The block's dy slab, (128 channels x 49
// bins) f32, is staged in shared memory with coalesced loads, because
// dy[r, c, oy, ox] read per thread strides by 49 floats. Sums run in atomic
// order, which changes from run to run; the result agrees with the plain
// version to f32 rounding of the reordered sums.
//
// Grid: one block per (roi, tile of 128 channels). C interface, loaded with
// ctypes by oadg_tpu_torch/ops/_kernels.py; the caller passes PyTorch's
// current stream and allocates the zeroed gradient maps.

#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace oadg_roi;

struct GradLevels {
  float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__global__ void __launch_bounds__(kChanTile)
roi_align_bwd_kernel(GradLevels lv, int num_levels, int batch, int channels,
                     const float* __restrict__ rois, float finest_scale,
                     const float* __restrict__ dy) {
  __shared__ Samples s;
  __shared__ float s_dy[kChanTile * kBins];

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kChanTile;
  const int tid = threadIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int lvl = roi_level(roi, num_levels, finest_scale);
  const int b = roi_batch(roi, batch);
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  roi_samples(roi, lv.scale[lvl], H, W, tid, &s);

  // dy[r, c0:c0+nc, :, :] is one contiguous run of nc * 49 floats; each
  // sample carries a quarter of its bin's gradient (the mean of 2x2).
  const int nc = min(kChanTile, channels - c0);
  const float* src = dy + (static_cast<size_t>(r) * channels + c0) * kBins;
  for (int i = tid; i < nc * kBins; i += kChanTile) {
    s_dy[i] = src[i] * (1.f / (kSr * kSr));
  }
  __syncthreads();

  const int c = c0 + tid;
  if (c >= channels) return;
  float* base = lv.ptr[lvl] + static_cast<size_t>(b) * H * W * channels + c;
  const size_t row = static_cast<size_t>(W) * channels;
  for (int oy = 0; oy < kOut; ++oy) {
    for (int ox = 0; ox < kOut; ++ox) {
      const float g = s_dy[tid * kBins + oy * kOut + ox];
#pragma unroll
      for (int sy = 0; sy < kSr; ++sy) {
        const int iy = oy * kSr + sy;
        if (!s.ok[1][iy]) continue;
        float* r0 = base + s.lo[1][iy] * row;
        float* r1 = base + s.hi[1][iy] * row;
        const float fy = s.frac[1][iy];
#pragma unroll
        for (int sx = 0; sx < kSr; ++sx) {
          const int ix = ox * kSr + sx;
          if (!s.ok[0][ix]) continue;
          const size_t x0 = static_cast<size_t>(s.lo[0][ix]) * channels;
          const size_t x1 = static_cast<size_t>(s.hi[0][ix]) * channels;
          const float fx = s.frac[0][ix];
          atomicAdd(r0 + x0, g * ((1.f - fy) * (1.f - fx)));
          atomicAdd(r0 + x1, g * ((1.f - fy) * fx));
          atomicAdd(r1 + x0, g * (fy * (1.f - fx)));
          atomicAdd(r1 + x1, g * (fy * fx));
        }
      }
    }
  }
}

}  // namespace

// grads: num_levels device pointers to zeroed channels-last (B, H_l, W_l, C)
// float32 maps, accumulated in place; heights/widths/scales: host arrays of
// num_levels entries; rois: device (num_rois, 5) float32
// [batch, x1, y1, x2, y2]; dy: device (num_rois, C, 7, 7) float32,
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int oadg_roi_align_bwd(float* const* grads, const int* heights,
                                  const int* widths, const float* scales,
                                  int num_levels, int batch, int channels,
                                  const float* rois, int num_rois,
                                  float finest_scale, const float* dy,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 ||
      channels < 1 || num_rois < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  GradLevels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = grads[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.scale[l] = scales[l];
  }
  const dim3 grid(num_rois, (channels + kChanTile - 1) / kChanTile);
  roi_align_bwd_kernel<<<grid, kChanTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, num_levels, batch, channels, rois, finest_scale, dy);
  return static_cast<int>(cudaGetLastError());
}
