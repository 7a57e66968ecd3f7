// Multilevel RoIAlign forward for Hopper (sm_90a): 7x7 bins, sampling_ratio 2,
// aligned=True, CUDA out-of-range rule, over up to four FPN levels.
//
// Replaces oadg_tpu/ops/pallas_roi_bwd.py:roi_fwd_window_pallas (the TPU
// window kernel, _fwd_kernel) together with the fallbacks that finish its
// work in oadg_tpu/ops/roi_align.py:_roi_align_forward (violator passes and
// the exact-tap loop). On the TPU those pieces exist because the kernel can
// only DMA a fixed window per roi; here every roi reads its taps directly, so
// one launch covers every roi and there are no window classes.
//
// Semantics and rounding: roi_align_geometry.cuh, shared with the backward
// kernel roi_align_bwd.cu so that both use the same taps and weights.
//
// What bounds it on the H100: gathered bytes. Each output value reads
// 4 samples x 4 taps of one channel; the FLOPs are negligible. The design
// answers that with the layout: level maps are channels-last (NHWC memory),
// one thread owns one channel, so the 32 threads of a warp read 32
// neighbouring channels of the same tap (one 128-byte line in f32). The
// per-roi tap geometry (14 x-samples and 14 y-samples) is computed once per
// block into shared memory, and the (C, 7, 7) output slab is staged in shared
// memory so that the store to the (R, C, 7, 7) output is coalesced.
// Accumulation is f32 for f32 and bf16 features alike.
//
// Grid: one block per (roi, tile of 128 channels). C interface, loaded with
// ctypes by oadg_tpu_torch/ops/_kernels.py; the caller passes PyTorch's
// current stream and allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace oadg_roi;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kChanTile)
roi_align_fwd_kernel(Levels lv, int num_levels, int batch, int channels,
                     const float* __restrict__ rois, float finest_scale,
                     float* __restrict__ out) {
  __shared__ Samples s;
  __shared__ float s_out[kChanTile * kBins];

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kChanTile;
  const int tid = threadIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int lvl = roi_level(roi, num_levels, finest_scale);
  const int b = roi_batch(roi, batch);
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  roi_samples(roi, lv.scale[lvl], H, W, tid, &s);
  __syncthreads();

  const int c = c0 + tid;
  if (c < channels) {
    const T* base = static_cast<const T*>(lv.ptr[lvl]) +
                    static_cast<size_t>(b) * H * W * channels + c;
    const size_t row = static_cast<size_t>(W) * channels;
    for (int oy = 0; oy < kOut; ++oy) {
      for (int ox = 0; ox < kOut; ++ox) {
        float acc = 0.f;
#pragma unroll
        for (int sy = 0; sy < kSr; ++sy) {
          const int iy = oy * kSr + sy;
          if (!s.ok[1][iy]) continue;
          const T* r0 = base + s.lo[1][iy] * row;
          const T* r1 = base + s.hi[1][iy] * row;
          const float fy = s.frac[1][iy];
#pragma unroll
          for (int sx = 0; sx < kSr; ++sx) {
            const int ix = ox * kSr + sx;
            if (!s.ok[0][ix]) continue;
            const size_t x0 = static_cast<size_t>(s.lo[0][ix]) * channels;
            const size_t x1 = static_cast<size_t>(s.hi[0][ix]) * channels;
            const float fx = s.frac[0][ix];
            const float top = to_f32(r0[x0]) * (1.f - fx) + to_f32(r0[x1]) * fx;
            const float bot = to_f32(r1[x0]) * (1.f - fx) + to_f32(r1[x1]) * fx;
            acc += top * (1.f - fy) + bot * fy;
          }
        }
        s_out[tid * kBins + oy * kOut + ox] = acc * (1.f / (kSr * kSr));
      }
    }
  }
  __syncthreads();

  // out[r, c0:c0+nc, :, :] is one contiguous run of nc * 49 floats.
  const int nc = min(kChanTile, channels - c0);
  float* dst = out + (static_cast<size_t>(r) * channels + c0) * kBins;
  for (int i = tid; i < nc * kBins; i += kChanTile) dst[i] = s_out[i];
}

}  // namespace

// feats: num_levels device pointers to channels-last (B, H_l, W_l, C) maps of
// one dtype (0 = float32, 1 = bfloat16); heights/widths/scales: host arrays of
// num_levels entries; rois: device (num_rois, 5) float32
// [batch, x1, y1, x2, y2]; out: device (num_rois, C, 7, 7) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int oadg_roi_align_fwd(const void* const* feats,
                                  const int* heights, const int* widths,
                                  const float* scales, int num_levels,
                                  int batch, int channels, int dtype,
                                  const float* rois, int num_rois,
                                  float finest_scale, float* out,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 ||
      channels < 1 || num_rois < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = feats[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.scale[l] = scales[l];
  }
  const dim3 grid(num_rois, (channels + kChanTile - 1) / kChanTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, kChanTile, 0, s>>>(
        lv, num_levels, batch, channels, rois, finest_scale, out);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, kChanTile, 0, s>>>(
        lv, num_levels, batch, channels, rois, finest_scale, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
