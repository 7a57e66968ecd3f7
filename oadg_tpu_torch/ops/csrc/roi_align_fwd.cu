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
// Semantics (oadg_tpu/ops/roi_align.py:123-243):
//   level  = clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, L-1)
//   x1     = roi_x1 * scale[level] - 0.5          (scale = f32(1/stride))
//   bin_w  = (x2 - x1) / 7,  sample x = x1 + (ox + (s + 0.5) / 2) * bin_w
//   a sample outside (-1, W) x (-1, H) contributes 0; otherwise it is clamped
//   to [0, W-1] x [0, H-1] and the high tap saturates at the edge;
//   each bin is the mean of its 2x2 samples.
// The geometry is rounded exactly as XLA evaluates the JAX package's
// formula: a division by a constant becomes a product with its f32
// reciprocal, and a multiply-add is one fused fma. The plain version computes
// the same
// roundings, so tap indices and weights agree bit for bit; only the order of
// the final sums differs.
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

namespace {

constexpr int kOut = 7;                 // bins per side
constexpr int kSr = 2;                  // samples per bin side
constexpr int kS = kOut * kSr;          // samples per axis
constexpr int kBins = kOut * kOut;
constexpr int kMaxLevels = 4;
constexpr int kChanTile = 128;          // threads per block = channels per block

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
  __shared__ int s_lo[2][kS];           // [0] = x samples, [1] = y samples
  __shared__ int s_hi[2][kS];
  __shared__ float s_frac[2][kS];
  __shared__ bool s_ok[2][kS];
  __shared__ float s_out[kChanTile * kBins];

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kChanTile;
  const int tid = threadIdx.x;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const float rx1 = roi[1], ry1 = roi[2], rx2 = roi[3], ry2 = roi[4];

  // Level of this roi; every thread derives the same value.
  const float area = __fmul_rn(__fsub_rn(rx2, rx1), __fsub_rn(ry2, ry1));
  const float lvl_f = floorf(log2f(
      __fmaf_rn(sqrtf(area), __fdiv_rn(1.f, finest_scale), 1e-6f)));
  int lvl = 0;                          // NaN maps to level 0
  if (lvl_f >= 0.f) lvl = static_cast<int>(fminf(lvl_f, num_levels - 1.f));
  int b = static_cast<int>(roi[0]);
  b = min(max(b, 0), batch - 1);
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];

  if (tid < 2 * kS) {
    const int axis = tid / kS;          // 0: x, 1: y
    const int s = tid % kS;
    const float lo = axis ? ry1 : rx1;
    const float hi = axis ? ry2 : rx2;
    const int size = axis ? H : W;
    const float sc = lv.scale[lvl];
    const float a = __fsub_rn(__fmul_rn(lo, sc), 0.5f);
    const float e = __fsub_rn(__fmul_rn(hi, sc), 0.5f);
    const float pos = static_cast<float>(s / kSr) +
                      (static_cast<float>(s % kSr) + 0.5f) / kSr;
    const float bin = __fmul_rn(__fsub_rn(e, a), 1.f / kOut);
    const float p = __fmaf_rn(pos, bin, a);
    const float pc = fminf(fmaxf(p, 0.f), static_cast<float>(size - 1));
    const int i0 = static_cast<int>(floorf(pc));
    s_ok[axis][s] = (p > -1.f) && (p < static_cast<float>(size));
    s_lo[axis][s] = i0;
    s_hi[axis][s] = min(i0 + 1, size - 1);
    s_frac[axis][s] = pc - static_cast<float>(i0);
  }
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
          if (!s_ok[1][iy]) continue;
          const T* r0 = base + s_lo[1][iy] * row;
          const T* r1 = base + s_hi[1][iy] * row;
          const float fy = s_frac[1][iy];
#pragma unroll
          for (int sx = 0; sx < kSr; ++sx) {
            const int ix = ox * kSr + sx;
            if (!s_ok[0][ix]) continue;
            const size_t x0 = static_cast<size_t>(s_lo[0][ix]) * channels;
            const size_t x1 = static_cast<size_t>(s_hi[0][ix]) * channels;
            const float fx = s_frac[0][ix];
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
