// Per-roi sample geometry shared by the RoIAlign forward (roi_align_fwd.cu)
// and backward (roi_align_bwd.cu) kernels, so that both read and write the
// same taps with the same weights: 7x7 or 14x14 bins (the template parameter
// `Out` of each function; the box head takes 7, the mask head 14),
// sampling_ratio 2, aligned=True, CUDA out-of-range rule, up to four FPN
// levels.
//
// Semantics (oadg_tpu/ops/roi_align.py:123-309):
//   level  = clamp(floor(log2(sqrt(area) / finest_scale + 1e-6)), 0, L-1)
//   x1     = roi_x1 * scale[level] - 0.5          (scale = f32(1/stride))
//   bin_w  = (x2 - x1) / Out,  sample x = x1 + (ox + (s + 0.5) / 2) * bin_w
//   a sample outside (-1, W) x (-1, H) contributes 0; otherwise it is clamped
//   to [0, W-1] x [0, H-1] and the high tap saturates at the edge.
// The geometry is rounded exactly as XLA evaluates the JAX package's
// formula: a division by a constant becomes a product with its f32
// reciprocal (f32(1/7), f32(1/14): neither is exact, and both sides multiply
// by the same rounded value), and a multiply-add is one fused fma. The plain PyTorch
// versions compute the same roundings, so tap indices and weights agree bit
// for bit.
#pragma once

#include <cuda_runtime.h>

namespace oadg_roi {

constexpr int kSr = 2;                  // samples per bin side
constexpr int kMaxLevels = 4;

// Samples and candidate taps (each sample's low and high tap) per axis of a
// roi with Out bins a side. Constants, not constexpr functions: device code
// may read a static constexpr member but not call a host function.
template <int Out>
struct Grid {
  static constexpr int kS = Out * kSr;
  static constexpr int kTaps = 2 * kS;
};

// The 2 Out x-samples ([0]) and 2 Out y-samples ([1]) of one roi: low and
// high tap, the weight of the high tap, and whether the sample is in range.
template <int Out>
struct Samples {
  static constexpr int kS = Grid<Out>::kS;
  int lo[2][kS];
  int hi[2][kS];
  float frac[2][kS];
  bool ok[2][kS];
};

// FPN level of the roi at `roi` ([batch, x1, y1, x2, y2]); every thread of
// a block derives the same.
__device__ __forceinline__ int roi_level(const float* roi, int num_levels,
                                         float finest_scale) {
  const float area = __fmul_rn(__fsub_rn(roi[3], roi[1]),
                               __fsub_rn(roi[4], roi[2]));
  const float lvl_f = floorf(log2f(
      __fmaf_rn(sqrtf(area), __fdiv_rn(1.f, finest_scale), 1e-6f)));
  int lvl = 0;                          // NaN maps to level 0
  if (lvl_f >= 0.f) lvl = static_cast<int>(fminf(lvl_f, num_levels - 1.f));
  return lvl;
}

__device__ __forceinline__ int roi_batch(const float* roi, int batch) {
  const int b = static_cast<int>(roi[0]);
  return min(max(b, 0), batch - 1);
}

// Sample i (0..2 Out - 1) of one axis of a roi whose box spans [lo, hi] image
// pixels on that axis, at a level of `size` cells and `scale` = 1/stride:
// whether it is in range, its low and high tap and the high tap's weight.
struct Tap {
  int lo;
  int hi;
  float frac;
  bool ok;
};

template <int Out>
__device__ __forceinline__ Tap sample_tap(float lo, float hi, float scale,
                                          int size, int i) {
  const float a = __fsub_rn(__fmul_rn(lo, scale), 0.5f);
  const float e = __fsub_rn(__fmul_rn(hi, scale), 0.5f);
  const float pos = static_cast<float>(i / kSr) +
                    (static_cast<float>(i % kSr) + 0.5f) / kSr;
  const float bin = __fmul_rn(__fsub_rn(e, a), 1.f / Out);
  const float p = __fmaf_rn(pos, bin, a);
  const float pc = fminf(fmaxf(p, 0.f), static_cast<float>(size - 1));
  const int i0 = static_cast<int>(floorf(pc));
  Tap t;
  t.ok = (p > -1.f) && (p < static_cast<float>(size));
  t.lo = i0;
  t.hi = min(i0 + 1, size - 1);
  t.frac = pc - static_cast<float>(i0);
  return t;
}

// Threads tid = 0, stride, 2 stride, .. of the caller fill `s` for the roi
// (4 Out entries: 28 at 7x7, 56 at 14x14); the caller synchronizes.
template <int Out>
__device__ __forceinline__ void roi_samples(const float* roi, float scale,
                                            int H, int W, int tid, int stride,
                                            Samples<Out>* s) {
  constexpr int kS = Grid<Out>::kS;
  for (int k = tid; k < 2 * kS; k += stride) {
    const int axis = k / kS;            // 0: x, 1: y
    const int i = k % kS;
    const Tap t = axis ? sample_tap<Out>(roi[2], roi[4], scale, H, i)
                       : sample_tap<Out>(roi[1], roi[3], scale, W, i);
    s->ok[axis][i] = t.ok;
    s->lo[axis][i] = t.lo;
    s->hi[axis][i] = t.hi;
    s->frac[axis][i] = t.frac;
  }
}

// The cells that the in-range taps of one axis read: [first, last], or
// first > last when no sample of the axis is in range. The plain twin is
// `_tap_extent` in oadg_tpu_torch/ops/roi_align.py.
template <int Out>
__device__ __forceinline__ void tap_extent(float lo, float hi, float scale,
                                           int size, int* first, int* last) {
  int f = size, l = -1;
  for (int i = 0; i < Grid<Out>::kS; ++i) {
    const Tap t = sample_tap<Out>(lo, hi, scale, size, i);
    if (!t.ok) continue;
    f = min(f, t.lo);
    l = max(l, t.hi);
  }
  *first = f;
  *last = l;
}

}  // namespace oadg_roi
