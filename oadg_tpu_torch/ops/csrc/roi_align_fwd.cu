// Multilevel RoIAlign forward for Hopper (sm_90a): 7x7 bins (the box head's)
// or 14x14 bins (the mask head's), sampling_ratio 2, aligned=True, CUDA
// out-of-range rule, over up to four FPN levels.
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
// What bounds it on the H100: bytes, the (R, C, 7, 7) f32 output written
// once and each distinct tap cell's channels read once (145.5 MB for 1000
// rois at C=256 on one 1024x2048 image); the FLOPs are negligible. A thread
// per channel that reads its 4 taps for each of the 196 samples issues 784
// scalar loads a channel, fetches taps shared by neighbouring samples again
// (a small roi has fewer than 16x16 distinct cells) and moves ~5x the bound
// through L2. This design reads each distinct tap cell of a roi once and
// contracts separably, as the TPU's A . window . B does:
//
// - `roi_geometry_kernel`, two warps a roi, lists the distinct tap columns
//   and rows of the roi (at most 28 each: the low and high tap of 14
//   samples, deduplicated with __match_any_sync and ranked in increasing
//   order), with the summed weight of each cell in each bin (the y-weights
//   times 1/4, the mean of 2x2 samples), once for all its channel blocks.
// - One thread per (distinct row, 4 channels) reads that row's distinct
//   cells with one 16-byte (f32) or 8-byte (bf16) load each (channels-last
//   maps, so a cell's channels are contiguous) and contracts along x into
//   the 7 bin columns in registers, then stores them in shared memory.
// - One thread per output value contracts along y over the rows of its bin
//   and writes the (C, 7, 7) slab coalesced.
// At the serving shapes this design moves 241.5 MB (a roi's distinct cells
// once, but cells shared by neighbouring rois once per roi) at ~2.5 TB/s on
// an H100, 2.2x the least traffic of the function.
// Maps whose channel count or pointers do not allow 16-byte loads take the
// same kernel with one channel a load. Accumulation is f32 for f32 and bf16
// features alike; only the order of the f32 sums differs from the plain
// version.
//
// At 14x14 (Mask R-CNN's mask branch) the same design is instantiated with
// Out = 14: a roi has 28 samples and 56 candidate taps an axis, more than a
// warp's lanes, so its geometry block uses two warps an axis and finds the
// distinct cells through shared memory instead of __match_any_sync; the x
// sums of up to 56 distinct rows x 14 bins take 28 KB of shared memory at 8
// channels a block (at 32 channels they would take 103 KB), so a 14x14 block
// covers 8 channels. The 7x7 instantiation is the design above, unchanged.
//
// Grid: one block per (roi, 32 channels; 8 at 14x14). C interface, loaded with ctypes by
// oadg_tpu_torch/ops/_kernels.py; the caller passes PyTorch's current stream
// and allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace oadg_roi;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Per bin count: channels a block, and blocks an SM the registers are sized
// for.
template <int Out>
struct Cfg;
template <>
struct Cfg<7> {
  static constexpr int kSlice = 32;
  static constexpr int kMinBlocks = 8;
};
template <>
struct Cfg<14> {
  static constexpr int kSlice = 8;
  static constexpr int kMinBlocks = 4;
};

// Threads an axis in the geometry kernel: a lane a candidate tap.
template <int Out>
struct AxisThreads {
  static constexpr int value = Grid<Out>::kTaps <= 32 ? 32 : 64;
};

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// The distinct tap cells of one axis of a roi, in increasing order, with
// the weight of each in each bin; bin o reads cells first[o]..last[o] (at
// most 4: the low and high taps of its 2 samples).
template <int Out>
struct AxisTables {
  static constexpr int kTaps = Grid<Out>::kTaps;
  int n;
  int cell[kTaps];
  float w[kTaps][Out];
  int first[Out];
  int last[Out];
};

template <int Out>
struct alignas(16) RoiGeometry {
  AxisTables<Out> ax[2];                // 0: columns, 1: rows
  int level;
  int image;
};
static_assert(sizeof(RoiGeometry<7>) % 16 == 0, "copied as float4");
static_assert(sizeof(RoiGeometry<14>) % 16 == 0, "copied as float4");

template <int Out>
struct AxisScratch {
  static constexpr int kTaps = Grid<Out>::kTaps;
  int cand_rank[kTaps];                 // candidate tap -> its cell, -1 if out of range
  float cand_w[kTaps];                  // candidate tap's lerp weight
  unsigned mask[kTaps];                 // bins with a sample on cell j
  int key[AxisThreads<Out>::value];         // build_axis_wide: each candidate's cell
  bool lead[AxisThreads<Out>::value];       // build_axis_wide: first candidate of its cell
};

// The sums of one cell's weights in each bin, from the candidates ranked to
// it, in tap order; and the first and last cell of each bin.
template <int Out>
__device__ __forceinline__ void cell_weights(int cell, float gain, AxisTables<Out>* a,
                                             AxisScratch<Out>* sc) {
  float w[Out];
#pragma unroll
  for (int o = 0; o < Out; ++o) w[o] = 0.f;
  unsigned m = 0;
  for (int k = 0; k < Grid<Out>::kTaps; ++k) {
    if (sc->cand_rank[k] != cell) continue;
    const int bin = k / (2 * kSr);
#pragma unroll
    for (int o = 0; o < Out; ++o) {
      if (o == bin) w[o] += sc->cand_w[k];
    }
    m |= 1u << bin;
  }
#pragma unroll
  for (int o = 0; o < Out; ++o) a->w[cell][o] = w[o] * gain;
  sc->mask[cell] = m;
}

template <int Out>
__device__ __forceinline__ void bin_extent(int o, int n, AxisTables<Out>* a,
                                           const AxisScratch<Out>* sc) {
  int f = 0, l = -1;
  for (int j = 0; j < n; ++j) {
    if (!(sc->mask[j] >> o & 1u)) continue;
    if (l < 0) f = j;
    l = j;
  }
  a->first[o] = f;
  a->last[o] = l;
}

// One warp: lane k < 28 is the low (k even) or high tap of sample k / 2.
template <int Out>
__device__ __forceinline__ void build_axis(float lo, float hi, float scale,
                                           int size, float gain, int lane,
                                           AxisTables<Out>* a, AxisScratch<Out>* sc) {
  constexpr int kTaps = Grid<Out>::kTaps;
  static_assert(kTaps <= 32, "a lane a candidate tap");
  int key = -1;
  float wt = 0.f;
  if (lane < kTaps) {
    const Tap t = sample_tap<Out>(lo, hi, scale, size, lane / 2);
    if (t.ok) key = (lane & 1) ? t.hi : t.lo;
    wt = (lane & 1) ? t.frac : 1.f - t.frac;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  const bool leader = key >= 0 && __ffs(peers) - 1 == lane;
  const unsigned leaders = __ballot_sync(kFull, leader);
  int rank = 0;                         // distinct in-range cells below this one
  for (unsigned m = leaders; m; m &= m - 1) {
    rank += __shfl_sync(kFull, key, __ffs(m) - 1) < key;
  }
  const int n = __popc(leaders);
  if (lane < kTaps) {
    sc->cand_rank[lane] = key >= 0 ? rank : -1;
    sc->cand_w[lane] = wt;
  }
  if (leader) a->cell[rank] = key;
  if (lane == 0) a->n = n;
  __syncwarp();
  if (lane < n) cell_weights<Out>(lane, gain, a, sc);  // lane owns cell `lane`
  __syncwarp();
  if (lane < Out) bin_extent<Out>(lane, n, a, sc);
}

// Two warps, t = 0..63 of the axis, for the 14x14 bins' 56 candidate taps
// (more than a warp's lanes): thread k < 56 is the low (k even) or high tap
// of sample k / 2. The same tables as build_axis; a candidate is its cell's
// leader when no earlier candidate has the cell, and its rank is the count
// of leaders with a lower cell. Every thread of the block calls it: it
// synchronizes the block.
template <int Out>
__device__ __forceinline__ void build_axis_wide(float lo, float hi, float scale,
                                                int size, float gain, int t,
                                                AxisTables<Out>* a, AxisScratch<Out>* sc) {
  constexpr int kTaps = Grid<Out>::kTaps;
  static_assert(kTaps <= AxisThreads<Out>::value, "a thread a candidate tap");
  int key = -1;
  float wt = 0.f;
  if (t < kTaps) {
    const Tap tp = sample_tap<Out>(lo, hi, scale, size, t / 2);
    if (tp.ok) key = (t & 1) ? tp.hi : tp.lo;
    wt = (t & 1) ? tp.frac : 1.f - tp.frac;
  }
  sc->key[t] = key;
  __syncthreads();
  bool leader = key >= 0;
  for (int j = 0; j < t; ++j) leader = leader && sc->key[j] != key;
  sc->lead[t] = leader;
  __syncthreads();
  int rank = 0, n = 0;                  // distinct in-range cells below this one; all
  for (int j = 0; j < kTaps; ++j) {
    if (!sc->lead[j]) continue;
    ++n;
    rank += sc->key[j] < key;
  }
  if (t < kTaps) {
    sc->cand_rank[t] = key >= 0 ? rank : -1;
    sc->cand_w[t] = wt;
  }
  if (leader) a->cell[rank] = key;
  if (t == 0) a->n = n;
  __syncthreads();
  if (t < n) cell_weights<Out>(t, gain, a, sc);
  __syncthreads();
  if (t < Out) bin_extent<Out>(t, n, a, sc);
}

// One block a roi, axis_threads threads an axis: its level, image and both
// axes' tables, once for all the channel blocks of the roi.
template <int Out>
__global__ void __launch_bounds__(2 * AxisThreads<Out>::value)
roi_geometry_kernel(Levels lv, int num_levels, int batch,
                    const float* __restrict__ rois, float finest_scale,
                    RoiGeometry<Out>* __restrict__ geo) {
  __shared__ AxisScratch<Out> sc[2];
  constexpr int kAxis = AxisThreads<Out>::value;
  const int r = blockIdx.x;
  const int axis = threadIdx.x / kAxis;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int lvl = roi_level(roi, num_levels, finest_scale);
  RoiGeometry<Out>* g = geo + r;
  const float gain = axis ? 1.f / (kSr * kSr) : 1.f;
  const int size = axis ? lv.h[lvl] : lv.w[lvl];
  if constexpr (kAxis == 32) {
    build_axis<Out>(roi[1 + axis], roi[3 + axis], lv.scale[lvl], size, gain,
                    threadIdx.x % 32, &g->ax[axis], &sc[axis]);
  } else {
    build_axis_wide<Out>(roi[1 + axis], roi[3 + axis], lv.scale[lvl], size, gain,
                         threadIdx.x % kAxis, &g->ax[axis], &sc[axis]);
  }
  if (threadIdx.x == 0) {
    g->level = lvl;
    g->image = roi_batch(roi, batch);
  }
}

template <typename T, int V>
struct Load;

template <>
struct Load<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Load<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Load<float, 1> {
  __device__ __forceinline__ static void run(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Load<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <typename T, int V, int Out>
__global__ void __launch_bounds__(kThreads, Cfg<Out>::kMinBlocks)
roi_align_fwd_kernel(Levels lv, int channels, const RoiGeometry<Out>* __restrict__ geo,
                     float* __restrict__ out) {
  constexpr int kSlice = Cfg<Out>::kSlice;
  constexpr int kBins = Out * Out;
  __shared__ RoiGeometry<Out> g;
  __shared__ float s_rx[Grid<Out>::kTaps][Out][kSlice + 1];

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kSlice;
  const int tid = threadIdx.x;
  constexpr int kWords = sizeof(RoiGeometry<Out>) / 16;
  for (int i = tid; i < kWords; i += kThreads) {
    reinterpret_cast<float4*>(&g)[i] = __ldg(reinterpret_cast<const float4*>(geo + r) + i);
  }
  __syncthreads();
  const AxisTables<Out>* ax = g.ax;
  const int level = g.level;
  const void* map = lv.ptr[0];
  int H = lv.h[0], W = lv.w[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {  // compile-time indices: no local copy of lv
    if (l == level) {
      map = lv.ptr[l];
      H = lv.h[l];
      W = lv.w[l];
    }
  }
  const int b = g.image;
  const int nx = ax[0].n;
  const int ny = ax[1].n;
  const int nc = min(kSlice, channels - c0);
  constexpr int kVecs = kSlice / V;
  const T* base = static_cast<const T*>(map) + static_cast<size_t>(b) * H * W * channels + c0;
  // x-contraction: s_rx[row j][ox][ch] = sum over columns of Bx * map
  for (int it = tid; it < ny * kVecs; it += kThreads) {
    const int jy = it / kVecs;
    const int cv = (it % kVecs) * V;
    float acc[Out][V];
#pragma unroll
    for (int o = 0; o < Out; ++o) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[o][e] = 0.f;
    }
    if (cv < nc) {
      // Bin ox reads its (at most 4) distinct columns first..last: their
      // loads are issued together, and no branch depends on the data.
      const T* row = base + static_cast<size_t>(ax[1].cell[jy]) * W * channels + cv;
#pragma unroll
      for (int ox = 0; ox < Out; ++ox) {
        const int f = ax[0].first[ox];
        const int n = ax[0].last[ox] - f + 1;
        float v[4][V];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < n) Load<T, V>::run(row + static_cast<size_t>(ax[0].cell[f + q]) * channels, v[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n) continue;
          const float w = ax[0].w[f + q][ox];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[ox][e] = fmaf(w, v[q][e], acc[ox][e]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < Out; ++o) {
#pragma unroll
      for (int e = 0; e < V; ++e) s_rx[jy][o][cv + e] = acc[o][e];
    }
  }
  __syncthreads();

  // y-contraction; out[r, c0:c0+nc, :, :] is one contiguous run of nc * Out^2.
  float* dst = out + (static_cast<size_t>(r) * channels + c0) * kBins;
  for (int i = tid; i < nc * kBins; i += kThreads) {
    const int ch = i / kBins;
    const int oy = (i % kBins) / Out;
    const int ox = i % Out;
    float s = 0.f;
    for (int j = ax[1].first[oy]; j <= ax[1].last[oy]; ++j) {
      s = fmaf(ax[1].w[j][oy], s_rx[j][ox][ch], s);
    }
    dst[i] = s;
  }
}

// Channels a thread loads at once: 4, 16 bytes of f32 or 8 of bf16. With 8
// bf16 channels (16 bytes) the 7 x 8 sums need more registers than 8 blocks
// an SM leave, and the kernel spilled and ran at half the speed of f32 at
// the serving shapes on an H100.
constexpr int kVec = 4;

template <typename T, int Out>
void launch(const Levels& lv, int num_levels, int batch, const float* rois,
            float finest_scale, bool vec, int channels, void* scratch, int num_rois,
            float* out, cudaStream_t s) {
  RoiGeometry<Out>* geo = static_cast<RoiGeometry<Out>*>(scratch);
  roi_geometry_kernel<Out><<<num_rois, 2 * AxisThreads<Out>::value, 0, s>>>(
      lv, num_levels, batch, rois, finest_scale, geo);
  constexpr int kSlice = Cfg<Out>::kSlice;
  const dim3 grid(num_rois, (channels + kSlice - 1) / kSlice);
  if (vec) {
    roi_align_fwd_kernel<T, kVec, Out><<<grid, kThreads, 0, s>>>(lv, channels, geo, out);
  } else {
    roi_align_fwd_kernel<T, 1, Out><<<grid, kThreads, 0, s>>>(lv, channels, geo, out);
  }
}

}  // namespace

// Bytes of device scratch oadg_roi_align_fwd needs for num_rois rois at
// out_size x out_size bins; -1 for a bin count it is not built for (7, 14).
extern "C" long long oadg_roi_align_fwd_scratch_bytes(int num_rois, int out_size) {
  if (out_size == 7) return static_cast<long long>(num_rois) * sizeof(RoiGeometry<7>);
  if (out_size == 14) return static_cast<long long>(num_rois) * sizeof(RoiGeometry<14>);
  return -1;
}

// feats: num_levels device pointers to channels-last (B, H_l, W_l, C) maps of
// one dtype (0 = float32, 1 = bfloat16); heights/widths/scales: host arrays of
// num_levels entries; out_size: bins a side, 7 or 14; rois: device
// (num_rois, 5) float32 [batch, x1, y1, x2, y2]; out: device (num_rois, C,
// out_size, out_size) float32; scratch: device, 16-byte aligned, of
// oadg_roi_align_fwd_scratch_bytes. Returns the cudaError_t of the launches
// (0 on success).
extern "C" int oadg_roi_align_fwd(const void* const* feats,
                                  const int* heights, const int* widths,
                                  const float* scales, int num_levels,
                                  int batch, int channels, int dtype, int out_size,
                                  const float* rois, int num_rois,
                                  float finest_scale, float* out, void* scratch,
                                  long long scratch_bytes, void* stream) {
  const long long need = oadg_roi_align_fwd_scratch_bytes(num_rois, out_size);
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 ||
      channels < 1 || num_rois < 0 || (dtype != 0 && dtype != 1) || need < 0 ||
      scratch_bytes < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  Levels lv = {};
  const int bytes = kVec * (dtype == 0 ? 4 : 2);
  bool vec = channels % kVec == 0;
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = feats[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.scale[l] = scales[l];
    vec = vec && reinterpret_cast<uintptr_t>(feats[l]) % bytes == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_size == 7) {
    launch<float, 7>(lv, num_levels, batch, rois, finest_scale, vec, channels, scratch,
                     num_rois, out, s);
  } else if (dtype == 0) {
    launch<float, 14>(lv, num_levels, batch, rois, finest_scale, vec, channels, scratch,
                      num_rois, out, s);
  } else if (out_size == 7) {
    launch<__nv_bfloat16, 7>(lv, num_levels, batch, rois, finest_scale, vec, channels,
                             scratch, num_rois, out, s);
  } else {
    launch<__nv_bfloat16, 14>(lv, num_levels, batch, rois, finest_scale, vec, channels,
                              scratch, num_rois, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
