// Multilevel RoIAlign backward for Hopper (sm_90a): the gradient of the
// forward kernel roi_align_fwd.cu with respect to the FPN maps (7x7 or 14x14
// bins, sampling_ratio 2, aligned=True, up to four levels). Rois get no
// gradient.
//
// Replaces oadg_tpu/ops/pallas_roi_bwd.py:roi_bwd_window_pallas (the TPU
// kernel _kernel, which read-modify-writes G = A . dy . B^T into each roi's
// DMA window, one roi after another) together with the violator passes and
// the exact tap-scatter loop that finish its work in
// oadg_tpu/ops/roi_align.py:_ml_bwd.
//
// Semantics: each sample's dy / 4 goes to its four taps with the bilinear
// weights of the forward, (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx, from
// roi_align_geometry.cuh, the header the forward kernel uses. The weights
// are separable, so a roi's gradient in a block of cells is
// G[y, x] = sum_oy Ay[y, oy] * sum_ox Bx[x, ox] * dy[oy, ox], where Ay sums
// the y-weights (times 1/4) of the samples of bin oy that land on row y and
// Bx the x-weights of the samples of bin ox that land on column x.
//
// The least it must move on the H100 is the gradient maps, written once:
// every level of every image (713 MB in f32 for 4 images of 1024x2048 and
// C=256), while dy is 105 MB at R=2088. A thread per (roi, channel) that
// adds each tap with an L2 atomic needs the maps zeroed first (a separate
// pass) and cast afterwards for bf16, and serialises 784 atomics a (roi,
// channel) in L2, in an order that changes from run to run. This design is
// owner-computes, so that the maps are written once, zeros included, with
// no zero fill, no atomics and no cast pass:
//
// 1. Binning, three small kernels on the caller's stream, nothing read back
//    to the host. A tile is an 8x8 block of cells of one level of one
//    image; a bucket is one level of one image. `roi_extent_kernel` gives
//    each roi its bucket and the rectangle of tiles that its in-range taps
//    touch (tap_extent in the header); `bucket_kernel` lists each bucket's
//    rois in increasing roi index (one block a bucket, a ballot over all
//    rois); `tile_lists_kernel` lists, per tile, the rois of its bucket whose
//    rectangle holds it (one warp a tile, a ballot over the bucket's list),
//    in a region with room for every roi of the bucket, so that one pass
//    needs no counts first. The buckets keep each tile's scan to the rois
//    of its level and image (a scan of every roi for every tile, counted
//    and then filled, made the whole kernel 8% slower on an H100). The
//    host sizes the buffers from a bound it can compute (every roi touching
//    every tile of the largest level), not from a device count.
// 2. `roi_grad_tile_kernel`: one block per (tile, 128 channels), 256
//    threads; thread t owns one channel of one column half of the tile (32
//    cells) in registers, so every (cell, channel) is summed by exactly one
//    thread. The rois of the tile's list go in groups of up to 4: one warp
//    each builds the roi's weights on the tile's 8 rows and 8 columns, then
//    the block stages the dy bins that reach the tile (only those: 1.74x dy
//    in all at the flagship's shapes, mostly from L2) and each thread
//    contracts along x over the bins that reach its columns and adds the
//    y-contraction to its registers, skipping column and row halves that a
//    roi or bin misses. At the flagship's shapes a tile lists 2-5 rois on
//    average, and the 21,881 (roi, tile) pairs of R=2088 ask ~0.04 ms of
//    instruction issue. What the kernel spends beyond the write is the
//    latency of each block's chain of dependent steps (list, roi, tables,
//    barrier, dy, barrier, sums) at 3 blocks an SM (80 registers a thread):
//    issuing two bins' loads together, three bin rows at once, letting
//    each block scan its bucket's list itself (no list kernel), or one
//    block a tile for all its channel slices (tables built once) made it
//    slower; the last two spilled registers.
// 3. Each tile is written once, in the maps' dtype: f32, or bf16 rounded
//    once from the f32 sum.
//
// At 14x14 (the mask branch) the same kernels are instantiated with Out = 14:
// a roi has 28 samples an axis (two a lane in build_tables) and up to 196
// bins reach a tile (a roi of at most 8 cells a side), so a group stages up
// to 196 bins, and a block takes 32 channels (two warps, two rois a group)
// to keep the staged bins in 26 KB of shared memory. The 7x7 instantiation
// is the design above, unchanged.
//
// Sums run in roi order and, for a cell, in bin order, so two calls on the
// same inputs give the same bits. They reassociate the plain version's
// tap-by-tap sum, so the result agrees with it to f32 rounding.
//
// C interface, loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; the
// caller passes PyTorch's current stream and allocates the gradient maps
// (uninitialised) and the int32 scratch of oadg_roi_align_bwd_scratch_ints.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace oadg_roi;

constexpr int kTile = 8;                // cells per tile side
constexpr int kHalf = kTile / 2;        // tile columns a thread owns; rows of a half
constexpr int kListWarps = 8;           // tiles per block of the list kernel
constexpr int kBucketThreads = 1024;    // rois a pass of the bucket kernel
constexpr unsigned kFull = 0xffffffffu;

// Per bin count: channels a block (two threads a channel: columns 0..3,
// 4..7), rois a group (one warp each), the dy bins a group stages (at least
// one roi's Out^2), and blocks an SM the registers are sized for.
template <int Out>
struct Cfg;
template <>
struct Cfg<7> {
  static constexpr int kSlice = 128;
  static constexpr int kGroup = 4;
  static constexpr int kStageBins = 64;
  static constexpr int kMinBlocks = 3;
};
template <>
struct Cfg<14> {
  static constexpr int kSlice = 32;
  static constexpr int kGroup = 2;
  static constexpr int kStageBins = 196;
  static constexpr int kMinBlocks = 8;
};

struct Pyramid {
  void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_y[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tile_base[kMaxLevels + 1];        // first tile of each level; [levels] = all
  float scale[kMaxLevels];
  int levels;
  int batch;
};

struct TileCoord {
  int level, image, ty, tx;
  int bucket;                           // level * batch + image
  int first;                            // first tile of the bucket
};

__device__ __forceinline__ TileCoord tile_coord(const Pyramid& p, int t) {
  int l = 0;
  while (l + 1 < p.levels && t >= p.tile_base[l + 1]) ++l;
  const int per_image = p.tiles_y[l] * p.tiles_x[l];
  const int rem = t - p.tile_base[l];
  TileCoord c;
  c.level = l;
  c.image = rem / per_image;
  c.ty = (rem % per_image) / p.tiles_x[l];
  c.tx = rem % p.tiles_x[l];
  c.bucket = l * p.batch + c.image;
  c.first = p.tile_base[l] + c.image * per_image;
  return c;
}

// ext[r] = {bucket (level * batch + image), or -1 if no tap is in range;
// first | last tile row << 16; first | last tile column << 16; r}.
template <int Out>
__global__ void roi_extent_kernel(Pyramid p, const float* __restrict__ rois,
                                  int num_rois, float finest_scale,
                                  int4* __restrict__ ext) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rois) return;
  const float* roi = rois + static_cast<size_t>(r) * 5;
  const int l = roi_level(roi, p.levels, finest_scale);
  const int b = roi_batch(roi, p.batch);
  int y0, y1, x0, x1;
  tap_extent<Out>(roi[2], roi[4], p.scale[l], p.h[l], &y0, &y1);
  tap_extent<Out>(roi[1], roi[3], p.scale[l], p.w[l], &x0, &x1);
  int4 e = make_int4(-1, 0, 0, r);
  if (y0 <= y1 && x0 <= x1) {
    e.x = l * p.batch + b;
    e.y = (y0 / kTile) | ((y1 / kTile) << 16);
    e.z = (x0 / kTile) | ((x1 / kTile) << 16);
  }
  ext[r] = e;
}

// One block a bucket: the extents of its rois, in increasing roi index, at
// blist + bucket * num_rois, and their count in bcount[bucket].
__global__ void __launch_bounds__(kBucketThreads)
bucket_kernel(const int4* __restrict__ ext, int num_rois, int4* __restrict__ blist,
              int* __restrict__ bcount) {
  __shared__ int s_warp[kBucketThreads / 32];
  const int bucket = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int4* out = blist + static_cast<size_t>(bucket) * num_rois;
  int n = 0;
  for (int r0 = 0; r0 < num_rois; r0 += kBucketThreads) {
    const int r = r0 + threadIdx.x;
    int4 e = make_int4(-1, 0, 0, 0);
    if (r < num_rois) e = ext[r];
    const bool hit = e.x == bucket;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll 8
    for (int w = 0; w < kBucketThreads / 32; ++w) {
      const int k = s_warp[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (hit) out[n + before + __popc(ballot & ((1u << lane) - 1u))] = e;
    n += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) bcount[bucket] = n;
}

// One warp a tile: lists the rois of its bucket whose tile rectangle holds
// the tile, in increasing roi index, and writes where the list starts and
// its length. Each tile of a bucket has room for all the bucket's rois; the
// buckets' regions follow one another in bucket order.
__global__ void __launch_bounds__(32 * kListWarps)
tile_lists_kernel(Pyramid p, const int4* __restrict__ blist,
                  const int* __restrict__ bcount, int num_rois,
                  int* __restrict__ starts, int* __restrict__ counts,
                  int* __restrict__ lists) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * kListWarps + threadIdx.x / 32;
  if (t >= p.tile_base[p.levels]) return;
  const TileCoord c = tile_coord(p, t);
  int base = 0;                         // region of the buckets before this one
  for (int k = lane; k < c.bucket; k += 32) {
    const int l = k / p.batch;
    base += p.tiles_y[l] * p.tiles_x[l] * bcount[k];
  }
  base = __reduce_add_sync(kFull, base);
  const int m = bcount[c.bucket];
  const int start = base + (t - c.first) * m;
  const int4* src = blist + static_cast<size_t>(c.bucket) * num_rois;
  int n = 0;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    bool hit = false;
    int r = 0;
    if (j < m) {
      const int4 e = __ldg(src + j);
      hit = c.ty >= (e.y & 0xffff) && c.ty <= (e.y >> 16) &&
            c.tx >= (e.z & 0xffff) && c.tx <= (e.z >> 16);
      r = e.w;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (hit) lists[start + n + __popc(ballot & ((1u << lane) - 1u))] = r;
    n += __popc(ballot);
  }
  if (lane == 0) {
    starts[t] = start;
    counts[t] = n;
  }
}

// One roi of a group: its samples, its weights on the tile's columns (Bx)
// and rows (Ay, times 1/4), which bins touch each, and the dy bins it
// stages: rows oy0.., columns ox0.., nx wide, count of them, each one's
// offset in the roi's (Out, Out) slab, and its first slot in the buffer.
template <int Out>
struct RoiTables {
  Samples<Out> s;
  alignas(16) float bx_t[Out][kTile];   // Bx transposed: bin ox's weight on column x
  alignas(16) float ay_t[Out][kTile];   // Ay transposed: bin oy's weight on row y
  unsigned xunion;                      // bins that reach any column, any row
  unsigned yunion;
  unsigned xhalf[2];                    // bins that reach columns 0..3, 4..7
  unsigned yhalf[2];                    // bins that reach rows 0..3, 4..7
  unsigned char bin_of[Out * Out];
  int roi, oy0, ox0, nx, ny, count, first_slot;
};

// One warp: the roi's samples (lanes 0..27 at 7x7, two a lane at 14x14),
// then lanes 0..7 the tile's columns and lanes 8..15 its rows, then the bins
// that reach the tile.
template <int Out>
__device__ __forceinline__ void build_tables(const float* roi, float scale, int H,
                                             int W, int y_base, int x_base,
                                             int lane, RoiTables<Out>* t) {
  constexpr int kS = Grid<Out>::kS;
  roi_samples<Out>(roi, scale, H, W, lane, 32, &t->s);
  __syncwarp();
  const int axis = lane / kTile;        // 0: columns, 1: rows
  unsigned m = 0;
  if (lane < 2 * kTile) {
    float w[Out];
#pragma unroll
    for (int o = 0; o < Out; ++o) w[o] = 0.f;
    const int cell = (axis ? y_base : x_base) + lane % kTile;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (!t->s.ok[axis][i]) continue;
      if (t->s.lo[axis][i] == cell) {
        w[i / kSr] += 1.f - t->s.frac[axis][i];
        m |= 1u << (i / kSr);
      }
      if (t->s.hi[axis][i] == cell) {
        w[i / kSr] += t->s.frac[axis][i];
        m |= 1u << (i / kSr);
      }
    }
    const float gain = axis ? 1.f / (kSr * kSr) : 1.f;
#pragma unroll
    for (int o = 0; o < Out; ++o) (axis ? t->ay_t : t->bx_t)[o][lane % kTile] = w[o] * gain;
  }
  unsigned half[4];                     // columns 0..3, 4..7, rows 0..3, 4..7
#pragma unroll
  for (int q = 0; q < 4; ++q) half[q] = __reduce_or_sync(kFull, lane / 4 == q ? m : 0u);
  const unsigned ux = half[0] | half[1];
  const unsigned uy = half[2] | half[3];
  int oy0 = 0, ox0 = 0, nx = 0, ny = 0;
  if (ux && uy) {
    oy0 = __ffs(uy) - 1;
    ox0 = __ffs(ux) - 1;
    ny = 32 - __clz(uy) - oy0;
    nx = 32 - __clz(ux) - ox0;
  }
  for (int b = lane; b < nx * ny; b += 32) {
    t->bin_of[b] = static_cast<unsigned char>((oy0 + b / nx) * Out + ox0 + b % nx);
  }
  if (lane == 0) {
    t->xunion = ux;
    t->yunion = uy;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      t->xhalf[q] = half[q];
      t->yhalf[q] = half[2 + q];
    }
    t->oy0 = oy0;
    t->ox0 = ox0;
    t->nx = nx;
    t->ny = ny;
    t->count = nx * ny;
  }
}

// Adds bin rows oy0 + i .. oy0 + i + N - 1 of roi `t` to this thread's
// cells: for each, E[x] = sum_ox D[oy][ox] Bx[x][ox] over the bins ox of
// `xm` (those that reach these columns), then G[y][x] += Ay[y][oy] E[x] on
// each half of the rows that oy reaches. N rows at once give independent
// sums. The tables are read as float4; a weight is 0 where a bin misses a
// row or column, and the branches are uniform in a warp.
template <int N, int Out>
__device__ __forceinline__ void accumulate_bin_rows(const RoiTables<Out>& t, const float* d,
                                                    int i, unsigned xm, int x_off,
                                                    float (&acc)[kTile][kHalf]) {
  constexpr int kSlice = Cfg<Out>::kSlice;
  float ex[N][kHalf];
  int row[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    row[n] = (t.first_slot + (i + n) * t.nx - t.ox0) * (kSlice + 1);  // + ox: its slot
#pragma unroll
    for (int x = 0; x < kHalf; ++x) ex[n][x] = 0.f;
  }
  for (unsigned m = xm; m; m &= m - 1) {
    const int ox = __ffs(m) - 1;
    const float4 b = reinterpret_cast<const float4*>(t.bx_t[ox])[x_off / kHalf];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float v = d[row[n] + ox * (kSlice + 1)];
      ex[n][0] = fmaf(b.x, v, ex[n][0]);
      ex[n][1] = fmaf(b.y, v, ex[n][1]);
      ex[n][2] = fmaf(b.z, v, ex[n][2]);
      ex[n][3] = fmaf(b.w, v, ex[n][3]);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int oy = t.oy0 + i + n;
    const float4* ay = reinterpret_cast<const float4*>(t.ay_t[oy]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(t.yhalf[q] >> oy & 1u)) continue;
      const float4 a = ay[q];
      const float w[kHalf] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int y = 0; y < kHalf; ++y) {
#pragma unroll
        for (int x = 0; x < kHalf; ++x) {
          acc[kHalf * q + y][x] = fmaf(w[y], ex[n][x], acc[kHalf * q + y][x]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block per (tile, kSlice channels: 128 at 7x7, 32 at 14x14); thread t
// owns channel c0 + t % kSlice of the tile's columns 4 * (t / kSlice) .. + 3,
// 32 cells in registers. Rois of the tile's list go in groups of up to
// kGroup (warp g builds roi g's tables) whose dy bins fit the staging buffer
// together: one round of global loads and three barriers a group.
template <typename T, int Out>
__global__ void __launch_bounds__(2 * Cfg<Out>::kSlice, Cfg<Out>::kMinBlocks)
roi_grad_tile_kernel(Pyramid p, int channels, const float* __restrict__ rois,
                     const float* __restrict__ dy, const int* __restrict__ starts,
                     const int* __restrict__ counts, const int* __restrict__ lists) {
  constexpr int kSlice = Cfg<Out>::kSlice;
  constexpr int kThreads = 2 * kSlice;
  constexpr int kGroup = Cfg<Out>::kGroup;
  constexpr int kStageBins = Cfg<Out>::kStageBins;
  constexpr int kBins = Out * Out;
  static_assert(kGroup <= kThreads / 32, "a warp a roi of the group");
  static_assert(kStageBins >= kBins, "a group takes at least one roi");
  __shared__ RoiTables<Out> tb[kGroup];
  __shared__ float s_dy[kStageBins][kSlice + 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = threadIdx.x % kSlice;
  const int x_off = threadIdx.x / kSlice * kHalf;
  const TileCoord tc = tile_coord(p, blockIdx.x);
  const int H = p.h[tc.level];
  const int W = p.w[tc.level];
  const float scale = p.scale[tc.level];
  const int y_base = tc.ty * kTile;
  const int x_base = tc.tx * kTile;
  const int c0 = blockIdx.y * kSlice;
  const int nc = min(kSlice, channels - c0);

  float acc[kTile][kHalf];
#pragma unroll
  for (int y = 0; y < kTile; ++y) {
#pragma unroll
    for (int x = 0; x < kHalf; ++x) acc[y][x] = 0.f;
  }

  const int begin = starts[blockIdx.x];
  const int end = begin + counts[blockIdx.x];
  for (int k = begin; k < end;) {
    if (warp < kGroup && k + warp < end) {
      const int r = lists[k + warp];
      build_tables<Out>(rois + static_cast<size_t>(r) * 5, scale, H, W, y_base, x_base,
                        lane, &tb[warp]);
      if (lane == 0) tb[warp].roi = r;
    }
    __syncthreads();

    // The group: the next rois whose bins fit the buffer together.
    int taken = 0, slots = 0;
    for (int g = 0; g < kGroup && k + g < end; ++g) {
      const int n = tb[g].count;
      if (slots + n > kStageBins) break;
      if (threadIdx.x == 0) tb[g].first_slot = slots;
      slots += n;
      ++taken;
    }

    // Stage each roi's bins, s_dy[slot][channel]: element e of a roi is
    // bin e % 2^sh of channel e >> sh (2^sh >= its bin count), so that
    // neighbouring threads read neighbouring bins of a channel; eight loads
    // in flight a thread.
    int first = 0;
    for (int g = 0; g < taken; ++g) {
      const RoiTables<Out>& t = tb[g];
      if (t.count) {
        const int sh = 32 - __clz(t.count - 1);
        const int total = nc << sh;
        const float* src = dy + (static_cast<size_t>(t.roi) * channels + c0) * kBins;
        for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads;
            const int b = e & ((1 << sh) - 1);
            if (e < total && b < t.count) v[u] = __ldg(src + (e >> sh) * kBins + t.bin_of[b]);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads;
            const int b = e & ((1 << sh) - 1);
            if (e < total && b < t.count) s_dy[first + b][e >> sh] = v[u];
          }
        }
      }
      first += t.count;
    }
    __syncthreads();

    // G = Ay^T (D Bx) on this thread's columns, roi by roi: for each bin
    // row oy, E[x] = sum_ox D[oy][ox] Bx[x][ox] over the bins ox that reach
    // these columns, then G[y][x] += Ay[y][oy] E[x] on each half of the rows
    // that oy reaches. The tables are read as float4; a weight is 0 where a
    // bin misses a row or column, and the branches are uniform in a warp.
    for (int g = 0; g < taken; ++g) {
      const RoiTables<Out>& t = tb[g];
      const unsigned xm = t.xhalf[x_off / kHalf];
      if (!t.count || !xm) continue;
      int i = 0;
      for (; i + 1 < t.ny; i += 2) accumulate_bin_rows<2, Out>(t, s_dy[0] + c, i, xm, x_off, acc);
      if (i < t.ny) accumulate_bin_rows<1, Out>(t, s_dy[0] + c, i, xm, x_off, acc);
    }
    __syncthreads();
    k += taken;
  }

  // Every cell of the tile, zeros included, written once.
  if (c >= nc) return;
  T* out = static_cast<T*>(p.ptr[tc.level]) + c0 + c;
#pragma unroll
  for (int y = 0; y < kTile; ++y) {
    if (y_base + y >= H) continue;
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      const int xx = x_base + x_off + x;
      if (xx >= W) continue;
      store(out + ((static_cast<size_t>(tc.image) * H + y_base + y) * W + xx) * channels,
            acc[y][x]);
    }
  }
}

bool make_pyramid(void* const* grads, const int* heights, const int* widths,
                  const float* scales, int num_levels, int batch, Pyramid* p,
                  long long* most_tiles) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1) return false;
  *p = Pyramid{};
  p->levels = num_levels;
  p->batch = batch;
  long long total = 0;
  *most_tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return false;
    p->ptr[l] = grads ? grads[l] : nullptr;
    p->h[l] = heights[l];
    p->w[l] = widths[l];
    p->scale[l] = scales ? scales[l] : 0.f;
    p->tiles_y[l] = (heights[l] + kTile - 1) / kTile;
    p->tiles_x[l] = (widths[l] + kTile - 1) / kTile;
    p->tile_base[l] = static_cast<int>(total);
    const long long per_image = static_cast<long long>(p->tiles_y[l]) * p->tiles_x[l];
    *most_tiles = per_image > *most_tiles ? per_image : *most_tiles;
    total += per_image * batch;
    if (total >= (1ll << 31) || p->tiles_y[l] > 0xffff || p->tiles_x[l] > 0xffff) {
      return false;
    }
  }
  p->tile_base[num_levels] = static_cast<int>(total);
  return true;
}

int buckets(const Pyramid& p) { return p.levels * p.batch; }

template <int Out>
void launch(const Pyramid& p, int dtype, int channels, const float* rois, int num_rois,
            float finest_scale, const float* dy, int* scratch, cudaStream_t s) {
  const int tiles = p.tile_base[p.levels];
  const int nb = buckets(p);
  int4* ext = reinterpret_cast<int4*>(scratch);
  int4* blist = ext + num_rois;
  int* bcount = reinterpret_cast<int*>(blist + static_cast<size_t>(nb) * num_rois);
  int* starts = bcount + nb;
  int* counts = starts + tiles;
  int* lists = counts + tiles;
  roi_extent_kernel<Out><<<(num_rois + 255) / 256, 256, 0, s>>>(p, rois, num_rois,
                                                                finest_scale, ext);
  bucket_kernel<<<nb, kBucketThreads, 0, s>>>(ext, num_rois, blist, bcount);
  tile_lists_kernel<<<(tiles + kListWarps - 1) / kListWarps, 32 * kListWarps, 0, s>>>(
      p, blist, bcount, num_rois, starts, counts, lists);
  constexpr int kSlice = Cfg<Out>::kSlice;
  const dim3 grid(tiles, (channels + kSlice - 1) / kSlice);
  if (dtype == 0) {
    roi_grad_tile_kernel<float, Out><<<grid, 2 * kSlice, 0, s>>>(p, channels, rois, dy,
                                                                 starts, counts, lists);
  } else {
    roi_grad_tile_kernel<__nv_bfloat16, Out><<<grid, 2 * kSlice, 0, s>>>(
        p, channels, rois, dy, starts, counts, lists);
  }
}

// int32 scratch: roi extents (4 a roi), the buckets' lists of extents (4 a
// roi each), bucket counts, tile starts and counts, and the tile lists: at
// most every roi of a bucket in every tile of the bucket, so at most every
// roi in every tile of the largest level. -1 where the lists would not fit
// int32 offsets.
long long scratch_ints(const Pyramid& p, long long most_tiles, int num_rois) {
  const long long tiles = p.tile_base[p.levels];
  const long long lists = most_tiles * num_rois;
  if (lists >= (1ll << 31)) return -1;
  return 4ll * num_rois * (1 + buckets(p)) + buckets(p) + 2 * tiles + lists;
}

}  // namespace

// The int32 scratch oadg_roi_align_bwd needs for these maps and num_rois
// rois; -1 if the shapes are refused.
extern "C" long long oadg_roi_align_bwd_scratch_ints(const int* heights,
                                                     const int* widths,
                                                     int num_levels, int batch,
                                                     int num_rois) {
  Pyramid p;
  long long most = 0;
  if (num_rois < 0 ||
      !make_pyramid(nullptr, heights, widths, nullptr, num_levels, batch, &p, &most)) {
    return -1;
  }
  return scratch_ints(p, most, num_rois);
}

// grads: num_levels device pointers to channels-last (B, H_l, W_l, C) maps
// of the features' dtype (0 = float32, 1 = bfloat16), written whole;
// heights/widths/scales: host arrays of num_levels entries; out_size: bins
// a side, 7 or 14; rois: device (num_rois, 5) float32 [batch, x1, y1, x2,
// y2]; dy: device (num_rois, C, out_size, out_size) float32, contiguous;
// scratch: device int32, 16-byte aligned, of scratch_len >=
// oadg_roi_align_bwd_scratch_ints(...) entries. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int oadg_roi_align_bwd(void* const* grads, const int* heights,
                                  const int* widths, const float* scales,
                                  int num_levels, int batch, int channels,
                                  int dtype, int out_size, const float* rois,
                                  int num_rois, float finest_scale, const float* dy,
                                  int* scratch, long long scratch_len,
                                  void* stream) {
  Pyramid p;
  long long most = 0;
  if (channels < 1 || num_rois < 1 || (dtype != 0 && dtype != 1) ||
      (out_size != 7 && out_size != 14) ||
      !make_pyramid(grads, heights, widths, scales, num_levels, batch, &p, &most) ||
      scratch_ints(p, most, num_rois) < 0 || scratch_len < scratch_ints(p, most, num_rois)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_size == 7) {
    launch<7>(p, dtype, channels, rois, num_rois, finest_scale, dy, scratch, s);
  } else {
    launch<14>(p, dtype, channels, rois, num_rois, finest_scale, dy, scratch, s);
  }
  return static_cast<int>(cudaGetLastError());
}
