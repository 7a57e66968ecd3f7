// Row-shift warps of OA-Mix for Hopper (sm_90a): every output pixel is a
// linear interpolation of two neighbours along one axis of a channels-last
// (H, W, C) image, reads outside the image giving 0.
//
//   B4  oadg_shear_rows:           out[y, x] = lerp(img, key, shift[key], frac[key])
//   B5  oadg_piecewise_shift_rows: out[y, x] = lerp(img, key, shifts[key, bid[y, x]]),
//                                  the source pixel where bid[y, x] >= G
//   B7  oadg_merged_shift_rows:    out[y, x] = lerp(img, key, shift of cid[y, x]), where
//                                  cid = slot * G + box: p_bb[key, cid] if the slot
//                                  drew a per-box op, p_sl[key, slot] if it drew a
//                                  background op, else 0; cid >= S * G (the sentinel)
//                                  takes the last slot's background shift; no clamp
//
// With axis = 1 the key is the row y and the shift runs along x (a row
// pass); with axis = 0 the key is the column x and the shift runs along y
// (a column pass), so the JAX package's transposes around its y passes
// (oadg_tpu/ops/pallas_warp.py:347-363, 380-383) are not needed.
//
// Replaces, in oadg_tpu/ops/pallas_warp.py: B4, shear_rows_v4 (_shear_kernel_v4)
// and the same contract in three other TPU layouts, shear_rows_v3,
// shear_rows and shear_rows_block; B5, piecewise_shift_rows
// (_pw_shift_kernel_v4 and the padded _pw_shift_kernel); B7, merged_shift_rows
// (_merged_shift_kernel with merged_prep and _fs_tables). The TPU kernels
// realign rows with lane rolls, 8-row residual tables and per-block box
// and slot presence masks because a TPU cannot gather; a GPU thread reads
// its two taps directly, so none of that is carried over. B7 holds to the
// JAX function's per-pixel contract (its CPU branch): the TPU kernel's
// skipping of the background shift in 8-row blocks of sentinel pixels only
// is a property of its presence masks, not of the function.
//
// What bounds it on the H100: bytes. Per pixel the function reads C source
// values (plus one int8 box id for B5) and writes C float32 values; the
// arithmetic is three roundings per value. The design reads each source
// line once per warp where the shift is constant along the warp's 32
// pixels (always for B4, and inside a box's region for B5), so the two taps
// of neighbouring threads fall in the same cache lines; B5 stages the
// block's slice of the (keys, G) shift table in shared memory, split into
// integer shift and fraction, so a pixel's lookup is one shared-memory read.
// B7 stages the same table with the slots' flags already resolved: one
// column per composite id and one more for the sentinel, (keys, S * G + 1),
// so its per-pixel work is B5's.
// All entry points share lerp_pixel, the lerp-and-border function, so they
// round alike: fma(a, 1 - f, b * f), the rounding XLA gives the JAX
// package's a * (1 - f) + b * f; the plain PyTorch versions emulate the
// fused multiply-add in float64.
//
// Grid: 32 x 8 threads per block, one thread per pixel (all C channels).
// Inputs uint8 or float32 (dtype code 0 / 1); output float32. C interface,
// loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; launched on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxChannels = 4;
constexpr int kMaxBoxes = 127;
constexpr int kMaxSlots = 32;

__device__ __forceinline__ float load(const uint8_t* p, long long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }

struct Geometry {
  int h, w, c, axis;
};

// The lerp of pixel (y, x) shifted by (s, f) along the pass axis, written
// to out[(y * w + x) * c + ch] for every channel.
template <typename T>
__device__ __forceinline__ void lerp_pixel(const T* __restrict__ img,
                                           float* __restrict__ out,
                                           const Geometry& g, int y, int x,
                                           int s, float f) {
  const int pos = g.axis == 1 ? x : y;
  const int len = g.axis == 1 ? g.w : g.h;
  const long long step = g.axis == 1 ? g.c : static_cast<long long>(g.w) * g.c;
  const long long line = g.axis == 1 ? static_cast<long long>(y) * g.w * g.c
                                     : static_cast<long long>(x) * g.c;
  const int q = pos + s;
  const bool in_a = q >= 0 && q < len;
  const bool in_b = q + 1 >= 0 && q + 1 < len;
  const float wa = __fsub_rn(1.f, f);
  const long long o = (static_cast<long long>(y) * g.w + x) * g.c;
  for (int ch = 0; ch < g.c; ++ch) {
    const float a = in_a ? load(img, line + q * step + ch) : 0.f;
    const float b = in_b ? load(img, line + (q + 1) * step + ch) : 0.f;
    out[o + ch] = __fmaf_rn(a, wa, __fmul_rn(b, f));
  }
}

template <typename T>
__global__ void shear_rows_kernel(const T* __restrict__ img,
                                  const int* __restrict__ shifts,
                                  const float* __restrict__ fracs, int max_shift,
                                  Geometry g, float* __restrict__ out) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= g.w || y >= g.h) return;
  const int key = g.axis == 1 ? y : x;
  const int s = min(max(shifts[key], -max_shift), max_shift);
  lerp_pixel(img, out, g, y, x, s, fracs[key]);
}

template <typename T>
__global__ void piecewise_shift_kernel(const T* __restrict__ img,
                                       const int8_t* __restrict__ bid,
                                       const float* __restrict__ shifts, int nb,
                                       float max_shift, Geometry g,
                                       float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  // the block's keys: kTileY rows (axis 1) or kTileX columns (axis 0)
  const int nkeys = g.axis == 1 ? kTileY : kTileX;
  const int key0 = g.axis == 1 ? blockIdx.y * kTileY : blockIdx.x * kTileX;
  const int nkeys_all = g.axis == 1 ? g.h : g.w;
  int* s_int = reinterpret_cast<int*>(smem);                 // (nkeys, nb)
  float* s_frac = reinterpret_cast<float*>(s_int + nkeys * nb);
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  for (int i = tid; i < nkeys * nb; i += kTileX * kTileY) {
    const int key = key0 + i / nb;
    float p = key < nkeys_all ? shifts[static_cast<long long>(key) * nb + i % nb] : 0.f;
    p = fminf(fmaxf(p, -max_shift), max_shift);
    const float fl = floorf(p);
    s_int[i] = static_cast<int>(fl);
    s_frac[i] = __fsub_rn(p, fl);
  }
  __syncthreads();
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= g.w || y >= g.h) return;
  const int b = bid[static_cast<long long>(y) * g.w + x];
  if (b < 0 || b >= nb) {                                    // identity sentinel
    const long long o = (static_cast<long long>(y) * g.w + x) * g.c;
    for (int ch = 0; ch < g.c; ++ch) out[o + ch] = load(img, o + ch);
    return;
  }
  const int k = (g.axis == 1 ? threadIdx.y : threadIdx.x) * nb + b;
  lerp_pixel(img, out, g, y, x, s_int[k], s_frac[k]);
}

// B7. The block's table has a column for every composite id k = slot * G +
// box and a last one for the sentinel: the shift p_bb[key, k] where the
// slot's bit is set in bb_mask, else p_sl[key, slot] where it is set in
// bg_mask, else 0; the sentinel column follows the last slot's bg flag.
template <typename T>
__global__ void merged_shift_kernel(const T* __restrict__ img,
                                    const int8_t* __restrict__ cid,
                                    const float* __restrict__ p_bb,
                                    const float* __restrict__ p_sl, int sg, int ns,
                                    unsigned bb_mask, unsigned bg_mask, Geometry g,
                                    float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int nkeys = g.axis == 1 ? kTileY : kTileX;
  const int key0 = g.axis == 1 ? blockIdx.y * kTileY : blockIdx.x * kTileX;
  const int nkeys_all = g.axis == 1 ? g.h : g.w;
  const int ncol = sg + 1;
  const int per_slot = sg / ns;
  int* s_int = reinterpret_cast<int*>(smem);                 // (nkeys, ncol)
  float* s_frac = reinterpret_cast<float*>(s_int + nkeys * ncol);
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  for (int i = tid; i < nkeys * ncol; i += kTileX * kTileY) {
    const int key = key0 + i / ncol;
    const int k = i % ncol;
    const int slot = k < sg ? k / per_slot : ns - 1;
    float p = 0.f;
    if (key < nkeys_all) {
      if (k < sg && ((bb_mask >> slot) & 1u)) {
        p = p_bb[static_cast<long long>(key) * sg + k];
      } else if ((bg_mask >> slot) & 1u) {
        p = p_sl[static_cast<long long>(key) * ns + slot];
      }
    }
    const float fl = floorf(p);
    // the integer part is bounded only so that pos + s cannot overflow; a
    // shift beyond the image reads zeros either way
    s_int[i] = static_cast<int>(fminf(fmaxf(fl, -1073741824.f), 1073741824.f));
    s_frac[i] = __fsub_rn(p, fl);
  }
  __syncthreads();
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= g.w || y >= g.h) return;
  int b = cid[static_cast<long long>(y) * g.w + x];
  b = b < 0 ? 0 : (b > sg ? sg : b);
  const int k = (g.axis == 1 ? threadIdx.y : threadIdx.x) * ncol + b;
  lerp_pixel(img, out, g, y, x, s_int[k], s_frac[k]);
}

bool valid_geometry(const Geometry& g) {
  return g.h > 0 && g.w > 0 && g.c >= 1 && g.c <= kMaxChannels &&
         (g.axis == 0 || g.axis == 1);
}

}  // namespace

extern "C" int oadg_shear_rows(const void* img, int dtype, int h, int w, int c,
                               int axis, const void* shifts, const void* fracs,
                               int max_shift, void* out, void* stream) {
  const Geometry g{h, w, c, axis};
  if (!valid_geometry(g) || (dtype != 0 && dtype != 1) || max_shift < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(shifts);
  const float* f = static_cast<const float*>(fracs);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    shear_rows_kernel<<<grid, block, 0, st>>>(static_cast<const uint8_t*>(img), s, f,
                                              max_shift, g, o);
  } else {
    shear_rows_kernel<<<grid, block, 0, st>>>(static_cast<const float*>(img), s, f,
                                              max_shift, g, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int oadg_piecewise_shift_rows(const void* img, int dtype, int h, int w,
                                         int c, int axis, const void* bid,
                                         const void* shifts, int nb,
                                         float max_shift, void* out, void* stream) {
  const Geometry g{h, w, c, axis};
  if (!valid_geometry(g) || (dtype != 0 && dtype != 1) || nb < 1 ||
      nb > kMaxBoxes || !(max_shift >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const int nkeys = axis == 1 ? kTileY : kTileX;
  const size_t smem = static_cast<size_t>(nkeys) * nb * (sizeof(int) + sizeof(float));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* b = static_cast<const int8_t*>(bid);
  const float* p = static_cast<const float*>(shifts);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    piecewise_shift_kernel<<<grid, block, smem, st>>>(
        static_cast<const uint8_t*>(img), b, p, nb, max_shift, g, o);
  } else {
    piecewise_shift_kernel<<<grid, block, smem, st>>>(
        static_cast<const float*>(img), b, p, nb, max_shift, g, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int oadg_merged_shift_rows(const void* img, int dtype, int h, int w, int c,
                                      int axis, const void* cid, const void* p_bb,
                                      const void* p_sl, int sg, int ns,
                                      unsigned bb_mask, unsigned bg_mask, void* out,
                                      void* stream) {
  const Geometry g{h, w, c, axis};
  if (!valid_geometry(g) || (dtype != 0 && dtype != 1) || ns < 1 || ns > kMaxSlots ||
      sg < 1 || sg > kMaxBoxes || sg % ns != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const int nkeys = axis == 1 ? kTileY : kTileX;
  const size_t smem =
      static_cast<size_t>(nkeys) * (sg + 1) * (sizeof(int) + sizeof(float));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ids = static_cast<const int8_t*>(cid);
  const float* pb = static_cast<const float*>(p_bb);
  const float* ps = static_cast<const float*>(p_sl);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    merged_shift_kernel<<<grid, block, smem, st>>>(
        static_cast<const uint8_t*>(img), ids, pb, ps, sg, ns, bb_mask, bg_mask, g, o);
  } else {
    merged_shift_kernel<<<grid, block, smem, st>>>(
        static_cast<const float*>(img), ids, pb, ps, sg, ns, bb_mask, bg_mask, g, o);
  }
  return static_cast<int>(cudaGetLastError());
}
