// Row-shift warps of OA-Mix for Hopper (sm_90a): every output pixel is a
// linear interpolation of two neighbours along one axis of a channels-last
// (H, W, C) image, reads outside the image giving 0.
//
//   B4  oadg_shear_rows:           out[y, x] = lerp(img, key, shift[key], frac[key])
//   B5  oadg_piecewise_shift_rows: out[y, x] = lerp(img, key, shifts[key, bid[y, x]]),
//                                  shifts clamped to +-max_shift; the source
//                                  pixel where bid[y, x] >= G
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
// its taps directly, so none of that is carried over. B7 holds to the
// JAX function's per-pixel contract (its CPU branch): the TPU kernel's
// skipping of the background shift in 8-row blocks of sentinel pixels only
// is a property of its presence masks, not of the function.
//
// What bounds all three on the H100: bytes. Per pixel the function reads C
// source values and one int8 id (B5, B7) and writes C float32 values; the
// arithmetic is three roundings per value. All entry points round alike,
// fma(a, 1 - f, b * f) with 1 - f and b * f rounded first: the rounding XLA
// gives the JAX package's a * (1 - f) + b * f; the plain PyTorch versions
// emulate the fused multiply-add in float64.
//
// B5 and B7, the fast route (fast_shift_kernel). Taken for the shapes
// OA-Mix gives them (B5: uint8 or float32 with C = 3; B7: float32 with
// C = 4) when W is a multiple of 4 and the pointers are aligned; templated
// on the element type, the channel count and the axis, so every loop
// unrolls and every address is a compile-time pattern.
//   - A thread owns 4 consecutive pixels of a row (memory runs along x).
//     It reads their 4 ids as one 32-bit word and stores its 4 * C floats
//     as C 16-byte stores; a warp writes 128 pixels, 1.5 or 2 KB, in one
//     piece.
//   - Row pass, the 4 ids equal (the inside of a box and all of the
//     background: nearly every group of 4): one shift for the group, so its
//     8 taps are 5 consecutive source pixels, each read once. float32
//     C = 4: 5 16-byte loads. float32 C = 3: 15 4-byte loads through the
//     read-only path (the run starts at any 4-byte offset). uint8 C = 3: the
//     15 bytes start at any byte offset; the 5 aligned 32-bit words that
//     cover them are loaded and realigned with 4 funnel shifts.
//   - Row pass, ids differ (a box edge runs through the group): 4 lookups
//     and 2 taps a pixel; the group still stores as one run.
//   - Column pass (the key is the column, so neighbouring pixels have
//     different shifts and nothing is shared along x). OA-Mix's tables move
//     by less than a row from one column to the next (|slope| <= 0.58), so
//     the taps of neighbouring columns form runs of 2 or more pixels on
//     one source row before they step to the next. C = 3: 4 pixels a
//     thread as above, 2 taps of 3 narrow loads a pixel. C = 4 (16-byte
//     pixels): ONE pixel a thread, each tap one 16-byte load and the result
//     one 16-byte store, so the 32 threads of a warp read 32 neighbouring
//     columns and the runs fill whole 32-byte sectors within one request;
//     with 4 pixels a thread one load instruction of a warp touched 32
//     half-used sectors 64 bytes apart, and the pass took 0.040 ms against
//     0.027 ms this way (NVIDIA H100 80GB HBM3, 700 W; PERF.md). A block
//     covers 8 rows, so the sector halves that a row's taps leave over are
//     the next row's taps, and device memory sees each line about once.
//   - The shift of (key, id) is read straight from the caller's tables
//     through the read-only path: the tables are 64-70 KB, a warp of a row
//     pass touches one or two entries, and no block waits at a barrier
//     for a staged table before its first image load. B7 with one slot
//     (the only case OA-Mix calls) is its own instantiation with the slot
//     logic folded away.
//   - 32 x 8 threads a block; a 1024 x 2048 image is 2048 blocks (8192 on
//     the one-pixel column pass) on 132 SMs. The launch bounds name one
//     block an SM as the least, which leaves the register count to the
//     compiler: it takes 54 for B7's row pass and keeps a thread's 5 loads
//     in flight together (0.028 ms); with 40 registers the pass took 0.031
//     ms and capped at 32, for 8 blocks an SM, 0.035 ms. Streaming stores
//     and 32 x 4 blocks changed nothing (same card, PERF.md).
// Everything else (C = 1, 2, other type and channel pairs, W not a multiple
// of 4, unaligned views) takes the generic route (generic_shift_kernel): one
// thread per pixel with run-time C and axis, the same lookups and the same
// lerp. Both routes give the same bits; the entry points report the route.
//
// B4 (shear_rows_kernel) is one thread per pixel with run-time C and axis.
//
// Inputs uint8 or float32 (dtype code 0 / 1); output float32. C interface,
// loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; launched on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kQuad = 4;
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

// One pixel's shift: integer part, fraction, and whether the pixel keeps
// its source value instead (B5's sentinel).
struct Shift {
  int s;
  float f;
  bool keep;
};

// B5: the clamped shift of the pixel's box; ids outside [0, nb) keep the
// source pixel.
struct PiecewiseLookup {
  const float* shifts;                // (keys, nb)
  int nb;
  float max_shift;

  __device__ __forceinline__ Shift operator()(int key, int id) const {
    if (id < 0 || id >= nb) return Shift{0, 0.f, true};
    float p = __ldg(shifts + static_cast<long long>(key) * nb + id);
    p = fminf(fmaxf(p, -max_shift), max_shift);
    const float fl = floorf(p);
    return Shift{static_cast<int>(fl), __fsub_rn(p, fl), false};
  }
};

// B7: the shift of composite id k = slot * G + box: p_bb[key, k] where the
// slot's bit is set in bb_mask, else p_sl[key, slot] where it is set in
// bg_mask, else 0; ids are clamped to [0, sg], and sg, the sentinel, is
// never a per-box id and follows the last slot's bg flag. With ONE_SLOT the
// slot is 0 and its two flags are bit 0 of the masks.
template <bool ONE_SLOT>
struct MergedLookup {
  const float* p_bb;                  // (keys, sg)
  const float* p_sl;                  // (keys, ns)
  int sg, ns, per_slot;
  unsigned bb_mask, bg_mask;

  __device__ __forceinline__ Shift operator()(int key, int id) const {
    id = id < 0 ? 0 : (id > sg ? sg : id);
    float p = 0.f;
    if (ONE_SLOT) {
      if (id < sg && (bb_mask & 1u)) {
        p = __ldg(p_bb + static_cast<long long>(key) * sg + id);
      } else if (bg_mask & 1u) {
        p = __ldg(p_sl + key);
      }
    } else {
      const int slot = id < sg ? id / per_slot : ns - 1;
      if (id < sg && ((bb_mask >> slot) & 1u)) {
        p = __ldg(p_bb + static_cast<long long>(key) * sg + id);
      } else if ((bg_mask >> slot) & 1u) {
        p = __ldg(p_sl + static_cast<long long>(key) * ns + slot);
      }
    }
    const float fl = floorf(p);
    // the integer part is bounded only so that pos + s cannot overflow; a
    // shift beyond the image reads zeros either way
    return Shift{static_cast<int>(fminf(fmaxf(fl, -1073741824.f), 1073741824.f)),
                 __fsub_rn(p, fl), false};
  }
};

// The C values of the pixel whose first value is img[i], as float32.
template <typename T, int C>
__device__ __forceinline__ void load_pixel(const T* __restrict__ img, long long i,
                                           float* v) {
  if constexpr (sizeof(T) == 4 && C == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(img + i));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = static_cast<float>(__ldg(img + i + ch));
  }
}

// One pixel of the fast route with its own shift: two taps along AXIS.
template <typename T, int C, int AXIS>
__device__ __forceinline__ void lerp_one(const T* __restrict__ img, int h, int w, int y,
                                         int x, const Shift& sh, float* o) {
  if (sh.keep) {
    load_pixel<T, C>(img, (static_cast<long long>(y) * w + x) * C, o);
    return;
  }
  const int pos = AXIS == 1 ? x : y;
  const int len = AXIS == 1 ? w : h;
  const long long step = AXIS == 1 ? C : static_cast<long long>(w) * C;
  const long long line = AXIS == 1 ? static_cast<long long>(y) * w * C
                                   : static_cast<long long>(x) * C;
  const int q = pos + sh.s;
  float a[C], b[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) a[ch] = b[ch] = 0.f;
  if (q >= 0 && q < len) load_pixel<T, C>(img, line + q * step, a);
  if (q + 1 >= 0 && q + 1 < len) load_pixel<T, C>(img, line + (q + 1) * step, b);
  const float wa = __fsub_rn(1.f, sh.f);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) o[ch] = __fmaf_rn(a[ch], wa, __fmul_rn(b[ch], sh.f));
}

// Pixels q0 .. q0 + n - 1 (n = 4 or 5) of the row whose first value is
// img[row], as float32 in p[5 * C]; pixels outside [0, w) give 0 and the
// fifth is 0 when n is 4.
template <int C>
__device__ __forceinline__ void load_run(const float* __restrict__ img, long long row,
                                         int w, int q0, int n, long long, float* p) {
#pragma unroll
  for (int j = 0; j <= kQuad; ++j) {
    const int q = q0 + j;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) p[j * C + ch] = 0.f;
    if (q >= 0 && q < w && j < n) load_pixel<float, C>(img, row + static_cast<long long>(q) * C,
                                                        p + j * C);
  }
}

// uint8, C = 3: the run is 15 bytes from any byte offset. The five aligned
// 32-bit words that cover them are loaded (words outside the image's
// `total` bytes, a multiple of 4, are not touched) and shifted into place;
// values of pixels outside the row are then set to 0.
template <int C>
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ img, long long row,
                                         int w, int q0, int n, long long total, float* p) {
  static_assert(C == 3, "the byte route is written for 3 channels");
  const long long b0 = row + 3LL * q0;            // may be negative
  const long long w0 = b0 >> 2;                   // floor(b0 / 4)
  const unsigned bits = static_cast<unsigned>(b0 & 3) * 8u;
  const long long nwords = total >> 2;
  const unsigned* words = reinterpret_cast<const unsigned*>(img);
  unsigned wd[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long idx = w0 + k;
    wd[k] = idx >= 0 && idx < nwords ? __ldg(words + idx) : 0u;
  }
  unsigned r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = __funnelshift_r(wd[k], wd[k + 1], bits);
#pragma unroll
  for (int j = 0; j <= kQuad; ++j) {
    const int q = q0 + j;
    const bool in = q >= 0 && q < w && j < n;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int byte = 3 * j + ch;
      const unsigned v = (r[byte >> 2] >> (8 * (byte & 3))) & 0xffu;
      p[byte] = in ? static_cast<float>(v) : 0.f;
    }
  }
}

// Pixels a thread on the fast route: 4, but 1 on the column pass of
// 16-byte pixels (see the note at the top).
template <int C, int AXIS>
constexpr int kThreadPixels = C == 4 && AXIS == 0 ? 1 : kQuad;

// B5 and B7, the fast route (see the note at the top).
template <typename T, int C, int AXIS, typename Lookup>
__global__ void __launch_bounds__(kTileX * kTileY, 1)
fast_shift_kernel(const T* __restrict__ img, const int8_t* __restrict__ ids,
                  const Lookup lookup, int h, int w, float* __restrict__ out) {
  constexpr int P = kThreadPixels<C, AXIS>;
  const int x0 = (blockIdx.x * kTileX + threadIdx.x) * P;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x0 >= w || y >= h) return;
  const long long px = static_cast<long long>(y) * w + x0;
  unsigned word;                                  // the thread's P ids, one a byte
  if (P == kQuad) {
    word = __ldg(reinterpret_cast<const unsigned*>(ids + px));
  } else {
    word = static_cast<unsigned>(static_cast<uint8_t>(__ldg(ids + px)));
  }
  float o[P * C];
  if (P == kQuad && AXIS == 1 && word == (word & 0xffu) * 0x01010101u) {
    const Shift sh = lookup(y, static_cast<int>(static_cast<int8_t>(word & 0xffu)));
    const int q0 = x0 + sh.s;
    if (q0 + kQuad < 0 || q0 >= w) {              // every tap outside the row
#pragma unroll
      for (int k = 0; k < P * C; ++k) o[k] = 0.f;
    } else {
      float p[(kQuad + 1) * C];
      load_run<C>(img, static_cast<long long>(y) * w * C, w, q0, sh.keep ? kQuad : kQuad + 1,
                  static_cast<long long>(h) * w * C, p);
      const float wa = __fsub_rn(1.f, sh.f);
#pragma unroll
      for (int k = 0; k < P * C; ++k) {
        o[k] = sh.keep ? p[k] : __fmaf_rn(p[k], wa, __fmul_rn(p[k + C], sh.f));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int id = static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
      const Shift sh = lookup(AXIS == 1 ? y : x0 + i, id);
      lerp_one<T, C, AXIS>(img, h, w, y, x0 + i, sh, o + i * C);
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + px * C);
#pragma unroll
  for (int k = 0; k < P * C / 4; ++k) {
    dst[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  }
}

// B5 and B7, the generic route: one pixel a thread, run-time C and axis.
template <typename T, typename Lookup>
__global__ void generic_shift_kernel(const T* __restrict__ img,
                                   const int8_t* __restrict__ ids, const Lookup lookup,
                                   Geometry g, float* __restrict__ out) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= g.w || y >= g.h) return;
  const long long px = static_cast<long long>(y) * g.w + x;
  const Shift sh = lookup(g.axis == 1 ? y : x, static_cast<int>(ids[px]));
  if (sh.keep) {
    for (int ch = 0; ch < g.c; ++ch) out[px * g.c + ch] = load(img, px * g.c + ch);
    return;
  }
  lerp_pixel(img, out, g, y, x, sh.s, sh.f);
}

bool valid_geometry(const Geometry& g) {
  return g.h > 0 && g.w > 0 && g.c >= 1 && g.c <= kMaxChannels &&
         (g.axis == 0 || g.axis == 1);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// Whether the fast route can take these pointers: 4 ids as one word, 16-byte
// stores, and the image's loads (16 bytes for a 4-float pixel, else 4).
bool fast_route(const Geometry& g, int dtype, const void* img, const void* ids,
                const void* out) {
  return g.w % kQuad == 0 && aligned(ids, 4) && aligned(out, 16) &&
         aligned(img, dtype == 1 && g.c == 4 ? 16 : 4);
}

dim3 pixel_grid(int w, int h) {
  return dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
}

template <typename T, int C, typename Lookup>
void launch_fast(const void* img, const void* ids, const Lookup& lookup, const Geometry& g,
                 void* out, cudaStream_t st) {
  const dim3 block(kTileX, kTileY);
  const T* im = static_cast<const T*>(img);
  const int8_t* id = static_cast<const int8_t*>(ids);
  float* o = static_cast<float*>(out);
  if (g.axis == 1) {
    const dim3 grid = pixel_grid(g.w / kThreadPixels<C, 1>, g.h);
    fast_shift_kernel<T, C, 1, Lookup><<<grid, block, 0, st>>>(im, id, lookup, g.h, g.w, o);
  } else {
    const dim3 grid = pixel_grid(g.w / kThreadPixels<C, 0>, g.h);
    fast_shift_kernel<T, C, 0, Lookup><<<grid, block, 0, st>>>(im, id, lookup, g.h, g.w, o);
  }
}

template <typename Lookup>
void launch_generic(const void* img, int dtype, const void* ids, const Lookup& lookup,
                  const Geometry& g, void* out, cudaStream_t st) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid = pixel_grid(g.w, g.h);
  const int8_t* id = static_cast<const int8_t*>(ids);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    generic_shift_kernel<uint8_t, Lookup><<<grid, block, 0, st>>>(
        static_cast<const uint8_t*>(img), id, lookup, g, o);
  } else {
    generic_shift_kernel<float, Lookup><<<grid, block, 0, st>>>(
        static_cast<const float*>(img), id, lookup, g, o);
  }
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

// `route` receives 1 where the fast route was launched and 0 for the generic one.
extern "C" int oadg_piecewise_shift_rows(const void* img, int dtype, int h, int w,
                                         int c, int axis, const void* bid,
                                         const void* shifts, int nb,
                                         float max_shift, void* out, void* stream,
                                         int* route) {
  const Geometry g{h, w, c, axis};
  if (!valid_geometry(g) || (dtype != 0 && dtype != 1) || nb < 1 ||
      nb > kMaxBoxes || !(max_shift >= 0.f) || route == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PiecewiseLookup lookup{static_cast<const float*>(shifts), nb, max_shift};
  *route = c == 3 && fast_route(g, dtype, img, bid, out) ? 1 : 0;
  if (*route == 1 && dtype == 0) {
    launch_fast<uint8_t, 3>(img, bid, lookup, g, out, st);
  } else if (*route == 1) {
    launch_fast<float, 3>(img, bid, lookup, g, out, st);
  } else {
    launch_generic(img, dtype, bid, lookup, g, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int oadg_merged_shift_rows(const void* img, int dtype, int h, int w, int c,
                                      int axis, const void* cid, const void* p_bb,
                                      const void* p_sl, int sg, int ns,
                                      unsigned bb_mask, unsigned bg_mask, void* out,
                                      void* stream, int* route) {
  const Geometry g{h, w, c, axis};
  if (!valid_geometry(g) || (dtype != 0 && dtype != 1) || ns < 1 || ns > kMaxSlots ||
      sg < 1 || sg > kMaxBoxes || sg % ns != 0 || route == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(p_bb);
  const float* ps = static_cast<const float*>(p_sl);
  const MergedLookup<false> lookup{pb, ps, sg, ns, sg / ns, bb_mask, bg_mask};
  *route = dtype == 1 && c == 4 && fast_route(g, dtype, img, cid, out) ? 1 : 0;
  if (*route == 1 && ns == 1) {
    const MergedLookup<true> one{pb, ps, sg, ns, sg, bb_mask, bg_mask};
    launch_fast<float, 4>(img, cid, one, g, out, st);
  } else if (*route == 1) {
    launch_fast<float, 4>(img, cid, lookup, g, out, st);
  } else {
    launch_generic(img, dtype, cid, lookup, g, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
