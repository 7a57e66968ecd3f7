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
// What bounds it on the H100: the bytes written. The outputs are 5 bytes a
// pixel (10.5 MB at 1024 x 2048, 0.0032 ms at 3.35 TB/s with the inputs);
// the work is ~7 instructions a pixel and box, which only the dense case
// (every box non-zero everywhere) brings near the stores' time. OA-Mix's
// blurred, gated profiles are mostly exact zeros: over 90% of the (pixel,
// box) products are 0. The design:
//   - Per-tile culling. A block of 16 warps owns a tile of 16 rows x 256
//     columns. Its warps first copy the tile's fx of every box into shared
//     memory (box i by warp i % 16, 8 values a lane), and one ballot a box
//     marks the boxes whose fx is non-zero over the tile's columns; at the
//     same time each warp's lanes read fy of its row for 32 boxes at once.
//     After one barrier, a second ballot lists the boxes live on the row
//     (fy != 0 there and fx on the tile), in index order, and the loop runs
//     over those alone, reading fx from shared memory; a lane whose 8 fx
//     values of a live box are all 0 skips it too. A box skipped anywhere
//     gives m = 0 there, which fails m >= kBidEps, multiplies the coverage
//     product by exactly 1 and cannot raise the union above its starting
//     0: the maps are those of the full loop (for finite profiles; the
//     profiles are clamps into [0, 1]). A row with no live box writes
//     (G, 0, 0).
//   - Several pixels a thread. Each lane owns 8 consecutive pixels of one
//     row: it reads its fx with two 16-byte loads and writes best_id with
//     one 8-byte store and cover and union with one 16-byte store each; a
//     warp's stores are 256 + 2 x 512 contiguous bytes. Images whose width
//     is not a multiple of 8 (or whose pointers are not 16-byte aligned)
//     take the same loop with scalar loads and stores.
//   - Launch. The kernel is launched as a programmatic dependent launch: its
//     blocks may be scheduled while the kernel before it in the stream
//     finishes, and each waits for that kernel (griddepcontrol.wait) before
//     it touches device memory.
//
// Rounding: m is one f32 product (__fmul_rn, never contracted into the
// following 1 - m), and the product over i runs in index order, as the
// plain PyTorch version does; bf16 outputs are round-to-nearest-even. The
// argmax is taken against the running union: a box becomes best where its
// m exceeds every earlier m and reaches kBidEps, which is the first index
// of the largest m at or above kBidEps, as the plain version's argmax.
//
// C interface, loaded with ctypes by oadg_tpu_torch/ops/_kernels.py; the
// caller allocates the outputs and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 8;               // consecutive pixels a lane
constexpr int kSpan = 32 * kPixels;      // columns a tile
constexpr int kRows = 16;                // rows (warps) a tile
constexpr int kMaxBoxes = 127;           // best_id is int8
constexpr int kMaxDevices = 64;
constexpr float kBidEps = 1e-5f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool kVector>
__global__ void __launch_bounds__(32 * kRows)
fg_maps_kernel(const float* __restrict__ fx, const float* __restrict__ fy, int g, int h,
               int w, int8_t* __restrict__ best_id, __nv_bfloat16* __restrict__ cover,
               __nv_bfloat16* __restrict__ uni) {
  extern __shared__ float4 sfx[];        // (g, 2, 32): a warp's 16-byte reads are contiguous
  __shared__ unsigned char xlive[kMaxBoxes + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y = blockIdx.y * kRows + warp;
  const int x = blockIdx.x * kSpan + lane * kPixels;
  const int n = min(kPixels, w - x);     // this lane's pixels (<= 0: none)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float f[4];                            // fy[32 c + lane, y]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = 32 * c + lane;
    f[c] = (y < h && i < g) ? __ldg(fy + static_cast<long long>(i) * h + y) : 0.f;
  }
  for (int i = warp; i < g; i += kRows) {
    const float* row = fx + static_cast<long long>(i) * w + x;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (kVector) {
      if (n > 0) {
        a = __ldg(reinterpret_cast<const float4*>(row));
        b = __ldg(reinterpret_cast<const float4*>(row) + 1);
      }
    } else {
      float v[kPixels];
#pragma unroll
      for (int p = 0; p < kPixels; ++p) v[p] = p < n ? __ldg(row + p) : 0.f;
      a = make_float4(v[0], v[1], v[2], v[3]);
      b = make_float4(v[4], v[5], v[6], v[7]);
    }
    sfx[i * 64 + lane] = a;
    sfx[i * 64 + 32 + lane] = b;
    const bool nz = a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f ||
                    b.x != 0.f || b.y != 0.f || b.z != 0.f || b.w != 0.f;
    const unsigned any = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) xlive[i] = any != 0;
  }
  __syncthreads();
  if (y >= h) return;                    // a whole warp
  int bid[kPixels];
  float one_minus[kPixels], un[kPixels];
#pragma unroll
  for (int p = 0; p < kPixels; ++p) {
    bid[p] = g;
    one_minus[p] = 1.f;
    un[p] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i0 = 32 * c;
    if (i0 >= g) break;
    unsigned live = __ballot_sync(0xffffffffu,
                                  f[c] != 0.f && i0 + lane < g && xlive[i0 + lane]);
    while (live) {                       // the row's live boxes, in index order
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const float fyv = __shfl_sync(0xffffffffu, f[c], k);
      const int box = i0 + k;
      const float4 a = sfx[box * 64 + lane];
      const float4 b = sfx[box * 64 + 32 + lane];
      const float v[kPixels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      bool any = false;
#pragma unroll
      for (int p = 0; p < kPixels; ++p) any |= v[p] != 0.f;
      if (!any) continue;                // m = 0 on all 8 pixels
#pragma unroll
      for (int p = 0; p < kPixels; ++p) {
        const float m = __fmul_rn(fyv, v[p]);
        if (m > un[p] && m >= kBidEps) bid[p] = box;
        one_minus[p] = __fmul_rn(one_minus[p], __fsub_rn(1.f, m));
        un[p] = fmaxf(un[p], m);
      }
    }
  }
  if (n <= 0) return;
  float cv[kPixels];
#pragma unroll
  for (int p = 0; p < kPixels; ++p) cv[p] = fminf(fmaxf(__fsub_rn(1.f, one_minus[p]), 0.f), 1.f);
  const long long o = static_cast<long long>(y) * w + x;
  if (kVector) {
    uint2 ids;
    ids.x = (bid[0] & 0xff) | (bid[1] & 0xff) << 8 | (bid[2] & 0xff) << 16 | bid[3] << 24;
    ids.y = (bid[4] & 0xff) | (bid[5] & 0xff) << 8 | (bid[6] & 0xff) << 16 | bid[7] << 24;
    *reinterpret_cast<uint2*>(best_id + o) = ids;
    *reinterpret_cast<uint4*>(cover + o) = make_uint4(
        pack_bf16(cv[0], cv[1]), pack_bf16(cv[2], cv[3]), pack_bf16(cv[4], cv[5]),
        pack_bf16(cv[6], cv[7]));
    *reinterpret_cast<uint4*>(uni + o) = make_uint4(
        pack_bf16(un[0], un[1]), pack_bf16(un[2], un[3]), pack_bf16(un[4], un[5]),
        pack_bf16(un[6], un[7]));
  } else {
#pragma unroll
    for (int p = 0; p < kPixels; ++p) {
      if (p < n) {
        best_id[o + p] = static_cast<int8_t>(bid[p]);
        cover[o + p] = __float2bfloat16_rn(cv[p]);
        uni[o + p] = __float2bfloat16_rn(un[p]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int oadg_fg_maps(const void* fx, const void* fy, int g, int h, int w,
                            void* best_id, void* cover, void* uni, void* stream) {
  if (g < 1 || g > kMaxBoxes || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vector = w % kPixels == 0 && aligned16(fx) && aligned16(best_id) &&
                      aligned16(cover) && aligned16(uni);
  const auto kernel = vector ? fg_maps_kernel<true> : fg_maps_kernel<false>;
  static bool ready[kMaxDevices][2];     // per device: shared memory for G = 127 allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  if (!ready[dev][vector]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBoxes * kSpan * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev][vector] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((w + kSpan - 1) / kSpan, (h + kRows - 1) / kRows);
  cfg.blockDim = dim3(32 * kRows);
  cfg.dynamicSmemBytes = static_cast<size_t>(g) * kSpan * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(fx),
                           static_cast<const float*>(fy), g, h, w,
                           static_cast<int8_t*>(best_id),
                           static_cast<__nv_bfloat16*>(cover),
                           static_cast<__nv_bfloat16*>(uni));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
