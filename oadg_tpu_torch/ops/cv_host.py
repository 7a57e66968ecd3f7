"""The OpenCV image functions of the corruption suite, without OpenCV.

The JAX package's corruptions (``oadg_tpu/ops/corruptions.py``) call ``cv2``
in 11 of their 19 functions; the card's host has numpy and scipy but no
OpenCV, so the port computes each of those calls here, following OpenCV's
algorithm for the dtypes the suite uses:

- ``resize``: float32 / float64 ``INTER_LINEAR`` (OpenCV 5's fused lerps at
  fused float64 source coordinates), float32 ``INTER_CUBIC`` (cv2's taps
  and coefficient formula; OpenCV 5 evaluates the coefficients in another
  order, so values differ by a few units in the last place), uint8
  ``INTER_AREA`` (the integer-scale block average, or the fractional-area
  tables accumulated in float32) and ``INTER_NEAREST``;
- ``bgr2gray``, ``bgr2hsv``, ``hsv2bgr``: uint8 ``cvtColor`` by its
  fixed-point tables (and the float sector formula back from HSV);
- ``get_affine_transform``: cv2's 6x6 LU solve in float64;
- ``warp_affine``, ``remap``: ``INTER_LINEAR`` at float32 source
  coordinates with fused lerps and ``BORDER_REFLECT_101`` (OpenCV 5 no
  longer rounds coordinates to 1/32 of a pixel; see ``warp_affine`` for
  its last columns);
- ``canny``: 3x3 Sobel, L1 magnitude, non-maximum suppression by the
  tan(22.5) fixed-point test, hysteresis over 8-connected weak pixels;
- ``distance_transform``: ``DIST_L2`` with the 5x5 chamfer mask
  (1, 1.4, 2.1969 summed in float32, the route cv2 takes through IPP), two
  raster passes (a unit in the last place apart on a few pixels, see there);
- ``box_blur``: the normalized 3x3 box filter summed in float64;
- ``jpeg_roundtrip``: libjpeg-turbo's lossy steps at a quality (integer
  YCbCr tables, 4:2:0 with the 1/2 rounding bias, the islow DCT and IDCT,
  quantization by the encoder's reciprocals, fancy upsampling), the
  entropy coding left out because it is lossless; it lives with the port's
  JPEG codec, ``utils/jpeg.py``, whose decoder shares its arithmetic;
- ``gaussian_blur``, ``filter2d``: correlation with the ``REFLECT_101``
  border computed in float64 (separably; by FFT for ``filter2d``, whose
  kernels here are 17x17 to 41x41) and rounded once to the image's dtype.
  cv2 sums these in float32, and ``filter2D`` by DFT for such kernels, so
  these two agree with it to a few units in the last place, not bit for
  bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.ndimage as ndi
import scipy.signal

from ..utils.jpeg import jpeg_roundtrip  # noqa: F401  (the JPEG corruption's, with the codec)
from .image_ops import gaussian_kernel1d

__all__ = ["INTER_NEAREST", "INTER_LINEAR", "INTER_CUBIC", "INTER_AREA", "resize",
           "gaussian_blur", "filter2d", "box_blur", "bgr2gray", "bgr2hsv", "hsv2bgr",
           "get_affine_transform", "warp_affine", "remap", "canny",
           "distance_transform", "jpeg_roundtrip"]

INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA = 0, 1, 2, 3
_F32 = np.float32


# ------------------------------------------------------------- resize ----

def _split(a: np.ndarray):
    c = 134217729.0 * a                                   # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once, as a fused multiply-add rounds it: for
    float32 operands the float64 product is exact; for float64 ones the
    product's error term (Dekker's split) and the sum's (Knuth's two-sum)
    are carried into the one rounding."""
    a, b, c = (np.asarray(v) for v in (a, b, c))
    if a.dtype == b.dtype == c.dtype == np.float32:
        return (np.multiply(a, b, dtype=np.float64) + c).astype(_F32)
    a, b, c = (v.astype(np.float64, copy=False) for v in (a, b, c))
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + err)


def _src_coords(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV 5's source coordinate of each output index,
    ``fma(dx + 0.5, src / dst, -0.5)`` in float64, split into the floor and
    the fraction."""
    f = _fma(np.arange(dst, dtype=np.float64) + 0.5, np.float64(src / dst), np.float64(-0.5))
    s = np.floor(f).astype(np.int64)
    return s, f - s


def _cubic_coeffs(x: np.ndarray):
    """cv2's ``interpolateCubic`` (A = -0.75) in float32."""
    x = x.astype(_F32)
    a = _F32(-0.75)
    one = _F32(1)
    x1 = x + one
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
    ox = one - x
    c2 = ((a + _F32(2)) * ox - (a + _F32(3))) * ox * ox + one
    c3 = one - c0 - c1 - c2
    return c0, c1, c2, c3


def _resize_linear_float(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """OpenCV 5's float linear resize: each pass is the fused lerp
    ``fma(t, b - a, a)`` in the image's dtype, the fraction ``t`` of the
    float64 coordinate cast to it; a column left of the image or at its
    last takes the edge pixel, rows are clamped to the image."""
    sh, sw = img.shape[:2]
    dt = img.dtype
    sx, fx = _src_coords(dw, sw)
    edge = (sx < 0) | (sx >= sw - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, sw - 1)
    x = img.reshape(sh, sw, -1)
    x0 = x[:, sx]
    horiz = _fma(fx.astype(dt)[None, :, None], x[:, np.minimum(sx + 1, sw - 1)] - x0, x0)
    sy, fy = _src_coords(dh, sh)
    r0 = horiz[np.clip(sy, 0, sh - 1)]
    r1 = horiz[np.clip(sy + 1, 0, sh - 1)]
    out = _fma(fy.astype(dt)[:, None, None], r1 - r0, r0)
    return out.reshape((dh, dw) + img.shape[2:])


def _resize_cubic_float(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    x = img.reshape(sh, sw, -1).astype(_F32)
    sx, fx = _src_coords(dw, sw)
    cx = _cubic_coeffs(fx)
    horiz = None
    for k in range(4):
        t = x[:, np.clip(sx - 1 + k, 0, sw - 1)] * cx[k][None, :, None]
        horiz = t if horiz is None else horiz + t
    sy, fy = _src_coords(dh, sh)
    cy = _cubic_coeffs(fy)
    out = None
    for k in range(4):
        t = horiz[np.clip(sy - 1 + k, 0, sh - 1)] * cy[k][:, None, None]
        out = t if out is None else out + t
    return out.reshape((dh, dw) + img.shape[2:])


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's ``computeResizeAreaTab``: (dst index, src index, float32 weight)
    triples in cv2's order."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2)
            alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(alpha, _F32)


def _slots(di: np.ndarray, si: np.ndarray, alpha: np.ndarray, dsize: int):
    """The area table as (dsize, taps) index and weight arrays, each row's
    taps in table order, padded with weight 0 (adding 0 leaves a float sum
    unchanged)."""
    counts = np.bincount(di, minlength=dsize)
    taps = int(counts.max())
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(di)) - start[di]
    idx = np.zeros((dsize, taps), np.int64)
    w = np.zeros((dsize, taps), _F32)
    idx[di, rank], w[di, rank] = si, alpha
    return idx, w


def _round_u8(x: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of a float: round half to even, clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _resize_area_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    x = img.reshape(sh, sw, -1)
    cn = x.shape[2]
    scale_x, scale_y = sw / dw, sh / dh
    ix, iy = int(round(scale_x)), int(round(scale_y))
    if abs(scale_x - ix) < np.finfo(float).eps and abs(scale_y - iy) < np.finfo(float).eps:
        # resizeAreaFast: block sums, 2x2 as (sum + 2) >> 2, larger blocks
        # as saturate_cast(sum * (1 / area))
        area = ix * iy
        blocks = x[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix, cn).astype(np.int32)
        total = blocks.sum(axis=(1, 3))
        if ix == iy == 2:
            out = ((total + 2) >> 2).astype(np.uint8)
        else:
            out = _round_u8(total.astype(_F32) * _F32(1.0 / area))
        return out.reshape((dh, dw) + img.shape[2:])
    xi, xw = _slots(*_area_tab(sw, dw, scale_x), dw)
    yd, ys, yw = _area_tab(sh, dh, scale_y)
    xf = x.astype(_F32)
    buf = np.zeros((sh, dw, cn), _F32)
    for k in range(xi.shape[1]):
        buf = buf + xf[:, xi[:, k]] * xw[None, :, k, None]
    out = np.zeros((dh, dw, cn), _F32)
    first = np.ones(dh, bool)
    for d, s, a in zip(yd, ys, yw):
        if first[d]:
            out[d] = a * buf[s]
            first[d] = False
        else:
            out[d] = out[d] + a * buf[s]
    return _round_u8(out).reshape((dh, dw) + img.shape[2:])


def _resize_nearest(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    fx, fy = 1.0 / (dw / sw), 1.0 / (dh / sh)
    xs = np.minimum(np.floor(np.arange(dw) * fx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * fy).astype(np.int64), sh - 1)
    return img[ys][:, xs]


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=...)``, ``size`` = (width,
    height), for an (H, W) or (H, W, C) image of the dtypes the suite
    resizes: float32 / float64 linear, float32 cubic, uint8 area (down) and
    nearest. (uint8 linear is the test path's ``resize_bilinear``.)"""
    dw, dh = int(size[0]), int(size[1])
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, dw, dh)
    if interpolation == INTER_LINEAR and img.dtype in (np.float32, np.float64):
        return _resize_linear_float(img, dw, dh)
    if interpolation == INTER_CUBIC and img.dtype == np.float32:
        return _resize_cubic_float(img, dw, dh)
    if interpolation == INTER_AREA and img.dtype == np.uint8 \
            and dw <= img.shape[1] and dh <= img.shape[0]:
        return _resize_area_u8(img, dw, dh)
    raise NotImplementedError(f"resize: interpolation {interpolation} of a "
                              f"{img.dtype} image to {size} is not implemented")


# ------------------------------------------------------------ filters ----

def _pad101(img: np.ndarray, ry: int, rx: int) -> np.ndarray:
    pad = [(ry, ry), (rx, rx)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="reflect")


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` of an (H, W[, C]) float image with
    an odd kernel anchored at its middle tap, ``REFLECT_101`` border: the
    correlation in float64 by FFT, rounded once to the image's dtype."""
    kh, kw = kernel.shape
    x = _pad101(img.astype(np.float64), kh // 2, kw // 2)
    k = kernel.astype(np.float64)[::-1, ::-1]
    if x.ndim == 3:
        k = k[..., None]
    return scipy.signal.fftconvolve(x, k, mode="valid", axes=(0, 1)).astype(img.dtype)


def gaussian_blur(img: np.ndarray, ksize, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigmaX=sigma)`` of a float32 image
    (``ksize`` (0, 0) derives it from sigma as cv2 does for float images)."""
    kw = int(ksize[0])
    if kw <= 0:
        kw = int(np.rint(sigma * 4 * 2 + 1)) | 1
    k = gaussian_kernel1d(sigma, kw).astype(np.float64)
    r = kw // 2
    x = _pad101(img.astype(np.float64), r, r)
    h, w = img.shape[:2]
    rows = sum(k[i] * x[:, i:i + w] for i in range(kw))
    out = sum(k[i] * rows[i:i + h] for i in range(kw))
    return out.astype(img.dtype)


def box_blur(img: np.ndarray, ksize=(3, 3)) -> np.ndarray:
    """``cv2.blur(img, ksize)`` of a float32 image: cv2 sums rows and
    columns in float64 (exact here) and scales by ``1 / area`` in float64."""
    kw, kh = int(ksize[0]), int(ksize[1])
    h, w = img.shape[:2]
    x = _pad101(img.astype(np.float64), kh // 2, kw // 2)
    rows = sum(x[:, i:i + w] for i in range(kw))
    total = sum(rows[i:i + h] for i in range(kh))
    return (total * (1.0 / (kw * kh))).astype(img.dtype)


# ------------------------------------------------------------- colour ----

def bgr2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` of uint8: 15-bit fixed point."""
    x = img.astype(np.int32)
    y = x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def _div_table(num: int, den: float) -> np.ndarray:
    t = np.zeros(256, np.int64)
    i = np.arange(1, 256)
    t[1:] = np.rint((num << 12) / (den * i)).astype(np.int64)
    return t


_SDIV, _HDIV180 = _div_table(255, 1.0), _div_table(180, 6.0)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` of uint8 (H in [0, 180))."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << 11)) >> 12
    h = h + np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2BGR)`` of uint8: cv2's float32 sector
    formula (``v (1 - s f)`` and ``v (1 - s (1 - f))`` with a fused
    ``1 - s f``) scaled by 255. cv2's vector loop takes 32 pixels of a row
    at a time and truncates; the pixels after the last full 32 of each row
    go through its scalar loop, which rounds."""
    h = img[..., 0].astype(_F32) * _F32(6.0 / 180.0)
    s = img[..., 1].astype(_F32) * _F32(1 / 255.0)
    v = img[..., 2].astype(_F32) * _F32(1 / 255.0)
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(_F32)
    bad = (sector < 0) | (sector >= 6)
    sector[bad] = 0
    f[bad] = 0
    one = np.ones_like(f)
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one), v * _fma(-s, one - f, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * _F32(255)
    vec = img.shape[-2] // 32 * 32
    out = np.empty(bgr.shape, np.uint8)
    out[..., :vec, :] = np.clip(np.floor(bgr[..., :vec, :]), 0, 255)
    out[..., vec:, :] = _round_u8(bgr[..., vec:, :])
    return out


# ---------------------------------------------------------- geometric ----

def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform``: the 6x6 system solved by cv2's LU with
    partial pivoting in float64 (rows eliminated with ``-1 / pivot``, the
    back substitution divided by the pivot) -> (2, 3) float64."""
    src = np.asarray(src, _F32).astype(np.float64)
    dst = np.asarray(dst, _F32).astype(np.float64)
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        a[2 * i][0] = a[2 * i + 1][3] = float(src[i, 0])
        a[2 * i][1] = a[2 * i + 1][4] = float(src[i, 1])
        a[2 * i][2] = a[2 * i + 1][5] = 1.0
        b[2 * i], b[2 * i + 1] = float(dst[i, 0]), float(dst[i, 1])
    m = 6
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise ValueError("get_affine_transform: degenerate points")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.asarray(b, np.float64).reshape(2, 3)


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """cv2's ``borderInterpolate(i, n, BORDER_REFLECT_101)``."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """OpenCV 5's bilinear sample of a float32 image at float32 source
    coordinates, ``BORDER_REFLECT_101``: the fractions in float32, then the
    fused lerp ``fma(fx, p01 - p00, p00)`` along each row and the same
    along the column."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    ix, iy = np.floor(sx), np.floor(sy)
    fx = (sx - ix)[..., None]
    fy = (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    x0, x1 = _reflect101(ix, w), _reflect101(ix + 1, w)
    y0, y1 = _reflect101(iy, h), _reflect101(iy + 1, h)
    top = _fma(fx, x[y0, x1] - x[y0, x0], x[y0, x0])
    bottom = _fma(fx, x[y1, x1] - x[y1, x0], x[y1, x0])
    return _fma(fy, bottom - top, top).reshape(sx.shape + img.shape[2:])


def remap(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, INTER_LINEAR, BORDER_REFLECT_101)`` of a
    float32 image with float32 maps."""
    return _bilinear(img, mapx.astype(_F32), mapy.astype(_F32))


def warp_affine(img: np.ndarray, m: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, INTER_LINEAR, BORDER_REFLECT_101)`` of
    a float32 image: ``m`` inverted in float64 as cv2 inverts it, cast to
    float32; each output pixel samples at ``fma(m0, x, m1 y + m2)``,
    ``fma(m3, x, m4 y + m5)`` in float32. cv2 takes the last (width mod 16)
    columns of a row through a scalar loop whose coordinates this does not
    follow: those agree to ~1e-5, the rest bit for bit."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    inv = [m[4] * d, -m[1] * d, 0.0, -m[3] * d, m[0] * d, 0.0]
    inv[2] = -inv[0] * m[2] - inv[1] * m[5]
    inv[5] = -inv[3] * m[2] - inv[4] * m[5]
    f = np.asarray(inv, _F32)
    dw, dh = int(size[0]), int(size[1])
    xs = np.arange(dw, dtype=_F32)[None, :]
    ys = np.arange(dh, dtype=_F32)[:, None]
    sx = _fma(f[0], xs, f[1] * ys + f[2])
    sy = _fma(f[3], xs, f[4] * ys + f[5])
    return _bilinear(img, sx, sy)


# --------------------------------------------------------------- edges ----

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(img, low, high)`` of a one-channel uint8 image (aperture 3,
    L1 gradient) -> uint8 edges (255) and zeros."""
    lo, hi = int(np.floor(low)), int(np.floor(high))
    h, w = img.shape
    p = np.pad(img.astype(np.int32), 1, mode="edge")
    dx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    dy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    mag = np.abs(dx) + np.abs(dy)
    mp = np.pad(mag, 1)                                   # zero magnitude outside
    at = lambda oy, ox: mp[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]   # noqa: E731
    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    diag = ~horiz & ~vert
    s = np.where((dx ^ dy) < 0, -1, 1)
    keep = np.zeros((h, w), bool)
    keep |= horiz & (mag > at(0, -1)) & (mag >= at(0, 1))
    keep |= vert & (mag > at(-1, 0)) & (mag >= at(1, 0))
    d_pos = (mag > at(-1, -1)) & (mag > at(1, 1))         # s = 1
    d_neg = (mag > at(-1, 1)) & (mag > at(1, -1))         # s = -1
    keep |= diag & np.where(s > 0, d_pos, d_neg)
    keep &= mag > lo
    strong = keep & (mag > hi)
    labels, n = ndi.label(keep, structure=np.ones((3, 3), bool))
    hit = np.zeros(n + 1, bool)
    hit[labels[strong]] = True
    hit[0] = False
    return np.where(hit[labels], 255, 0).astype(np.uint8)


def distance_transform(img: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(img, DIST_L2, 5)`` of a one-channel uint8
    image: the distance to the nearest zero pixel by the 5x5 chamfer mask
    (1, 1.4, 2.1969), summed in float32 as cv2's IPP route sums it, in a
    forward and a backward raster pass; pixels beyond the border count as
    infinitely far. Within a row the pass is ``t[j] = min(c[j], t[j - 1] +
    1)``, computed as a prefix minimum of ``c[k] - k`` in float64 and cast."""
    a, b, c5 = _F32(1.0), _F32(1.4), _F32(2.1969)
    h, w = img.shape
    far = _F32(3.0e38)
    t = np.full((h + 4, w + 4), far, _F32)
    zero = img == 0
    jj = np.arange(w, dtype=np.float64)

    def scan(c, reverse):
        c = c[::-1] if reverse else c
        run = np.minimum.accumulate(c.astype(np.float64) - jj) + jj
        run = np.minimum(run.astype(_F32), c)
        return run[::-1] if reverse else run

    with np.errstate(over="ignore"):
        for i in range(h):
            r = i + 2
            c = np.minimum.reduce([
                t[r - 2, 1:w + 1] + c5, t[r - 2, 3:w + 3] + c5, t[r - 1, 0:w] + c5,
                t[r - 1, 1:w + 1] + b, t[r - 1, 2:w + 2] + a, t[r - 1, 3:w + 3] + b,
                t[r - 1, 4:w + 4] + c5])
            t[r, 2:w + 2] = scan(np.where(zero[i], _F32(0), c).astype(_F32), False)
        for i in range(h - 1, -1, -1):
            r = i + 2
            c = np.minimum.reduce([
                t[r, 2:w + 2], t[r + 2, 3:w + 3] + c5, t[r + 2, 1:w + 1] + c5,
                t[r + 1, 4:w + 4] + c5, t[r + 1, 3:w + 3] + b, t[r + 1, 2:w + 2] + a,
                t[r + 1, 1:w + 1] + b, t[r + 1, 0:w] + c5])
            t[r, 2:w + 2] = scan(c.astype(_F32), True)
    return t[2:h + 2, 2:w + 2].copy()
