"""Cityscapes-C / COCO-C corruption suite (port of ``oadg_tpu/ops/corruptions.py``).

The 15 benchmark and 4 holdout corruptions of ImageNet-C with the JAX
package's severity tables and its two documented departures from the
``imagecorruptions`` package: ``frost`` blends a procedural texture (seeded
value noise) instead of the package's photographs, and ``glass_blur``'s
per-pixel swap loop is a vectorised random displacement with the same
parameters. The port is held to the JAX package, not to the package behind
it.

Every OpenCV call of the JAX suite is computed by ``ops/cv_host.py``, so the
suite runs where OpenCV is not installed. Every random draw goes through
``rng`` in the JAX package's order and count, the seed that ``frost`` draws
for its texture and the draws of the fog's plasma fractal included; with
``rng=None`` the functions draw from ``np.random``'s global generator, as
the JAX suite does. ``np.random.RandomState(s)`` yields the stream of
``np.random.seed(s)``, so ``corrupt_numpy(img, name, sev,
rng=RandomState(s))`` equals the JAX ``corrupt_numpy(img, name, sev)`` after
``np.random.seed(s)``; ``sample_seed`` is the seed the ``Corrupt`` op and
``tools/torch_get_corrupted_dataset.py`` give one image of one
(corruption, severity) cell.

``corrupt_numpy`` mirrors ``imagecorruptions.corrupt(image, corruption_name,
severity)``: uint8 HWC BGR in, uint8 HWC out; severity 0 returns the image
itself.
"""
from __future__ import annotations

from typing import List

import numpy as np
import scipy.ndimage as ndi

from . import cv_host as cv

__all__ = ["CORRUPTIONS", "BENCHMARK_CORRUPTIONS", "HOLDOUT_CORRUPTIONS",
           "corrupt_numpy", "sample_seed"]


def _as_float(x):
    return np.asarray(x, np.float32) / 255.0


def _to_uint8(x):
    return np.uint8(np.clip(x, 0, 1) * 255)


# ---------------------------------------------------------------- noise ----

def gaussian_noise(x, severity, rng):
    c = [.08, .12, 0.18, 0.26, 0.38][severity - 1]
    x = _as_float(x)
    return _to_uint8(x + rng.normal(size=x.shape, scale=c))


def shot_noise(x, severity, rng):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _as_float(x)
    return _to_uint8(rng.poisson(x * c) / float(c))


def impulse_noise(x, severity, rng):
    c = [.03, .06, .09, 0.17, 0.27][severity - 1]
    x = _as_float(x)
    flip = rng.rand(*x.shape[:2]) < c
    salt = rng.rand(*x.shape[:2]) < 0.5
    out = x.copy()
    out[flip & salt] = 1.0
    out[flip & ~salt] = 0.0
    return _to_uint8(out)


def speckle_noise(x, severity, rng):
    c = [.15, .2, 0.35, 0.45, 0.6][severity - 1]
    x = _as_float(x)
    return _to_uint8(x + x * rng.normal(size=x.shape, scale=c))


# ---------------------------------------------------------------- blur -----

def _disk(radius, alias_blur=0.1, dtype=np.float32):
    if radius <= 8:
        coords = np.arange(-8, 8 + 1)
        ksize = (3, 3)
    else:
        coords = np.arange(-radius, radius + 1)
        ksize = (5, 5)
    xs, ys = np.meshgrid(coords, coords)
    aliased = np.array((xs ** 2 + ys ** 2) <= radius ** 2, dtype=dtype)
    aliased /= aliased.sum()
    return cv.gaussian_blur(aliased, ksize, alias_blur)


def defocus_blur(x, severity, rng):
    c = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)][severity - 1]
    x = _as_float(x)
    kernel = _disk(radius=c[0], alias_blur=c[1])
    return _to_uint8(cv.filter2d(x, kernel))


def gaussian_blur(x, severity, rng):
    c = [1, 2, 3, 4, 6][severity - 1]
    x = _as_float(x)
    return _to_uint8(ndi.gaussian_filter(x, sigma=(c, c, 0)))


def glass_blur(x, severity, rng):
    c = [(0.7, 1, 2), (0.9, 2, 1), (1, 2, 3), (1.1, 3, 2),
         (1.5, 4, 2)][severity - 1]
    sigma, max_delta, iters = c
    x = np.uint8(ndi.gaussian_filter(_as_float(x), sigma=(sigma, sigma, 0)) * 255)
    h, w = x.shape[:2]
    for _ in range(iters):
        dy = rng.randint(-max_delta, max_delta + 1, (h, w))
        dx = rng.randint(-max_delta, max_delta + 1, (h, w))
        yy = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
        xx = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        x = x[yy, xx]
    return _to_uint8(ndi.gaussian_filter(x / 255.0, sigma=(sigma, sigma, 0)))


def _motion_kernel(radius, sigma, angle):
    """The JAX suite's line kernel: Gaussian weights along ``angle``."""
    k = 2 * radius + 1
    kern = np.zeros((k, k), np.float32)
    ts = np.arange(-radius, radius + 1, dtype=np.float32)
    weights = np.exp(-(ts ** 2) / (2 * sigma ** 2))
    rad = np.deg2rad(angle)
    for t, wgt in zip(ts, weights):
        px = int(round(radius + t * np.cos(rad)))
        py = int(round(radius + t * np.sin(rad)))
        if 0 <= px < k and 0 <= py < k:
            kern[py, px] += wgt
    kern /= kern.sum()
    return kern


def motion_blur(x, severity, rng):
    c = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)][severity - 1]
    x = _as_float(x)
    angle = rng.uniform(-45, 45)
    return _to_uint8(cv.filter2d(x, _motion_kernel(c[0], c[1], angle)))


def _clipped_zoom(img, zoom):
    h, w = img.shape[:2]
    ch, cw = int(np.ceil(h / zoom)), int(np.ceil(w / zoom))
    top = (h - ch) // 2
    left = (w - cw) // 2
    crop = img[top:top + ch, left:left + cw]
    return cv.resize(crop, (w, h), cv.INTER_LINEAR)


def zoom_blur(x, severity, rng):
    c = [np.arange(1, 1.11, 0.01), np.arange(1, 1.16, 0.01),
         np.arange(1, 1.21, 0.02), np.arange(1, 1.26, 0.02),
         np.arange(1, 1.31, 0.03)][severity - 1]
    x = _as_float(x)
    out = np.zeros_like(x)
    for zoom in c:
        out += _clipped_zoom(x, zoom)
    return _to_uint8((x + out) / (len(c) + 1))


# -------------------------------------------------------------- weather ----

def _plasma_fractal(rng, mapsize=512, wibbledecay=3):
    """Diamond-square fractal in [0, 1] (ImageNet-C's fog heightmap)."""
    assert mapsize & (mapsize - 1) == 0
    maparray = np.empty((mapsize, mapsize), dtype=np.float64)
    maparray[0, 0] = 0
    stepsize = mapsize
    wibble = 100.0

    def wibbledmean(array):
        return array / 4 + rng.uniform(-wibble, wibble, array.shape)

    def fillsquares():
        cornerref = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        squareaccum = (cornerref + np.roll(cornerref, 1, axis=0)
                       + np.roll(cornerref, 1, axis=1)
                       + np.roll(np.roll(cornerref, 1, axis=0), 1, axis=1))
        maparray[stepsize // 2:mapsize:stepsize,
                 stepsize // 2:mapsize:stepsize] = wibbledmean(squareaccum)

    def filldiamonds():
        drgrid = maparray[stepsize // 2:mapsize:stepsize, stepsize // 2:mapsize:stepsize]
        ulgrid = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        ldrsum = drgrid + np.roll(drgrid, 1, axis=0)
        lulsum = ulgrid + np.roll(ulgrid, -1, axis=1)
        maparray[0:mapsize:stepsize, stepsize // 2:mapsize:stepsize] = wibbledmean(ldrsum + lulsum)
        tdrsum = drgrid + np.roll(drgrid, 1, axis=1)
        tulsum = ulgrid + np.roll(ulgrid, -1, axis=0)
        maparray[stepsize // 2:mapsize:stepsize, 0:mapsize:stepsize] = wibbledmean(tdrsum + tulsum)

    while stepsize >= 2:
        fillsquares()
        filldiamonds()
        stepsize //= 2
        wibble /= wibbledecay

    maparray -= maparray.min()
    return maparray / maparray.max()


def fog(x, severity, rng):
    c = [(1.5, 2), (2., 2), (2.5, 1.7), (2.5, 1.5), (3., 1.4)][severity - 1]
    x = _as_float(x)
    h, w = x.shape[:2]
    size = 1 << int(np.ceil(np.log2(max(h, w))))
    max_val = x.max()
    fog_layer = c[0] * _plasma_fractal(rng, mapsize=size, wibbledecay=c[1])[:h, :w][..., None]
    return _to_uint8((x + fog_layer) * max_val / (max_val + c[0]))


def _frost_texture(h, w, seed=0):
    """Procedural frost: multi-octave seeded value noise sharpened into
    crystalline streaks (the JAX suite's stand-in for the frost photos)."""
    rng = np.random.RandomState(seed)
    acc = np.zeros((h, w), np.float32)
    for octave in range(3):
        s = 2 ** (octave + 4)
        grid = rng.rand(h // s + 2, w // s + 2).astype(np.float32)
        acc += cv.resize(grid, (w, h), cv.INTER_CUBIC) / (octave + 1)
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-8)
    streaks = cv.gaussian_blur((acc > 0.55).astype(np.float32), (0, 0), 1.5)
    tex = np.clip(0.6 * acc + 0.7 * streaks, 0, 1)
    return np.stack([tex] * 3, -1)


def frost(x, severity, rng):
    c = [(1, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)][severity - 1]
    x = _as_float(x)
    h, w = x.shape[:2]
    tex = _frost_texture(h, w, seed=rng.randint(1 << 16))
    return _to_uint8(c[0] * x + c[1] * tex)


def snow(x, severity, rng):
    c = [(0.1, 0.3, 3, 0.5, 10, 4, 0.8),
         (0.2, 0.3, 2, 0.5, 12, 4, 0.7),
         (0.55, 0.3, 4, 0.9, 12, 8, 0.7),
         (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
         (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55)][severity - 1]
    x = _as_float(x)
    h, w = x.shape[:2]
    snow_layer = rng.normal(size=(h, w), loc=c[0], scale=c[1])
    snow_layer = _clipped_zoom(snow_layer, c[2])
    snow_layer[snow_layer < c[3]] = 0
    kern = _motion_kernel(c[4], c[5], rng.uniform(-135, -45))
    snow_layer = cv.filter2d(np.clip(snow_layer, 0, 1), kern)[..., None]
    gray = cv.bgr2gray(np.uint8(x * 255)) / 255.0
    x = c[6] * x + (1 - c[6]) * np.maximum(x, gray[..., None] * 1.5 + 0.5)
    return _to_uint8(x + snow_layer + np.rot90(snow_layer, k=2))


def spatter(x, severity, rng):
    c = [(0.65, 0.3, 4, 0.69, 0.6, 0),
         (0.65, 0.3, 3, 0.68, 0.6, 0),
         (0.65, 0.3, 2, 0.68, 0.5, 0),
         (0.65, 0.3, 1, 0.65, 1.5, 1),
         (0.67, 0.4, 1, 0.65, 1.5, 1)][severity - 1]
    x = _as_float(x)
    liquid = rng.normal(size=x.shape[:2], loc=c[0], scale=c[1])
    liquid = ndi.gaussian_filter(liquid, sigma=c[2])
    liquid[liquid < c[3]] = 0
    if c[5] == 0:                  # water droplets (edge-distance shading)
        liquid_u8 = (np.clip(liquid, 0, 1) * 255).astype(np.uint8)
        dist = 255 - cv.canny(liquid_u8, 50, 150)
        dist = cv.distance_transform(dist)
        dist = np.clip(cv.box_blur(dist, (3, 3)), 0, 20) / 20.0
        m = ndi.gaussian_filter((liquid_u8 / 255.0) * dist, sigma=c[4])
        m = np.clip(m * 2.0, 0, 1)
        water = np.stack([0.65 * np.ones_like(m), 0.7 * np.ones_like(m),
                          0.8 * np.ones_like(m)], -1) * m[..., None]
        return _to_uint8(np.clip(x * (1 - 0.6 * m[..., None]) + water, 0, 1))
    m = np.where(liquid > c[3], 1.0, 0.0)        # mud
    m = ndi.gaussian_filter(m, sigma=c[4])
    m[m < 0.8] = 0
    mud = (np.stack([63 / 255. * np.ones_like(m), 42 / 255. * np.ones_like(m),
                     20 / 255. * np.ones_like(m)], -1) * m[..., None])
    return _to_uint8(x * (1 - m[..., None]) + mud)


# -------------------------------------------------------------- digital ----

def brightness(x, severity, rng):
    c = [.1, .2, .3, .4, .5][severity - 1]
    x = _as_float(x)
    hsv = cv.bgr2hsv(np.uint8(x * 255)).astype(np.float32)
    hsv[..., 2] = np.clip(hsv[..., 2] / 255.0 + c, 0, 1) * 255.0
    return cv.hsv2bgr(hsv.astype(np.uint8))


def saturate(x, severity, rng):
    c = [(0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2)][severity - 1]
    x = _as_float(x)
    hsv = cv.bgr2hsv(np.uint8(x * 255)).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] / 255.0 * c[0] + c[1], 0, 1) * 255.0
    return cv.hsv2bgr(hsv.astype(np.uint8))


def contrast(x, severity, rng):
    c = [0.4, .3, .2, .1, .05][severity - 1]
    x = _as_float(x)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return _to_uint8((x - mean) * c + mean)


def elastic_transform(x, severity, rng):
    h, w = x.shape[:2]
    shape_size = (h, w)
    sz = min(h, w)
    c = [(sz * 2, sz * 0.7, sz * 0.1),
         (sz * 2, sz * 0.08, sz * 0.2),
         (sz * 0.05, sz * 0.01, sz * 0.02),
         (sz * 0.07, sz * 0.01, sz * 0.02),
         (sz * 0.12, sz * 0.01, sz * 0.02)][severity - 1]
    image = np.asarray(x, np.float32) / 255.0
    center = np.float32(shape_size) // 2              # random affine jitter
    sq_size = min(shape_size) // 3
    pts1 = np.float32([center + sq_size,
                       [center[0] + sq_size, center[1] - sq_size],
                       center - sq_size])
    pts2 = pts1 + rng.uniform(-c[2], c[2], size=pts1.shape).astype(np.float32)
    image = cv.warp_affine(image, cv.get_affine_transform(pts1, pts2), (w, h))
    dx = (ndi.gaussian_filter(rng.uniform(-1, 1, size=shape_size),
                              c[1], mode="reflect") * c[0]).astype(np.float32)
    dy = (ndi.gaussian_filter(rng.uniform(-1, 1, size=shape_size),
                              c[1], mode="reflect") * c[0]).astype(np.float32)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    return _to_uint8(cv.remap(image, np.float32(xx + dx), np.float32(yy + dy)))


def pixelate(x, severity, rng):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = x.shape[:2]
    small = cv.resize(x, (int(w * c), int(h * c)), cv.INTER_AREA)
    return cv.resize(small, (w, h), cv.INTER_NEAREST)


def jpeg_compression(x, severity, rng):
    return cv.jpeg_roundtrip(x, [25, 18, 15, 10, 7][severity - 1])


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise, "shot_noise": shot_noise,
    "impulse_noise": impulse_noise, "defocus_blur": defocus_blur,
    "glass_blur": glass_blur, "motion_blur": motion_blur,
    "zoom_blur": zoom_blur, "snow": snow, "frost": frost, "fog": fog,
    "brightness": brightness, "contrast": contrast,
    "elastic_transform": elastic_transform, "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "speckle_noise": speckle_noise, "gaussian_blur": gaussian_blur,
    "spatter": spatter, "saturate": saturate,
}

BENCHMARK_CORRUPTIONS: List[str] = list(CORRUPTIONS)[:15]
HOLDOUT_CORRUPTIONS: List[str] = list(CORRUPTIONS)[15:]


def corrupt_numpy(image: np.ndarray, corruption_name: str, severity: int = 1,
                  rng=None) -> np.ndarray:
    """``imagecorruptions.corrupt``'s contract (uint8 HWC): ``image``
    itself at severity 0; ``rng`` (a ``np.random.RandomState``) or, when
    None, ``np.random`` supplies every draw."""
    if severity == 0:
        return image
    fn = CORRUPTIONS.get(corruption_name)
    if fn is None:
        raise ValueError(f"unknown corruption {corruption_name!r}")
    return np.ascontiguousarray(fn(np.asarray(image, np.uint8), severity,
                                   np.random if rng is None else rng))


def sample_seed(index: int, corruption_name: str, severity: int) -> List[int]:
    """The seed of image ``index`` of a dataset in the (corruption,
    severity) cell, for ``np.random.RandomState``: ``[index, position of the
    corruption in CORRUPTIONS, severity]``. A cell then corrupts the same
    pixels in every run, whatever thread loads the image."""
    return [int(index), list(CORRUPTIONS).index(corruption_name), int(severity)]
