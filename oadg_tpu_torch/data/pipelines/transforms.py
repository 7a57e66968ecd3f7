"""Geometric and normalization pipeline ops of the test and train paths (port of
``oadg_tpu/data/pipelines/transforms.py:26-208``): ``Resize``, ``RandomFlip``,
``Normalize``, ``Pad``, the robustness benchmark's ``Corrupt``, and the
SSD-style ops of the YOLOv3 config (``:214-364``): ``PhotoMetricDistortion``,
``Expand`` and ``MinIoURandomCrop``. numpy on the host; ``Resize``,
``RandomFlip``, ``Normalize`` and ``Pad`` loop over
``results['img_fields']``, the others take ``results['img']`` as the JAX
package's do.

Every random op draws from numpy's global generator in the JAX package's
order, so that ``np.random.seed(s)`` before the JAX op and before the
port's gives equal results.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``: for uint8
``resize_bilinear`` computes the same image without OpenCV, by cv2's
fixed-point arithmetic (see there); for float32 (the YOLOv3 pipeline loads
``to_float32``) ``ops.cv_host.resize``, OpenCV 5's fused float lerps. The
HSV round trip of ``PhotoMetricDistortion`` is ``ops.cv_host``'s
``bgr2hsv`` / ``hsv2bgr``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...utils.registry import PIPELINES

_COEF_SCALE = 2048          # cv2's INTER_RESIZE_COEF_SCALE: 11-bit coefficients


def _taps(dst: int, scale: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the first source index and the two 11-bit weights,
    as cv2 computes them (``fx = (float)((dx + 0.5) * scale - 0.5)``, the
    floor, ``saturate_cast<short>((1 - fx) * 2048)``, round half to even)."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return s, w0, w1


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` of an (H, W)
    or (H, W, C) uint8 image, ``size`` = (width, height), in numpy. As from
    cv2, a one-channel image comes back (h, w).

    cv2's path for uint8: the same size is a copy; exactly half the size in
    both axes averages 2x2 blocks, ``(a + b + c + d + 2) >> 2``; any other
    size takes 11-bit coefficients, a horizontal pass in int32
    (``S[sx] * a0 + S[sx + 1] * a1``; a tap left of the image or at its last
    column takes weight 2048 on the edge pixel) and a vertical pass on rows
    clamped to the image, rounded as cv2's vectorised loop rounds:
    ``(((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2``.
    """
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear takes uint8 images, not {img.dtype}")
    x = img.reshape(sh, sw, -1)
    shape = (dh, dw) if x.shape[2] == 1 else (dh, dw, x.shape[2])
    if (dw, dh) == (sw, sh):
        return x.reshape(shape).copy()
    x = x.astype(np.int32)
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)
    if scale_x == 2.0 and scale_y == 2.0:
        rows, cols = slice(0, 2 * dh, 2), slice(0, 2 * dw, 2)
        rows1, cols1 = slice(1, 2 * dh, 2), slice(1, 2 * dw, 2)
        out = (x[rows, cols] + x[rows, cols1] + x[rows1, cols] + x[rows1, cols1] + 2) >> 2
        return out.astype(np.uint8).reshape(shape)
    sx, a0, a1 = _taps(dw, scale_x)
    edge = (sx < 0) | (sx >= sw - 1)
    sx = np.clip(sx, 0, sw - 1)
    a0[edge], a1[edge] = _COEF_SCALE, 0
    horiz = (x[:, sx] * a0[None, :, None]
             + x[:, np.minimum(sx + 1, sw - 1)] * a1[None, :, None])
    sy, b0, b1 = _taps(dh, scale_y)
    s0 = horiz[np.clip(sy, 0, sh - 1)] >> 4
    s1 = horiz[np.clip(sy + 1, 0, sh - 1)] >> 4
    out = (((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(shape)


def imrescale(img: np.ndarray, scale: Tuple[int, int]):
    """mmcv's ``imrescale``: resize keeping the aspect ratio so that the
    image fits (max(scale), min(scale)) -> (image, scale factor)."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return resize_image(img, (new_w, new_h)), scale_factor


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``, ``size`` =
    (width, height): uint8 by ``resize_bilinear``, float32 / float64 by
    ``ops.cv_host.resize``."""
    if img.dtype == np.uint8:
        return resize_bilinear(img, size)
    from ...ops.cv_host import INTER_LINEAR, resize
    return resize(img, size, INTER_LINEAR)


@PIPELINES.register_module()
class Resize:
    """Resize to ``results['scale']`` (drawn from ``img_scale`` when absent:
    one scale, a ``ratio_range``, or 'range' / 'value' multiscale), keeping
    the aspect ratio with ``keep_ratio``; boxes are scaled and clipped."""

    def __init__(self, img_scale=None, multiscale_mode: str = "range",
                 ratio_range=None, keep_ratio: bool = True,
                 bbox_clip_border: bool = True, override: bool = False,
                 interpolation="bilinear"):
        if interpolation != "bilinear":
            raise NotImplementedError(f"Resize(interpolation={interpolation!r}): "
                                      "the port resizes bilinearly only")
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.bbox_clip_border = bbox_clip_border

    def _random_scale(self, results):
        if self.ratio_range is not None:
            scale = self.img_scale[0]
            ratio = np.random.uniform(*self.ratio_range)
            results["scale"] = (int(scale[0] * ratio), int(scale[1] * ratio))
        elif len(self.img_scale) == 1:
            results["scale"] = self.img_scale[0]
        elif self.multiscale_mode == "range":
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            long_edge = np.random.randint(min(longs), max(longs) + 1)
            short_edge = np.random.randint(min(shorts), max(shorts) + 1)
            results["scale"] = (long_edge, short_edge)
        else:                                          # 'value'
            idx = np.random.randint(len(self.img_scale))
            results["scale"] = self.img_scale[idx]

    def __call__(self, results: Dict[str, Any]):
        if "scale" not in results:
            self._random_scale(results)
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            if self.keep_ratio:
                img, sf = imrescale(img, results["scale"])
                scale_factor = np.array([sf, sf, sf, sf], np.float32)
            else:
                h, w = img.shape[:2]
                tw, th = max(results["scale"]), min(results["scale"])
                img = resize_image(img, (tw, th))
                scale_factor = np.array([tw / w, th / h, tw / w, th / h],
                                        np.float32)
            results[key] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = scale_factor
        results["keep_ratio"] = self.keep_ratio
        h, w = img.shape[:2]
        for key in results.get("bbox_fields", []):
            bboxes = results[key] * scale_factor
            if self.bbox_clip_border:
                bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w)
                bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h)
            results[key] = bboxes
        return results


@PIPELINES.register_module()
class RandomFlip:
    """Flip images and boxes with probability ``flip_ratio``, or as
    ``results['flip']`` says (test-time augmentation sets it); the
    box-cropped (N, M0, M0) masks of ``mask_fields`` flip within their crop,
    since their boxes flip with the image (``transforms.py:129-133``)."""

    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = "horizontal"):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results: Dict[str, Any]):
        if "flip" not in results:
            flip = (self.flip_ratio is not None
                    and np.random.rand() < self.flip_ratio)
            results["flip"] = flip
            results["flip_direction"] = self.direction
        if results["flip"]:
            for key in results.get("img_fields", ["img"]):
                results[key] = np.ascontiguousarray(
                    results[key][:, ::-1] if results["flip_direction"] ==
                    "horizontal" else results[key][::-1])
            h, w = results["img_shape"][:2]
            for key in results.get("bbox_fields", []):
                b = results[key].copy()
                if results["flip_direction"] == "horizontal":
                    b[..., 0], b[..., 2] = w - results[key][..., 2], \
                        w - results[key][..., 0]
                else:
                    b[..., 1], b[..., 3] = h - results[key][..., 3], \
                        h - results[key][..., 1]
                results[key] = b
            axis = 2 if results["flip_direction"] == "horizontal" else 1
            for key in results.get("mask_fields", []):
                results[key] = np.ascontiguousarray(np.flip(results[key], axis=axis))
        return results


@PIPELINES.register_module()
class Normalize:
    """``(img[..., ::-1] if to_rgb - mean) * (1 / std)`` in float32, in the
    JAX package's order: ``astype``, channel flip, ``-=``, ``*=``. Under
    ``norm_on_device`` (set by ``OAMix``) only ``img_norm_cfg`` is recorded:
    the train step normalizes on the card."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict[str, Any]):
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        if results.get("norm_on_device"):
            return results
        inv_std = (1.0 / self.std).astype(np.float32)
        for key in results.get("img_fields", ["img"]):
            img = results[key].astype(np.float32)
            if self.to_rgb:
                img = img[..., ::-1]
            img -= self.mean
            img *= inv_std
            results[key] = img
        return results


@PIPELINES.register_module()
class Pad:
    """Pad to ``size`` (h, w) or to multiples of ``size_divisor`` with
    ``pad_val``."""

    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_to_square: bool = False, pad_val=0):
        if pad_to_square:
            raise NotImplementedError("Pad(pad_to_square=True) is not ported")
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val if not isinstance(pad_val, dict) else \
            pad_val.get("img", 0)

    def __call__(self, results: Dict[str, Any]):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            h, w = img.shape[:2]
            if self.size is not None:
                th, tw = self.size
            else:
                d = self.size_divisor
                th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
            padded = np.full((th, tw) + img.shape[2:], self.pad_val,
                             img.dtype)
            padded[:h, :w] = img
            results[key] = padded
        results["pad_shape"] = results[key].shape
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register_module()
class Corrupt:
    """On-the-fly corruption of ``results['img']`` (port of
    ``oadg_tpu/data/pipelines/transforms.py:194``) by the port's suite
    (``ops/corruptions.py``). Each image draws from its own
    ``np.random.RandomState(sample_seed(sample_idx, corruption, severity))``,
    where the JAX op draws from numpy's global generator: a
    (corruption, severity) cell then corrupts the same pixels in every run
    and from any loader thread, and ``tools/torch_get_corrupted_dataset.py``
    writes the same images."""

    def __init__(self, corruption: str, severity: int = 1):
        from ...ops.corruptions import CORRUPTIONS
        if corruption not in CORRUPTIONS:
            raise ValueError(f"unknown corruption {corruption!r}")
        self.corruption = corruption
        self.severity = int(severity)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if self.severity == 0:
            return results
        from ...ops.corruptions import corrupt_numpy, sample_seed
        if "sample_idx" not in results:
            raise KeyError("Corrupt seeds each image from its dataset index: the "
                           "results need 'sample_idx' (datasets set it)")
        rng = np.random.RandomState(sample_seed(results["sample_idx"], self.corruption,
                                                self.severity))
        results["img"] = corrupt_numpy(results["img"], self.corruption, self.severity,
                                       rng=rng)
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """SSD-style photometric distortion (``transforms.py:214``): a random
    brightness shift, a random contrast scale before or after (one coin),
    and in HSV a random saturation scale and hue shift, each op taken with
    probability 1/2. float32 out, clipped to [0, 255]."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results: Dict[str, Any]):
        from ...ops.cv_host import bgr2hsv, hsv2bgr
        img = results["img"].astype(np.float32)
        if np.random.randint(2):
            img += np.random.uniform(-self.brightness_delta, self.brightness_delta)
        mode = np.random.randint(2)
        if mode == 1 and np.random.randint(2):
            img *= np.random.uniform(self.contrast_lower, self.contrast_upper)
        hsv = bgr2hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
        if np.random.randint(2):
            hsv[..., 1] *= np.random.uniform(self.saturation_lower, self.saturation_upper)
        if np.random.randint(2):
            hsv[..., 0] = (hsv[..., 0] + np.random.uniform(-self.hue_delta,
                                                           self.hue_delta)) % 180
        img = hsv2bgr(np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        if mode == 0 and np.random.randint(2):
            img *= np.random.uniform(self.contrast_lower, self.contrast_upper)
        results["img"] = np.clip(img, 0, 255)
        return results


@PIPELINES.register_module()
class Expand:
    """Random canvas expansion (``transforms.py:292``): with probability
    ``prob`` the image goes at a random place on a canvas ``ratio`` times
    its size filled with ``mean`` (channel-reversed with ``to_rgb``), the
    boxes shifted with it."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4), prob=0.5):
        self.mean = mean
        self.to_rgb = to_rgb
        self.min_ratio, self.max_ratio = ratio_range
        self.prob = prob

    def __call__(self, results: Dict[str, Any]):
        if np.random.uniform(0, 1) > self.prob:
            return results
        img = results["img"]
        h, w, c = img.shape
        ratio = np.random.uniform(self.min_ratio, self.max_ratio)
        eh, ew = int(h * ratio), int(w * ratio)
        top = int(np.random.uniform(0, eh - h))
        left = int(np.random.uniform(0, ew - w))
        mean = self.mean[::-1] if self.to_rgb else self.mean
        canvas = np.full((eh, ew, c), mean, dtype=img.dtype)
        canvas[top:top + h, left:left + w] = img
        results["img"] = canvas
        results["img_shape"] = canvas.shape
        for key in results.get("bbox_fields", []):
            results[key] = results[key] + np.array([left, top, left, top], np.float32)
        return results


@PIPELINES.register_module()
class MinIoURandomCrop:
    """IoU-constrained random crop (``transforms.py:320``): a mode from
    ``(1, *min_ious, 0)`` (1 keeps the image), then up to 50 crops of at
    least ``min_crop_size`` of each side and an aspect in [0.5, 2] until one
    has IoU >= the mode with every gt and holds a gt centre; the gts whose
    centres it holds are kept, shifted and clipped. A mode with no such
    crop in 50 tries draws another mode."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 bbox_clip_border=True):
        self.min_ious = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.bbox_clip_border = bbox_clip_border

    def __call__(self, results: Dict[str, Any]):
        from ...core.bbox.geometry import bbox_overlaps_np
        img = results["img"]
        h, w = img.shape[:2]
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        while True:
            mode = self.min_ious[np.random.randint(len(self.min_ious))]
            if mode == 1:
                return results
            for _ in range(50):
                new_w = np.random.uniform(self.min_crop_size * w, w)
                new_h = np.random.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = np.random.uniform(w - new_w)
                top = np.random.uniform(h - new_h)
                patch = np.array([int(left), int(top), int(left + new_w), int(top + new_h)])
                if len(boxes):
                    ious = bbox_overlaps_np(boxes, patch[None].astype(np.float32)).reshape(-1)
                    if len(ious) and ious.min() < mode:
                        continue
                    centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                    mask = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                            & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3]))
                    if not mask.any():
                        continue
                else:
                    mask = np.zeros(0, bool)
                for key in results.get("img_fields", ["img"]):
                    results[key] = results[key][patch[1]:patch[3], patch[0]:patch[2]]
                results["img_shape"] = results["img"].shape
                if len(boxes):
                    kept = boxes[mask] - np.tile(patch[:2], 2)
                    if self.bbox_clip_border:
                        kept[:, 0::2] = kept[:, 0::2].clip(0, patch[2] - patch[0])
                        kept[:, 1::2] = kept[:, 1::2].clip(0, patch[3] - patch[1])
                    results["gt_bboxes"] = kept.astype(np.float32)
                    if "gt_labels" in results:
                        results["gt_labels"] = results["gt_labels"][mask]
                return results
