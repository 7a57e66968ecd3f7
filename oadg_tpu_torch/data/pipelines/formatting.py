"""Formatting pipeline ops, ``Compose`` and the test-time wrapper (port of
``oadg_tpu/data/pipelines/formatting.py``): ``Compose``,
``DefaultFormatBundle``, ``ImageToTensor``, ``Collect`` and
``MultiScaleFlipAug``. Images stay numpy HWC, as in the JAX package; the
loader stacks them and the test step views the batch as NCHW on the card
(``engine/train_step.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from ...utils.registry import PIPELINES, build_from_cfg


@PIPELINES.register_module()
class Compose:
    """Apply ``transforms`` (configs or callables) in order; a transform
    that returns None ends the chain with None."""

    def __init__(self, transforms: Sequence):
        self.transforms = [build_from_cfg(dict(t), PIPELINES) if isinstance(t, dict)
                           else t for t in transforms]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """Images to contiguous float32 HWC (a 2-D image gets a channel axis;
    under ``norm_on_device`` they stay uint8 for the card's preprocess),
    boxes to float32 (n, 4), labels to int64; box-cropped ``gt_masks`` pass
    as they are, as in the JAX package."""

    def __init__(self, img_to_float: bool = True, pad_val=None):
        self.img_to_float = img_to_float

    def __call__(self, results: Dict[str, Any]):
        for key in results.get("img_fields", ["img"]):
            img = results[key]
            if (self.img_to_float and img.dtype != np.float32
                    and not results.get("norm_on_device")):
                img = img.astype(np.float32)
            if img.ndim == 2:
                img = img[..., None]
            results[key] = np.ascontiguousarray(img)
        for key in ("gt_bboxes", "gt_bboxes_ignore"):
            if key in results:
                results[key] = results[key].astype(np.float32).reshape(-1, 4)
        if "gt_labels" in results:
            results["gt_labels"] = np.asarray(results["gt_labels"], np.int64)
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """``keys`` to contiguous HWC arrays (``formatting.py:68-78`` keeps HWC;
    the reference's CHW transpose happens on the card)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            img = results[key]
            if img.ndim == 2:
                img = img[..., None]
            results[key] = np.ascontiguousarray(img)
        return results


@PIPELINES.register_module()
class Collect:
    """``{'img_metas': {meta_keys present}, key: results[key] for keys}``,
    every key of ``results['custom_field']`` and ``oamix_cfg`` (``OAMix``'s
    fields)."""

    META_KEYS = ("filename", "ori_filename", "ori_shape", "img_shape",
                 "pad_shape", "scale_factor", "flip", "flip_direction",
                 "img_norm_cfg")

    def __init__(self, keys, meta_keys=META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results: Dict[str, Any]):
        data = {"img_metas": {k: results[k] for k in self.meta_keys if k in results}}
        for key in self.keys:
            if key in results:
                data[key] = results[key]
        for key in results.get("custom_field", []):
            if key not in data and key in results:
                data[key] = results[key]
        if "oamix_cfg" in results:
            data["oamix_cfg"] = results["oamix_cfg"]
        return data


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time wrapper (``test_time_aug.py:11`` of mmdet): one pipeline
    output per (scale, flip) combination. One combination is returned as
    it is; several are merged into one dict of lists marked ``__tta__``,
    which the port's loader refuses (test-time augmentation is ROADMAP A,
    'Test-time paths of the flagship')."""

    def __init__(self, transforms, img_scale=None, scale_factor=None,
                 flip: bool = False, flip_direction="horizontal"):
        self.transforms = Compose(transforms)
        if img_scale is not None:
            self.img_scale = (img_scale if isinstance(img_scale, list)
                              else [img_scale])
        else:
            self.img_scale = [scale_factor]
        self.flip = flip
        self.flip_direction = (flip_direction if isinstance(flip_direction, list)
                               else [flip_direction])

    def __call__(self, results):
        aug_data = []
        flips = [False] + ([True] if self.flip else [])
        for scale in self.img_scale:
            for f in flips:
                for d in (self.flip_direction if f else ["horizontal"]):
                    _results = dict(results)
                    _results["scale"] = tuple(scale)
                    _results["flip"] = f
                    _results["flip_direction"] = d
                    aug_data.append(self.transforms(_results))
        if len(aug_data) == 1:
            return aug_data[0]
        merged = {k: [d[k] for d in aug_data] for k in aug_data[0]}
        merged["__tta__"] = True
        return merged
