"""The ``OAMix`` pipeline op (port of ``oadg_tpu/data/pipelines/oa_mix.py:25-107``,
its ``on_device=True`` path).

The op does not augment. It records the OA-Mix configuration and the
reference's field contract on the sample, and the train step runs OA-Mix on
the card over the whole batch (``engine/preprocess.py``,
``ops/oamix_device.py``). It keeps a copy of the pre-``Normalize`` uint8
image as ``img_raw`` and sets ``norm_on_device``, so that ``Normalize``
skips its pixel math, ``DefaultFormatBundle`` keeps uint8 and the loader
ships only the uint8 ``img_raw``. The placeholder views ``img{i}`` /
``gt_bboxes{i}`` and the empty ``multilevel_boxes`` / ``oamix_boxes``
shells ride ``custom_field``, which ``Collect`` keeps.

``keep_orig=False`` (the YOLOv3 OA-DG config's) records that every view is
augmented, the first too: the preprocess then makes all ``num_views`` views
with OA-Mix and keeps no clean one, as the JAX package's host oracle does
(``oadg_tpu/data/pipelines/oa_mix.py:52-58``). ``on_device=False``, the
reference's per-sample host algorithm, raises: it needs the host OA-Mix
oracle, which the port does not have (ROADMAP A, 'Data layer leftovers').
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...utils.registry import PIPELINES


@PIPELINES.register_module()
class OAMix:
    def __init__(self, version: str = "augmix", num_views: int = 2,
                 keep_orig: bool = True, severity: int = 10,
                 mixture_width: int = 3, mixture_depth: int = -1,
                 random_box_scale=(0.01, 0.1), random_box_ratio=(3, 1 / 3),
                 oa_random_box_scale=(0.005, 0.1),
                 oa_random_box_ratio=(3, 1 / 3), num_bboxes=(3, 5),
                 spatial_ratio: int = 4, sigma_ratio: float = 0.3,
                 on_device: bool = True, **kwargs):
        if not on_device:
            raise NotImplementedError("OAMix(on_device=False) runs the host OA-Mix "
                                      "oracle, which the port has not (ROADMAP A, "
                                      "'Data layer leftovers')")
        self.cfg = dict(
            version=version, num_views=num_views, keep_orig=keep_orig,
            severity=severity, mixture_width=mixture_width,
            mixture_depth=mixture_depth, random_box_scale=random_box_scale,
            random_box_ratio=random_box_ratio,
            oa_random_box_scale=oa_random_box_scale,
            oa_random_box_ratio=oa_random_box_ratio, num_bboxes=num_bboxes,
            spatial_ratio=spatial_ratio, sigma_ratio=sigma_ratio)
        self.num_views = num_views
        self.keep_orig = keep_orig

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        results["img_raw"] = np.ascontiguousarray(results["img"])
        results["norm_on_device"] = True
        results["oamix_cfg"] = self.cfg
        results["custom_field"] = ["img_raw", "norm_on_device"]
        results["img_fields"] = ["img"]
        for i in range(2, self.num_views + 1):
            results[f"img{i}"] = results["img"]            # placeholder view
            results[f"gt_bboxes{i}"] = results["gt_bboxes"].copy()
            results["custom_field"] += [f"img{i}", f"gt_bboxes{i}"]
        results.setdefault("multilevel_boxes", np.zeros((0, 4), np.float32))
        results.setdefault("oamix_boxes", np.zeros((0, 4), np.float32))
        results["custom_field"] += ["multilevel_boxes", "oamix_boxes"]
        return results

    def __repr__(self):
        return (f"OAMix(num_views={self.num_views}, keep_orig={self.keep_orig}, "
                "on_device=True)")
