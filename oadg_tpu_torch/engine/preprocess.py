"""On-device OA-Mix and multi-view integration of a training batch (port of
``oadg_tpu/engine/preprocess.py:23-96``).

``make_oadg_preprocess(oamix_cfg, img_norm_cfg, chain=None)`` returns
``preprocess(batch, generator, draws=None)``; ``chain`` picks OA-Mix's chain
(``"slots"`` or ``"merged"``; None reads ``OAMIX_CHAIN`` at each call). The batch holds ``img_raw`` (B, H, W, 3) uint8 BGR
on the device, ``gt_bboxes``, ``gt_labels``, ``gt_valid`` and ``img_shape``
(B, 2) on the host (OA-Mix draws its random boxes from it). The result is
the views-major batch ``[B clean; B aug 1; ...]`` that ``forward_train``
takes: ``img`` (N, 3, H, W) float32 (BGR -> RGB, ``(x - mean) / std``; the
channels-last permutation of the NHWC result), gts, ``img_shape`` and
``scale_factor`` tiled over the views, and the OA-Mix boxes. ``draws`` hands
OA-Mix a draw table instead of drawing one from ``generator``;
``preprocess.draws`` keeps the table of the last call. ``img_raw`` may also
be float32 (OA-Mix clamps it to uint8). Where the batch also holds ``img``,
a host-normalized (B, H, W, 3) clean view, that is the clean view (cast to
``out_dtype``) and ``img_raw`` feeds OA-Mix alone, as in the reference
(``oadg_tpu/engine/preprocess.py:62-73``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops.oamix_device import oamix_batch
from ..utils.draws import host_generator


def make_oadg_preprocess(oamix_cfg: Dict[str, Any], img_norm_cfg: Dict[str, Any],
                         out_dtype: Optional[torch.dtype] = None,
                         chain: Optional[str] = None) -> Callable:
    """-> ``preprocess(batch, generator, draws=None)``; ``out_dtype`` casts
    the integrated images after the float32 normalization (None keeps
    float32): pass the model's ``dtype``, as ``oadg_tpu/apis/train.py:86-91``
    does (a bfloat16 model casts its input at the first conv anyway, so this
    halves the bytes of the image stack and changes no result); ``chain``
    goes to ``oamix_batch``."""
    mean = np.asarray(img_norm_cfg.get("mean", [123.675, 116.28, 103.53]), np.float32)
    std = np.asarray(img_norm_cfg.get("std", [58.395, 57.12, 57.375]), np.float32)
    to_rgb = bool(img_norm_cfg.get("to_rgb", True))
    num_views = int(oamix_cfg.get("num_views", 2))
    cfg = dict(oamix_cfg)
    consts = {}                                   # device -> (mean, std)

    def normalize(x):
        x = x.flip(-1) if to_rgb else x
        if x.device not in consts:
            consts[x.device] = tuple(torch.from_numpy(v).to(x.device) for v in (mean, std))
        m, s = consts[x.device]
        x = (x - m) / s
        return x if out_dtype is None else x.to(out_dtype)

    def preprocess(batch: Dict[str, torch.Tensor], generator: torch.Generator,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        raw = batch["img_raw"]
        dev = raw.device
        shape_host = batch["img_shape"]
        if isinstance(shape_host, torch.Tensor) and shape_host.device.type != "cpu":
            raise ValueError("preprocess draws from the host copy of img_shape; "
                             "pass batch['img_shape'] on the CPU")
        shape_host = np.asarray(shape_host, np.float32)
        out = oamix_batch(raw, batch["gt_bboxes"], batch["gt_valid"], shape_host, cfg,
                          draws=draws,
                          generator=None if draws is not None else host_generator(generator),
                          chain=chain)
        preprocess.draws = out["draws"]
        aug = normalize(out["aug"].float())                   # (B, V-1, H, W, 3)
        if "img" in batch:                            # host-normalized clean view
            clean = batch["img"]
            clean = clean if out_dtype is None else clean.to(out_dtype)
        else:
            clean = normalize(raw.float())
        b = raw.shape[0]
        tile = lambda x: torch.cat([x] * num_views, 0)
        imgs = torch.cat([clean] + [aug[:, v] for v in range(aug.shape[1])], 0)
        scale_factor = batch.get("scale_factor", torch.ones((b, 4), device=dev))
        return {
            "img": imgs.permute(0, 3, 1, 2),
            "gt_bboxes": tile(batch["gt_bboxes"]),
            "gt_labels": tile(batch["gt_labels"]),
            "gt_valid": tile(batch["gt_valid"]),
            "img_shape": tile(torch.from_numpy(shape_host).to(dev, non_blocking=True)),
            "scale_factor": tile(scale_factor),
            "multilevel_boxes": tile(out["multilevel_boxes"]),
            "multilevel_valid": tile(out["multilevel_valid"]),
            "oamix_boxes": tile(out["oamix_boxes"]),
            "oamix_valid": tile(out["oamix_valid"]),
        }

    preprocess.draws = None
    return preprocess
