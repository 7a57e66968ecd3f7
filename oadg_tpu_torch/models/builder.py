"""Model builder (port of ``oadg_tpu/models/builder.py``)."""
from __future__ import annotations

import torch

from ..utils.registry import DETECTORS, build_from_cfg


def build_detector(cfg: dict, device="cuda", num_views: int = 1):
    """mmdet-style model config (``cfg.model``) -> detector module on
    ``device`` with uninitialized weights; ``num_views`` is the number of
    views-major chunks a training batch holds (2 for the OA-DG configs).
    Builds on the card unless ``device="cpu"``; a CUDA device without a card
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_detector(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to build on the CPU")
    cfg = dict(cfg)
    cfg.pop("pretrained", None)
    return build_from_cfg(cfg, DETECTORS, dict(device=device, num_views=num_views))
