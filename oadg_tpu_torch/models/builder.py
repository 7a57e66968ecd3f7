"""Model builder (port of ``oadg_tpu/models/builder.py``)."""
from __future__ import annotations

from ..utils.registry import DETECTORS, build_from_cfg


def build_detector(cfg: dict, device=None, num_views: int = 1):
    """mmdet-style model config (``cfg.model``) -> detector module on
    ``device`` with uninitialized weights; ``num_views`` is the number of
    views-major chunks a training batch holds (2 for the OA-DG configs)."""
    cfg = dict(cfg)
    cfg.pop("pretrained", None)
    return build_from_cfg(cfg, DETECTORS, dict(device=device, num_views=num_views))
