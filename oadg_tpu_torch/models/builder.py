"""Model builder (port of ``oadg_tpu/models/builder.py``)."""
from __future__ import annotations

from ..utils.registry import DETECTORS, build_from_cfg


def build_detector(cfg: dict, device=None):
    """mmdet-style model config (``cfg.model``) -> detector module on
    ``device`` with uninitialized weights."""
    cfg = dict(cfg)
    cfg.pop("pretrained", None)
    return build_from_cfg(cfg, DETECTORS, dict(device=device))
