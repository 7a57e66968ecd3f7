"""Model builder (port of ``oadg_tpu/models/builder.py``)."""
from __future__ import annotations

import torch

from ..utils.registry import DETECTORS, build_from_cfg

# Detector types whose JAX counterpart cannot run, so there is no reference
# to hold a port to (ROADMAP C).
REFUSED = {
    "TridentFasterRCNN": (
        "TridentFasterRCNN is refused (the port builds only the ported slices' types): the "
        "JAX detector raises in forward_train and in simple_test. Its TridentResNet folds the "
        "three branches onto the batch, and the detector never tiles the gts to match nor "
        "picks the test branch (mode='test'); its output is at stride 32 with 2048 channels, "
        "not the config's stride 16. TridentResNet and TridentRoIHead are ported alone"),
}


def build_detector(cfg: dict, device="cuda", num_views: int = 1, dtype=None):
    """mmdet-style model config (``cfg.model``) -> detector module on
    ``device`` with uninitialized weights; ``num_views`` is the number of
    views-major chunks a training batch holds (2 for the OA-DG configs).
    ``dtype`` is the compute dtype (``torch.bfloat16``, or None and
    ``torch.float32`` for float32), as ``oadg_tpu``'s ``build_detector(...,
    dtype=jnp.bfloat16)``: parameters stay float32, convolutions and FCs
    compute in ``dtype``. Builds on the card unless ``device="cpu"``; a CUDA
    device without a card raises. A bfloat16 model on the CPU computes in
    bfloat16 there. Building on the card turns TF32 off for cuDNN
    convolutions and matmuls (process-wide flags; PyTorch's default lets cuDNN
    use TF32), so that what computes in float32 does so in float32. A type in
    ``REFUSED`` raises ``ValueError`` with its reason."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_detector(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to build on the CPU")
    cfg = dict(cfg)
    cfg.pop("pretrained", None)
    if cfg.get("type") in REFUSED:
        raise ValueError(REFUSED[cfg["type"]])
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {dtype}: the port computes in float32 or bfloat16")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return build_from_cfg(cfg, DETECTORS, dict(device=device, num_views=num_views,
                                               dtype=dtype))
