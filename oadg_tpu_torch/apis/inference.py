"""Serving entry points (port of ``oadg_tpu/apis/inference.py:20,38``).

``init_detector`` builds the detector of a config on a device, with seeded
random weights or a ``state_dict`` file; ``DetectorHandle.test`` runs
``simple_test`` on a batch with the contract of
``oadg_tpu/engine/train_step.py:102`` (``img``, ``img_shape``,
``scale_factor``; ``img`` is NCHW here). ``prepare_image`` turns one uint8
BGR image into such a batch: normalize with the config's ``img_norm_cfg``,
pad to a multiple of 32. Resizing from a file belongs to the data layer and
is not ported yet.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..config import load_config
from ..models import build_detector


class DetectorHandle:
    """The detector module, its config and device."""

    def __init__(self, model, cfg, device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.num_classes = model.roi_head.bbox_head.num_classes

    def test(self, batch):
        """-> dets (N, max_per_img, 5), labels (N, max_per_img), valid."""
        with torch.inference_mode():
            return self.model.simple_test(batch)


def init_detector(config, checkpoint: Optional[Union[str, os.PathLike]] = None,
                  device: Union[str, torch.device] = "cuda",
                  seed: int = 0, num_views: int = 1, dtype=None) -> DetectorHandle:
    """Build ``config`` (a path or a loaded config) on ``device``;
    ``num_views`` > 1 builds it for OA-DG training on views-major batches;
    ``dtype`` is the compute dtype (``torch.bfloat16``; None is float32,
    see ``build_detector``), the model's ``dtype``.

    Weights come from ``checkpoint`` (a ``torch.save``d ``state_dict``, or a
    dict holding one under ``"state_dict"``, loaded strictly) or, without
    one, from a ``torch.Generator`` seeded with ``seed``. On CUDA the model
    runs in ``torch.channels_last``. A CUDA device without a card raises.
    A serving model (``num_views == 1``) is left in ``eval()`` mode, one
    built for training in ``train()`` mode.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_detector(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if isinstance(config, (str, os.PathLike)):
        config = load_config(config)
    model = build_detector(dict(config["model"]), device=device,
                           num_views=num_views, dtype=dtype)
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        model.load_state_dict(sd, strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    model.train(num_views > 1)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return DetectorHandle(model, config, device)


def prepare_image(img: np.ndarray, cfg, device) -> dict:
    """One (H, W, 3) uint8 BGR image -> a 1-image batch on ``device``:
    ``(img[..., ::-1] if to_rgb - mean) * (1 / std)`` in float32 (the JAX
    package's Normalize), zero-padded to a multiple of 32."""
    norm = dict(cfg["img_norm_cfg"])
    h, w = img.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    if norm.get("to_rgb", True):
        x = x.flip(-1)
    mean = torch.tensor(np.asarray(norm["mean"], np.float32), device=device)
    inv_std = torch.tensor((1.0 / np.asarray(norm["std"], np.float32))
                           .astype(np.float32), device=device)
    x = (x.float() - mean) * inv_std                        # (H, W, 3)
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    canvas = torch.zeros((1, 3, hp, wp), device=device)
    canvas[0, :, :h, :w] = x.permute(2, 0, 1)
    if canvas.is_cuda:
        canvas = canvas.contiguous(memory_format=torch.channels_last)
    return {"img": canvas,
            "img_shape": torch.tensor([[h, w]], dtype=torch.float32, device=device),
            "scale_factor": torch.ones((1, 4), device=device)}
