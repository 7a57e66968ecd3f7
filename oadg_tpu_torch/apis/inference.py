"""Serving entry points (port of ``oadg_tpu/apis/inference.py``).

``init_detector`` builds the detector of a config on a device, with seeded
random weights or a ``state_dict`` file; ``DetectorHandle.test`` runs
``simple_test`` on a batch with the contract of
``oadg_tpu/engine/train_step.py:102`` (``img``, ``img_shape``,
``scale_factor``; ``img`` is NCHW here). ``prepare_image`` turns one uint8
BGR image into such a batch on the card: normalize with the config's
``img_norm_cfg``, pad to a multiple of 32. ``prepare_batch`` and
``inference_detector`` take an image file or array through the config's
test pipeline instead (resize included), as the JAX package's do;
``async_inference_detector`` enqueues every image on the card before it
awaits any result.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..config import load_config
from ..models import build_detector


class DetectorHandle:
    """The detector module, its config and device; ``num_classes`` is its box
    head's (a single-stage model's ``bbox_head``, a two-stage one's
    ``roi_head``'s: the last stage's of a cascade), ``CLASSES`` the class names of the config's test
    dataset type (None without one)."""

    def __init__(self, model, cfg, device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        head = model.bbox_head if hasattr(model, "bbox_head") else model.roi_head
        self.num_classes = head.num_classes
        self.CLASSES = _classes_from_cfg(cfg)
        self.checkpoint_report = None   # load_mmdet_checkpoint's, set by init_detector
        self._pipeline = None       # the test pipeline, built on first use

    def test(self, batch):
        """-> dets (N, max_per_img, 5), labels (N, max_per_img), valid; a
        Mask R-CNN adds masks (N, max_per_img, 28, 28), each detection's mask
        probabilities at its class in its box (``paste_masks`` draws them
        into the image). SOLO returns masks (N, max_per_img, H, W) bool at
        its level-0 mask size, labels and scores, YOLACT dets, labels, valid
        and each detection's prototype coefficients, PanopticFPN the pair
        ``((dets, labels, valid), stuff probabilities (N, h, w, K))``, as
        the JAX detectors do."""
        with torch.inference_mode():
            return self.model.simple_test(batch)


def init_detector(config, checkpoint: Optional[Union[str, os.PathLike]] = None,
                  device: Union[str, torch.device] = "cuda",
                  seed: int = 0, num_views: int = 1, dtype=None) -> DetectorHandle:
    """Build ``config`` (a path or a loaded config) on ``device``;
    ``num_views`` > 1 builds it for OA-DG training on views-major batches;
    ``dtype`` is the compute dtype (``torch.bfloat16``; None is float32,
    see ``build_detector``), the model's ``dtype``.

    The weights are seeded (a ``torch.Generator`` seeded with ``seed``),
    then ``checkpoint``'s (a file: a published mmdet ``.pth``, one of the
    port's ``epoch_{n}.pth``, or a bare ``state_dict``) are grafted on by
    ``load_mmdet_checkpoint``, which logs what it skipped and raises where
    a detector checkpoint lacks one of the model's tensors (a
    classification checkpoint fills the backbone alone); its report is the
    handle's ``checkpoint_report``. On CUDA the model
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
    model.init_weights(torch.Generator().manual_seed(seed))
    report = None
    if checkpoint is not None:
        from ..engine.runner import get_root_logger
        from ..utils.checkpoint import load_mmdet_checkpoint
        report = load_mmdet_checkpoint(model, checkpoint, get_root_logger())
    model.train(num_views > 1)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    handle = DetectorHandle(model, config, device)
    handle.checkpoint_report = report
    return handle


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


def _num_classes(cfg) -> int:
    """The number of classes of the config's box head (of a cascade's box
    heads, which must agree)."""
    m = dict(cfg["model"])
    rh = dict(m.get("roi_head") or {})
    if rh.get("bbox_head"):
        heads = rh["bbox_head"]
        counts = {int(dict(h).get("num_classes", 80))
                  for h in (heads if isinstance(heads, (list, tuple)) else [heads])}
        if len(counts) != 1:
            raise ValueError(f"the cascade's box heads disagree on num_classes: {sorted(counts)}")
        return counts.pop()
    return int(dict(m.get("bbox_head") or {}).get("num_classes", 80))


def _test_set(cfg):
    """The config's test set; of a list of them (the DWD config's five
    weather domains, one class list and one pipeline) the first."""
    test = (cfg.get("data") or {}).get("test")
    return test[0] if isinstance(test, (list, tuple)) and test else test


def _classes_from_cfg(cfg):
    test = _test_set(cfg)
    if not test:
        return None
    from ..utils.registry import DATASETS
    from .. import data  # noqa: F401  (registers the dataset types)
    return getattr(DATASETS.get(dict(test).get("type")), "CLASSES", None)


def _test_pipeline(cfg):
    """The config's test pipeline, reading the caller's array in place of
    the image file."""
    from ..data.pipelines import Compose
    pipeline = list(_test_set(cfg)["pipeline"])
    if pipeline and pipeline[0].get("type") == "LoadImageFromFile":
        pipeline[0] = dict(type="LoadImageFromWebcam")
    return Compose(pipeline)


def prepare_batch(model: DetectorHandle, img, pipeline=None) -> dict:
    """An image file or an (H, W, 3) uint8 BGR array -> a 1-image batch on
    the model's device through the config's test pipeline (built once and
    cached on the handle), padded to a multiple of 32; ``img_shape`` is the
    padded shape, as in the JAX package's ``prepare_batch``."""
    from ..data.pipelines.image_io import imread
    from ..engine.train_step import upload_test_batch
    if pipeline is None:
        if model._pipeline is None:
            model._pipeline = _test_pipeline(model.cfg)
        pipeline = model._pipeline
    arr = imread(img) if isinstance(img, (str, os.PathLike)) else np.asarray(img)
    data = pipeline(dict(img=arr.copy(), img_info=dict(filename=None), img_prefix=None))
    im = data["img"]
    h, w = im.shape[:2]
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    canvas = np.zeros((1, hp, wp, 3), np.float32)
    canvas[0, :h, :w] = im
    return upload_test_batch({
        "img": canvas,
        "img_shape": np.asarray([[h, w]], np.float32),
        "scale_factor": np.asarray(data["img_metas"].get("scale_factor", [1, 1, 1, 1]),
                                   np.float32).reshape(1, -1)[:, :4]}, model.device)


def inference_detector(model: DetectorHandle, imgs) -> list:
    """Detect on image file(s) or array(s) -> per-class (n, 5) arrays per
    image (one image in, one result out); SOLO, YOLACT and PanopticFPN raise
    (``refuse_instance_outputs``)."""
    from .test import dets_to_results, fetch_dets, refuse_instance_outputs
    refuse_instance_outputs(model.model)
    single = not isinstance(imgs, (list, tuple))
    results = [dets_to_results(*fetch_dets(*model.test(prepare_batch(model, img))),
                               model.num_classes)[0]
               for img in ([imgs] if single else imgs)]
    return results[0] if single else results


async def async_inference_detector(model: DetectorHandle, imgs) -> list:
    """``inference_detector`` for an event loop (``oadg_tpu/apis/inference.py:158-182``):
    every image goes through the test pipeline and is enqueued on the
    model's device before any result is awaited; each result's
    device-to-host copy, which waits for its request, runs in the loop's
    default executor, so that the loop stays free meanwhile."""
    import asyncio

    from .test import dets_to_results, fetch_dets, refuse_instance_outputs
    refuse_instance_outputs(model.model)
    single = not isinstance(imgs, (list, tuple))
    outs = [model.test(prepare_batch(model, img)) for img in ([imgs] if single else imgs)]
    loop = asyncio.get_running_loop()
    results = []
    for out in outs:
        host = await loop.run_in_executor(None, fetch_dets, *out)
        results.append(dets_to_results(*host, model.num_classes)[0])
    return results[0] if single else results
