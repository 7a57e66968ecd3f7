"""The training and test steps (port of ``oadg_tpu/engine/train_step.py``).

``make_train_step``: ``forward_train`` -> backward -> optimizer step -> LR
schedule tick. The counterpart of the JAX package's ``make_train_step(detector, tx,
preprocess=None)`` (``:33``). With ``preprocess`` (``engine/preprocess.py``) the step first
turns a uint8 batch into the views-major one through on-device OA-Mix,
inside a ``train_step: oamix`` span, as the JAX step runs its preprocess
inside the jitted step.

The model's parameters, their gradients and the optimizer are float32
whatever the model's compute ``dtype``: a bfloat16 layer casts its float32
parameters on use, and autograd returns float32 gradients through the cast.
Build the preprocess with ``out_dtype=model.dtype``.

Backward and the optimizer step run inside
``torch.profiler.record_function`` spans (``train_step: backward``,
``train_step: sgd`` whatever the optimizer; under data parallel the
gradients' sum in ``train_step: allreduce``), beside those of
``TwoStageDetector.forward_train``; they cost nothing without a profiler.

``upload_train_batch``: a loader's training batch to the step's tensors on
the card (asynchronous copies from the loader's pinned memory).

``make_test_step``: ``simple_test`` on a loader batch (``:102``), the batch
uploaded to the model's device. ``make_aug_test_step``: ``aug_test`` on the
views of a test-time augmentation batch (``:85-100``), for one tuple of the
views' ``(flip, flip_direction)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..parallel import all_reduce_sum, is_distributed, sharded_batch, sum_gradients
from ..utils.draws import UniformDraws


def parse_losses(losses: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """Sum every entry whose key contains ``loss`` (``:24-30``); the log
    holds every entry and the sum under ``loss``."""
    total = sum(v for k, v in losses.items() if "loss" in k)
    log_vars = dict(losses)
    log_vars["loss"] = total
    return total, log_vars


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    preprocess: Optional[Callable] = None) -> Callable:
    """-> ``step(batch, generator) -> log_vars``, detached tensors.

    The step puts ``model`` in train mode. Every random number of the step
    is drawn from ``generator``: OA-Mix's
    (``preprocess(batch, generator)``, when given) and the samplers'. The step at
    iteration ``t`` (``step.t``, counting from 0) runs with
    ``lr_schedule(t)``; ``step.optimizer`` is ``optimizer``.

    Data parallel (``parallel/dist.py``): under a process group ``batch``
    is this rank's part of the global batch (its images, every view) and
    ``generator`` this rank's. ``forward_train`` runs inside
    ``sharded_batch()``, so the losses are the rank's shares of the global
    batch's; the gradients are summed over the ranks (``sum_gradients``,
    in a ``train_step: allreduce`` span) before the optimizer (and its
    ``grad_clip``, which then clips by the global norm), and ``log_vars``
    are the global values (one all-reduce of their stack).
    """

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        lr = lr_schedule(step.t)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        if preprocess is not None:
            with record_function("train_step: oamix"):
                batch = preprocess(batch, generator)
        with sharded_batch():
            total, log_vars = parse_losses(model.forward_train(batch,
                                                               UniformDraws(generator)))
        with record_function("train_step: backward"):
            total.backward()
        if is_distributed():
            with record_function("train_step: allreduce"):
                sum_gradients(model.parameters())
                keys = list(log_vars)
                summed = all_reduce_sum(torch.stack(
                    [log_vars[k].detach().float().reshape(()) for k in keys]))
                log_vars = dict(zip(keys, summed.unbind(0)))
        with record_function("train_step: sgd"):
            optimizer.step()
        step.t += 1
        return {k: v.detach() for k, v in log_vars.items()}

    step.t = 0
    step.optimizer = optimizer
    return step


def make_test_step(model: torch.nn.Module) -> Callable:
    """-> ``step(batch) -> (dets (N, K, 5), labels (N, K), valid (N, K))``
    on the model's device, for a loader batch of numpy arrays: ``img``
    (N, H, W, C) float32, ``img_shape`` (N, 2), ``scale_factor`` (N, 4).

    The arrays go up with ``non_blocking=True``: from the loader's pinned
    memory the copy is asynchronous, so the caller keeps ``batch`` alive
    until it has read the results. ``img`` is viewed as NCHW with
    ``permute(0, 3, 1, 2)``, which on the card is the model's
    channels-last layout, without a copy. The model runs in eval mode
    under ``torch.inference_mode()``.

    A test-time augmentation batch (``__tta_views__``, ``__tta_metas__``)
    goes to ``make_aug_test_step(model, metas)``, made once per tuple of
    the views' ``(flip, flip_direction)``."""
    device = next(model.parameters()).device
    aug_steps: Dict[Any, Callable] = {}

    def step(batch: Dict[str, np.ndarray]):
        if "__tta_views__" in batch:
            metas = tuple(batch["__tta_metas__"])
            if metas not in aug_steps:
                aug_steps[metas] = make_aug_test_step(model, metas)
            return aug_steps[metas](batch["__tta_views__"])
        model.eval()
        with torch.inference_mode():
            return model.simple_test(upload_test_batch(batch, device))

    return step


def make_aug_test_step(model: torch.nn.Module, metas) -> Callable:
    """-> ``step(views) -> (dets, labels, valid)``: ``model.aug_test`` on
    the per-view loader batches ``views`` (each as ``make_test_step``
    takes it), whose ``(flip, flip_direction)`` are ``metas``."""
    metas = tuple((bool(f), str(d)) for f, d in metas)
    device = next(model.parameters()).device

    def step(views):
        if len(views) != len(metas):
            raise ValueError(f"{len(views)} views for {len(metas)} metas")
        model.eval()
        with torch.inference_mode():
            return model.aug_test([upload_test_batch(v, device) for v in views], metas)

    return step


def upload_test_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy test batch -> ``simple_test``'s tensors on ``device``:
    ``img`` NHWC viewed as NCHW, ``img_shape`` and ``scale_factor``, each
    copied with ``non_blocking=True``."""
    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device, non_blocking=True)

    return {"img": upload(batch["img"]).permute(0, 3, 1, 2),
            "img_shape": upload(batch["img_shape"]),
            "scale_factor": upload(batch["scale_factor"])}


def upload_train_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy training batch (``StaticBatcher``'s) -> the step's tensors on
    ``device``. ``img_raw`` (uint8, for the OA-Mix preprocess) or ``img``
    (host-normalized float32 NHWC, viewed as NCHW), ``gt_bboxes``,
    ``gt_labels``, ``gt_valid``, ``gt_masks`` (Mask R-CNN's box-cropped
    masks, where the batch has them) and ``scale_factor`` go up with
    ``non_blocking=True``; ``img_shape`` stays a CPU tensor, because the
    preprocess draws OA-Mix's boxes from it on the host. The copies from
    the loader's pinned memory are asynchronous: keep ``batch`` alive until
    the step's results have been read."""
    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device, non_blocking=True)

    out = {k: upload(batch[k]) for k in ("img_raw", "gt_bboxes", "gt_labels", "gt_valid",
                                         "gt_masks", "scale_factor") if k in batch}
    if "img" in batch:
        out["img"] = upload(batch["img"]).permute(0, 3, 1, 2)
    out["img_shape"] = torch.from_numpy(batch["img_shape"])
    return out
