"""The training step (port of ``oadg_tpu/engine/train_step.py``):
``forward_train`` -> backward -> SGD step -> LR schedule tick. The
counterpart of the JAX package's ``make_train_step(detector, tx,
preprocess=None)`` (``:33``). With ``preprocess`` (``engine/preprocess.py``) the step first
turns a uint8 batch into the views-major one through on-device OA-Mix,
inside a ``train_step: oamix`` span, as the JAX step runs its preprocess
inside the jitted step.

The model's parameters, their gradients and SGD are float32 whatever the
model's compute ``dtype``: a bfloat16 layer casts its float32 parameters on
use, and autograd returns float32 gradients through the cast. Build the
preprocess with ``out_dtype=model.dtype``.

Backward and the SGD step run inside ``torch.profiler.record_function``
spans (``train_step: backward``, ``train_step: sgd``), beside those of
``TwoStageDetector.forward_train``; they cost nothing without a profiler.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

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
        total, log_vars = parse_losses(model.forward_train(batch,
                                                           UniformDraws(generator)))
        with record_function("train_step: backward"):
            total.backward()
        with record_function("train_step: sgd"):
            optimizer.step()
        step.t += 1
        return {k: v.detach() for k, v in log_vars.items()}

    step.t = 0
    step.optimizer = optimizer
    return step
