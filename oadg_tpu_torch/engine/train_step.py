"""The training step (port of ``oadg_tpu/engine/train_step.py``):
``forward_train`` -> backward -> SGD step -> LR schedule tick. The
counterpart of the JAX package's ``make_train_step(detector, tx,
preprocess=None)`` (``:33``), which takes a views-major batch as it is
(OA-Mix is not ported yet).

Backward and the SGD step run inside ``torch.profiler.record_function``
spans (``train_step: backward``, ``train_step: sgd``), beside those of
``TwoStageDetector.forward_train``; they cost nothing without a profiler.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

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
                    lr_schedule: Callable[[int], float]) -> Callable:
    """-> ``step(batch, generator) -> log_vars``, detached tensors.

    Every random number of the step is drawn from ``generator``. The step at
    iteration ``t`` (``step.t``, counting from 0) runs with
    ``lr_schedule(t)``; ``step.optimizer`` is ``optimizer``.
    """

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        lr = lr_schedule(step.t)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
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
