"""Optimizer and LR schedule from mmdet-style configs (port of
``oadg_tpu/engine/optim.py``).

``build_optimizer`` is ``torch.optim.SGD`` over the parameters that require
grad: weight decay is added to the gradient before the momentum buffer,
and frozen parameters (``frozen_stages``, ``norm_cfg.requires_grad=False``;
the backbone sets ``requires_grad=False`` on them) get neither an update nor
decay, as in mmdet. The JAX package masks their gradients to zero *before*
``add_decayed_weights`` (``:145-158``), so its frozen parameters still decay;
the port does not copy that.

``build_lr_schedule`` is the ``step`` policy with ``linear`` warmup
(``:67-134``), iteration-indexed; other policies wait for later slices.
"""
from __future__ import annotations

from typing import Callable

import torch


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict) -> torch.optim.SGD:
    """``dict(type='SGD', lr, momentum, weight_decay[, nesterov])`` -> SGD
    over ``model``'s parameters that require grad."""
    cfg = dict(optimizer_cfg)
    if cfg.get("type", "SGD") != "SGD":
        raise NotImplementedError(f"optimizer {cfg['type']} (the port has SGD)")
    return torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                           lr=float(cfg["lr"]),
                           momentum=float(cfg.get("momentum", 0.0)),
                           weight_decay=float(cfg.get("weight_decay", 0.0)),
                           nesterov=bool(cfg.get("nesterov", False)))


def build_lr_schedule(lr_config: dict, base_lr: float,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """mmdet ``LrUpdaterHook`` -> iteration ``t`` (0 for the first update)
    -> learning rate: ``base_lr * gamma ** (boundaries passed)``, times the
    linear warmup factor ``warmup_ratio + (1 - warmup_ratio) * t /
    warmup_iters`` while ``t < warmup_iters``."""
    cfg = dict(lr_config or {})
    policy = cfg.get("policy", "step").lower()
    if policy != "step":
        raise NotImplementedError(f"lr policy {policy!r} (the port has 'step')")
    warmup = cfg.get("warmup")
    if warmup not in (None, "linear"):
        raise NotImplementedError(f"warmup {warmup!r} (the port has 'linear')")
    warmup_iters = int(cfg.get("warmup_iters", 0))
    warmup_ratio = float(cfg.get("warmup_ratio", 0.1))
    steps = cfg.get("step", [])
    steps = steps if isinstance(steps, (list, tuple)) else [steps]
    boundaries = [int(s * steps_per_epoch) for s in steps]
    gamma = float(cfg.get("gamma", 0.1))

    def schedule(t: int) -> float:
        lr = base_lr
        for b in boundaries:
            if t >= b:
                lr *= gamma
        if warmup == "linear" and t < warmup_iters:
            k = min(max(t / warmup_iters, 0.0), 1.0)
            lr *= warmup_ratio + (1.0 - warmup_ratio) * k
        return lr

    return schedule
