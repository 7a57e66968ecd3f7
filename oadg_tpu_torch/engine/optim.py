"""Optimizer and LR schedule from mmdet-style configs (port of
``oadg_tpu/engine/optim.py``).

``build_optimizer`` is ``torch.optim.SGD`` over the parameters that require
grad: weight decay is added to the gradient before the momentum buffer,
and frozen parameters (``frozen_stages``, ``norm_cfg.requires_grad=False``;
the backbone sets ``requires_grad=False`` on them) get neither an update nor
decay, as in mmdet. The JAX package masks their gradients to zero *before*
``add_decayed_weights`` (``:145-158``), so its frozen parameters still decay;
the port does not copy that.

``grad_clip=dict(max_norm=...)`` (mmdet's ``optimizer_config.grad_clip``,
which the reference runner hands to its ``build_optimizer``,
``oadg_tpu/engine/runner.py:117-120``) clips the trainable gradients by their
global norm before the step, as ``optax.clip_by_global_norm`` does in the
reference chain (mask, clip, decay, momentum; ``:145-158``): each gradient
becomes ``g / norm * max_norm`` where ``norm >= max_norm``, with no epsilon.
Weight decay is then added inside SGD. ``grad_clip=None`` gives plain
``torch.optim.SGD``.

``build_lr_schedule`` is the ``step`` policy with ``linear`` warmup
(``:67-134``), iteration-indexed; other policies wait for later slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class ClippedSGD(torch.optim.SGD):
    """SGD whose ``step`` first clips every gradient of its parameters by
    their global L2 norm: ``g / norm * max_norm`` where ``norm >= max_norm``
    (``optax.clip_by_global_norm``). No host sync: the choice is a
    ``torch.where`` on the device."""

    def __init__(self, params, max_norm: float, **kwargs):
        super().__init__(params, **kwargs)
        self.max_norm = float(max_norm)

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        if grads:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        return super().step(closure)


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict,
                    grad_clip: Optional[dict] = None) -> torch.optim.SGD:
    """``dict(type='SGD', lr, momentum, weight_decay[, nesterov])`` -> SGD
    over ``model``'s parameters that require grad; with ``grad_clip``
    (``dict(max_norm=35)`` by default of its key) a :class:`ClippedSGD`."""
    cfg = dict(optimizer_cfg)
    if cfg.get("type", "SGD") != "SGD":
        raise NotImplementedError(f"optimizer {cfg['type']} (the port has SGD)")
    kwargs = dict(lr=float(cfg["lr"]), momentum=float(cfg.get("momentum", 0.0)),
                  weight_decay=float(cfg.get("weight_decay", 0.0)),
                  nesterov=bool(cfg.get("nesterov", False)))
    params = [p for p in model.parameters() if p.requires_grad]
    if grad_clip:
        return ClippedSGD(params, float(dict(grad_clip).get("max_norm", 35)), **kwargs)
    return torch.optim.SGD(params, **kwargs)


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
