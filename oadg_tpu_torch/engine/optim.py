"""Optimizer and LR schedule from mmdet-style configs (port of
``oadg_tpu/engine/optim.py``).

``build_optimizer`` builds ``torch.optim.SGD``, ``Adam`` or ``AdamW`` over
the parameters that require grad. Frozen parameters (``frozen_stages``,
``norm_cfg.requires_grad=False``; the backbone sets ``requires_grad=False``
on them) get neither an update nor decay, as in mmdet. The JAX package
masks their gradients to zero *before* its weight decay (``:145-163``), so
its frozen parameters still decay; the port does not copy that.

- ``SGD``: weight decay is added to the gradient before the momentum
  buffer (torch's SGD, the JAX chain's ``add_decayed_weights`` ->
  ``trace``).
- ``AdamW``: ``torch.optim.AdamW`` with the config's ``betas`` and ``eps``:
  ``p -= lr * wd * p`` on the old ``p`` beside the Adam step, the update of
  the JAX chain ``scale_by_adam`` -> ``add_decayed_weights`` ->
  ``scale_by_learning_rate`` (``:159-164``).
- ``Adam``: ``torch.optim.Adam``, as mmdet's ``Adam`` is: its weight decay
  is added to the gradient. The JAX package decays ``Adam`` as ``AdamW``
  does, and both of its Adams ignore the config's ``eps`` (ROADMAP C).

``grad_clip=dict(max_norm=...)`` (mmdet's ``optimizer_config.grad_clip``,
which the reference runner hands to its ``build_optimizer``,
``oadg_tpu/engine/runner.py:117-120``) clips the trainable gradients by their
global norm before the step, as ``optax.clip_by_global_norm`` does in the
reference chain (mask, clip, optimizer): each gradient becomes
``g / norm * max_norm`` where ``norm >= max_norm``, with no epsilon.

``build_lr_schedule`` maps an mmdet ``lr_config`` to the learning rate of
iteration ``t`` (``:67-134``): the ``step``, ``CosineAnnealing`` and
``YOLOX`` policies, with ``linear``, ``constant`` or ``exp`` warmup.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


class _ClipByGlobalNorm:
    """An optimizer whose ``step`` first clips every gradient of its
    parameters by their global L2 norm: ``g / norm * max_norm`` where
    ``norm >= max_norm`` (``optax.clip_by_global_norm``). No host sync: the
    choice is a ``torch.where`` on the device."""

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


class ClippedSGD(_ClipByGlobalNorm, torch.optim.SGD):
    """SGD with the gradients clipped by their global norm."""


class ClippedAdam(_ClipByGlobalNorm, torch.optim.Adam):
    """Adam with the gradients clipped by their global norm."""


class ClippedAdamW(_ClipByGlobalNorm, torch.optim.AdamW):
    """AdamW with the gradients clipped by their global norm."""


_OPTIMIZERS = {"SGD": (torch.optim.SGD, ClippedSGD),
               "Adam": (torch.optim.Adam, ClippedAdam),
               "AdamW": (torch.optim.AdamW, ClippedAdamW)}


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict,
                    grad_clip: Optional[dict] = None) -> torch.optim.Optimizer:
    """``dict(type='SGD', lr, momentum, weight_decay[, nesterov])`` or
    ``dict(type='Adam' | 'AdamW', lr, weight_decay[, betas, eps, amsgrad])``
    -> that optimizer over ``model``'s parameters that require grad; with
    ``grad_clip`` (``dict(max_norm=35)`` by default of its key) its clipped
    class."""
    cfg = dict(optimizer_cfg)
    kind = cfg.get("type", "SGD")
    if kind not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer {kind!r} (the port has {sorted(_OPTIMIZERS)})")
    kwargs = dict(lr=float(cfg["lr"]), weight_decay=float(cfg.get("weight_decay", 0.0)))
    if kind == "SGD":
        kwargs.update(momentum=float(cfg.get("momentum", 0.0)),
                      nesterov=bool(cfg.get("nesterov", False)))
    else:
        kwargs.update(betas=tuple(float(b) for b in cfg.get("betas", (0.9, 0.999))),
                      eps=float(cfg.get("eps", 1e-8)),
                      amsgrad=bool(cfg.get("amsgrad", False)))
    params = [p for p in model.parameters() if p.requires_grad]
    plain, clipped = _OPTIMIZERS[kind]
    if grad_clip:
        return clipped(params, float(dict(grad_clip).get("max_norm", 35)), **kwargs)
    return plain(params, **kwargs)


def _cosine(base_lr: float, min_ratio: float, frac: float) -> float:
    return base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def build_lr_schedule(lr_config: dict, base_lr: float, steps_per_epoch: int,
                      max_epochs: Optional[int] = None) -> Callable[[int], float]:
    """mmdet ``LrUpdaterHook`` -> iteration ``t`` (0 for the first update)
    -> learning rate. ``max_epochs`` is the runner's.

    - ``step``: ``base_lr * gamma ** (boundaries passed)``, the boundaries
      at ``step`` epochs.
    - ``CosineAnnealing``: from ``base_lr`` to ``min_lr_ratio * base_lr``
      (or ``min_lr``) along half a cosine, over ``lr_config.max_iters``
      iterations where it is given (the JAX package's reading), else over
      the run as mmcv does: by epoch (``t // steps_per_epoch`` of
      ``max_epochs``) or, with ``by_epoch=False``, by iteration.
    - ``YOLOX``: quadratic warmup from 0 over ``warmup_iters``, the cosine
      down to ``min_lr_ratio`` (default 0.05) until the last
      ``num_last_epochs`` (default 15) of ``max_epochs``, flat after; the
      JAX package's formula, with the run's ``max_epochs`` where the JAX
      package reads ``lr_config.total_epochs`` (default 300; ROADMAP C).

    Warmup (not ``YOLOX``) multiplies the policy's LR while ``t <
    warmup_iters``: ``linear`` by ``r + (1 - r) * t / warmup_iters``,
    ``constant`` by ``r``, ``exp`` by ``r ** (1 - t / warmup_iters)``, with
    ``r = warmup_ratio``."""
    cfg = dict(lr_config or {})
    policy = cfg.get("policy", "step").lower()
    warmup = cfg.get("warmup")
    if warmup not in (None, "linear", "constant", "exp"):
        raise NotImplementedError(f"warmup {warmup!r} (the port has linear, constant, exp)")
    warmup_iters = int(cfg.get("warmup_iters", 0))
    warmup_ratio = float(cfg.get("warmup_ratio", 0.1))
    steps_per_epoch = max(int(steps_per_epoch), 1)

    if policy == "step":
        steps = cfg.get("step", [])
        steps = steps if isinstance(steps, (list, tuple)) else [steps]
        boundaries = [int(s * steps_per_epoch) for s in steps]
        gamma = float(cfg.get("gamma", 0.1))

        def base(t: int) -> float:
            lr = base_lr
            for b in boundaries:
                if t >= b:
                    lr *= gamma
            return lr
    elif policy == "cosineannealing":
        if "min_lr_ratio" in cfg or "min_lr" not in cfg:
            min_ratio = float(cfg.get("min_lr_ratio", 0.0))
        else:
            min_ratio = float(cfg["min_lr"]) / base_lr
        if cfg.get("max_iters") is not None:
            total = max(int(cfg["max_iters"]), 1)

            def progress(t: int) -> float:
                return t / total
        elif max_epochs is None:
            raise ValueError("the CosineAnnealing policy anneals over the run: pass "
                             "max_epochs (the runner's) or lr_config.max_iters")
        elif cfg.get("by_epoch", True):
            def progress(t: int) -> float:
                return (t // steps_per_epoch) / max_epochs
        else:
            def progress(t: int) -> float:
                return t / (max_epochs * steps_per_epoch)

        def base(t: int) -> float:
            return _cosine(base_lr, min_ratio, min(max(progress(t), 0.0), 1.0))
    elif policy == "yolox":
        min_ratio = float(cfg.get("min_lr_ratio", 0.05))
        last_epochs = int(cfg.get("num_last_epochs", 15))
        total_epochs = (int(max_epochs) if max_epochs is not None
                        else int(cfg.get("total_epochs", cfg.get("max_epochs", 300))))
        total = (total_epochs - last_epochs) * steps_per_epoch
        wi = max(warmup_iters, 1)

        def schedule(t: int) -> float:
            if t < wi:                           # quadratic warmup from 0
                return base_lr * min(max(t / wi, 0.0), 1.0) ** 2
            if t >= total:
                return base_lr * min_ratio
            return _cosine(base_lr, min_ratio, min(max((t - wi) / max(total - wi, 1), 0.0),
                                                   1.0))

        return schedule
    else:
        raise NotImplementedError(f"lr policy {policy!r} (the port has step, "
                                  "CosineAnnealing, YOLOX)")

    def schedule(t: int) -> float:
        lr = base(t)
        if warmup is not None and t < warmup_iters:
            k = min(max(t / warmup_iters, 0.0), 1.0)
            if warmup == "linear":
                lr *= warmup_ratio + (1.0 - warmup_ratio) * k
            elif warmup == "constant":
                lr *= warmup_ratio
            else:
                lr *= warmup_ratio ** (1 - k)
        return lr

    return schedule
