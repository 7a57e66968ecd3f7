"""Training hooks (port of ``oadg_tpu/core/hook/hooks.py:19-155,387-391``):
the NaN guard, the class-count check, the text logger's name and the EMA
family, on the runner's hook protocol.

The runner (``engine/runner.py``) calls ``before_run``,
``before_train_epoch``, ``after_train_iter(runner, log_vars)`` (host floats),
``after_train_epoch``, ``after_val_epoch(runner, metrics)`` and
``after_run``; ``runner`` exposes ``model``, ``optimizer``, ``epoch``,
``iter``, ``loader``, ``cfg`` and ``logger``.

The JAX package's other hooks are registered here too and raise
``NotImplementedError`` when a config builds them, so that no hook of a
config is skipped in silence.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ...utils.registry import HOOKS


class Hook:
    def before_run(self, runner):
        pass

    def before_train_epoch(self, runner):
        pass

    def after_train_iter(self, runner, log_vars: Dict[str, float]):
        pass

    def after_train_epoch(self, runner):
        pass

    def after_val_epoch(self, runner, metrics: Dict[str, float]):
        pass

    def after_run(self, runner):
        pass


@HOOKS.register_module()
class CheckLossHook(Hook):
    """Raise ``FloatingPointError`` when the loss is not finite at an
    iteration that is a multiple of ``interval``."""

    def __init__(self, interval: int = 50, **kw):
        self.interval = interval

    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval == 0 and not math.isfinite(log_vars.get("loss", 0.0)):
            raise FloatingPointError(f"loss became {log_vars['loss']} at iter {runner.iter}")


HOOKS.register_module(name="CheckInvalidLossHook", module=CheckLossHook)


@HOOKS.register_module()
class NumClassCheckHook(Hook):
    """Before the run: the box head's ``num_classes`` must equal the number
    of the training dataset's ``CLASSES`` (mmdet asserts it; the JAX
    package only warns)."""

    def before_run(self, runner):
        classes = getattr(getattr(runner.loader, "dataset", None), "CLASSES", None)
        if classes is None:
            return
        from ...apis.inference import _num_classes
        nc = _num_classes(runner.cfg)
        if nc != len(classes):
            raise ValueError(f"the model's num_classes={nc} != len(dataset.CLASSES)="
                             f"{len(classes)} ({tuple(classes)})")


@HOOKS.register_module()
class TextLoggerHook(Hook):
    """The name configs give in ``log_config``; the runner writes the text
    and json logs itself."""

    def __init__(self, **kw):
        pass


@HOOKS.register_module()
class EMAHook(Hook):
    """Exponential moving average of the model's parameters and floating
    buffers: every ``interval`` iterations ``ema = (1 - m) * ema + m * p``
    (the first such iteration takes a copy). After each training epoch the
    averages are swapped into the model, so that the checkpoint and the
    evaluation see them, and swapped back before the next epoch trains; at
    the end of the run the averages stay in the model."""

    def __init__(self, momentum: float = 0.0002, interval: int = 1, **kw):
        self.momentum = momentum
        self.interval = interval
        self.ema: Optional[List[torch.Tensor]] = None
        self._swapped = False

    @staticmethod
    def _tensors(runner) -> List[Tuple[str, torch.Tensor]]:
        model = runner.model
        return list(model.named_parameters()) + [
            (k, b) for k, b in model.named_buffers() if b.is_floating_point()]

    def _momentum_at(self, runner) -> float:
        return self.momentum

    @torch.no_grad()
    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval:
            return
        live = [t for _, t in self._tensors(runner)]
        if self.ema is None:
            self.ema = [t.detach().clone() for t in live]
            return
        m = self._momentum_at(runner)
        for e, p in zip(self.ema, live):
            e.copy_((1 - m) * e + m * p)

    @torch.no_grad()
    def swap(self, runner):
        """Exchange the averages and the model's values in place."""
        if self.ema is None:
            return
        for e, (_, p) in zip(self.ema, self._tensors(runner)):
            held = p.detach().clone()
            p.copy_(e)
            e.copy_(held)
        self._swapped = not self._swapped

    def after_train_epoch(self, runner):
        self.swap(runner)

    def before_train_epoch(self, runner):
        if self._swapped:
            self.swap(runner)

    def after_run(self, runner):
        self._swapped = False


@HOOKS.register_module()
class ExpMomentumEMAHook(EMAHook):
    """EMA with ``m_t = (1 - m) * exp(-(1 + t) / gamma) + m`` at iteration
    ``t`` (the YOLOX recipe)."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 2000,
                 interval: int = 1, **kw):
        super().__init__(momentum=momentum, interval=interval)
        self.gamma = float(gamma)

    def _momentum_at(self, runner):
        return ((1 - self.momentum) * math.exp(-(1 + runner.iter) / self.gamma)
                + self.momentum)


@HOOKS.register_module()
class LinearMomentumEMAHook(EMAHook):
    """EMA with ``m_t = min(m, (1 + t) / (gamma + t))`` at iteration ``t``."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 100,
                 warm_up: int = 100, interval: int = 1, **kw):
        super().__init__(momentum=momentum, interval=interval)
        self.gamma = float(gamma)

    def _momentum_at(self, runner):
        t = runner.iter
        return min(self.momentum, (1 + t) / (self.gamma + t))


def _not_ported(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"the {name} hook is not ported yet "
                                  "(ROADMAP A, 'Engine leftovers')")
    return type(name, (Hook,), {"__init__": __init__,
                                "__doc__": f"The JAX package's {name}; raises "
                                           "(ROADMAP A, 'Engine leftovers')."})


for _name in ("YOLOXModeSwitchHook", "SyncRandomSizeHook", "SetEpochInfoHook",
              "SyncNormHook", "FeatureHook", "WandbLogger", "WandbLoggerMulti",
              "ProfilerHook"):
    HOOKS.register_module(module=_not_ported(_name))
