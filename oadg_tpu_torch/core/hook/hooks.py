"""Training hooks (port of ``oadg_tpu/core/hook/hooks.py``), on the runner's
hook protocol: the NaN guard, the class-count check, the text logger's name,
the EMA family, YOLOX's mode switch, the random input size, the epoch-info
and norm-sync hooks, the feature capture, the wandb loggers and the
profiler.

The runner (``engine/runner.py``) calls ``before_run``,
``before_train_epoch``, ``after_train_iter(runner, log_vars)`` (host floats),
``after_train_epoch``, ``after_val_epoch(runner, metrics)`` and
``after_run``; ``runner`` exposes ``model``, ``optimizer``, ``epoch``,
``max_epochs``, ``iter`` (the iterations done), ``loader``, ``cfg``,
``logger``, ``lr_fn``, ``hooks``, ``ckpt``, ``work_dir`` and, after an
evaluation, ``val_dataset`` and ``last_val_results``.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.registry import HOOKS


class Hook:
    # under data parallel, called on rank 0 alone (the loggers, the profiler)
    rank0_only = False

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


@HOOKS.register_module()
class YOLOXModeSwitchHook(Hook):
    """For the last ``num_last_epochs`` epochs (``:156-183``): the dataset
    skips ``skip_type_keys`` (where it can) and the runner turns on the
    head's L1 loss (``enable_head_l1``); once."""

    def __init__(self, num_last_epochs: int = 15,
                 skip_type_keys=("Mosaic", "RandomAffine", "MixUp"), **kw):
        self.num_last_epochs = num_last_epochs
        self.skip_type_keys = tuple(skip_type_keys)
        self._done = False

    def before_train_epoch(self, runner):
        if self._done or runner.epoch < runner.max_epochs - self.num_last_epochs:
            return
        self._done = True
        ds = getattr(runner.loader, "dataset", None)
        if hasattr(ds, "update_skip_type_keys"):
            ds.update_skip_type_keys(self.skip_type_keys)
        runner.logger.info(f"YOLOXModeSwitch: skipping {self.skip_type_keys}, adding L1")
        if hasattr(runner, "enable_head_l1"):
            runner.enable_head_l1()


@HOOKS.register_module()
class SyncRandomSizeHook(Hook):
    """Every ``interval`` iterations a new training canvas (``:186-211``):
    ``r`` from ``RandomState(iter).randint(lo, hi + 1)``, so that every rank
    draws the same size without a broadcast; ``(32 r, 32 int(r * w / h))``
    of ``img_scale`` (h, w) becomes the loader's ``batcher.static_hw``.
    Batches the loader has collated already keep their size, as in the JAX
    package's prefetching loader."""

    def __init__(self, ratio_range=(14, 26), img_scale=(640, 640), interval: int = 10,
                 **kw):
        self.ratio_range = tuple(ratio_range)
        self.img_scale = tuple(img_scale)
        self.interval = interval

    def size_at(self, it: int) -> Tuple[int, int]:
        lo, hi = self.ratio_range
        r = int(np.random.RandomState(it).randint(lo, hi + 1))
        return 32 * r, 32 * int(r * self.img_scale[1] / self.img_scale[0])

    def after_train_iter(self, runner, log_vars):
        if runner.iter % self.interval:
            return
        batcher = getattr(runner.loader, "batcher", None)
        if batcher is not None:
            batcher.static_hw = self.size_at(runner.iter)


@HOOKS.register_module()
class SetEpochInfoHook(Hook):
    """mmdet hands the epoch to the model; no model of the port reads it,
    so this is a no-op (as in the JAX package)."""


@HOOKS.register_module()
class SyncNormHook(Hook):
    """After each training epoch, before the evaluation, the stored
    statistics of every live BN (``models.layers.BatchNorm``) averaged over
    the ranks, as mmdet does. The port's live BNs are SyncBN under data
    parallel, so the ranks' statistics agree already and the average keeps
    them: in effect the JAX package's no-op. Nothing with one process."""

    def __init__(self, **kw):
        pass

    def after_train_epoch(self, runner):
        from ...models.layers import BatchNorm
        from ...parallel import all_reduce_sum, get_dist_info, is_distributed
        if not is_distributed():
            return
        world = get_dist_info()[1]
        with torch.no_grad():
            for m in runner.model.modules():
                if isinstance(m, BatchNorm):
                    for buf in (m.running_mean, m.running_var):
                        buf.copy_(all_reduce_sum(buf) / world)


def _qualified(model: torch.nn.Module, layer_list) -> List[Tuple[str, torch.nn.Module]]:
    return [(n, m) for n, m in model.named_modules() if n in layer_list]


def _detached(out):
    if isinstance(out, torch.Tensor):
        return out.detach().clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_detached(o) for o in out)
    return out


@HOOKS.register_module()
class FeatureHook(Hook):
    """Named activations of one test forward (``:224-245``): ``capture(runner,
    batch)`` puts forward hooks on the modules whose qualified name (as
    ``named_modules`` gives it: ``neck``, ``backbone.layer4``,
    ``roi_head.bbox_head.shared_fcs.1``) is in ``layer_list``, runs
    ``simple_test`` on ``batch`` (the model's tensors), removes the hooks
    and keeps each module's output in ``features`` (read by the wandb
    loggers)."""

    def __init__(self, layer_list: Optional[List[str]] = None, **kw):
        self.layer_list = list(layer_list or [])
        self.features: Dict[str, Any] = {}

    def capture(self, runner, batch) -> Dict[str, Any]:
        model = runner.model
        modules = _qualified(model, self.layer_list)
        missing = set(self.layer_list) - {n for n, _ in modules}
        if missing:
            raise KeyError(f"FeatureHook: the model has no module {sorted(missing)}")
        features: Dict[str, Any] = {}
        handles = [m.register_forward_hook(
            lambda _m, _i, out, name=n: features.__setitem__(name, _detached(out)))
            for n, m in modules]
        was_training = model.training
        try:
            model.eval()
            with torch.inference_mode():
                model.simple_test(batch)
        finally:
            for h in handles:
                h.remove()
            model.train(was_training)
        self.features = features
        return features


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flatten(v, f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@HOOKS.register_module()
class WandbLogger(Hook):
    """wandb logging (``:247-369``): ``wandb.init(**init_kwargs)`` and the
    config before the run; every ``interval`` iterations the logged values
    under ``train/`` and the step's ``learning_rate``; after each epoch a
    histogram of each feature a ``FeatureHook`` captured and, with
    ``log_checkpoint``, the newest checkpoint as an artifact; after each
    evaluation the metrics under ``val/`` and a table of the first
    ``num_eval_images`` images with their detections above
    ``bbox_score_thr`` as box overlays. Without the ``wandb`` module it
    logs a warning and does nothing. Under data parallel rank 0 alone
    logs."""

    rank0_only = True

    def __init__(self, init_kwargs=None, interval: int = 50, log_checkpoint: bool = False,
                 log_checkpoint_metadata: bool = False, num_eval_images: int = 100,
                 bbox_score_thr: float = 0.3, **kw):
        self.interval = interval
        self.init_kwargs = init_kwargs or {}
        self.log_checkpoint = log_checkpoint
        self.log_checkpoint_metadata = log_checkpoint_metadata
        self.num_eval_images = num_eval_images
        self.bbox_score_thr = bbox_score_thr
        try:
            import wandb
            self.wandb = wandb
        except ImportError:
            self.wandb = None

    def before_run(self, runner):
        if not self.wandb:
            runner.logger.warning("wandb not available; WandbLogger is a no-op")
            return
        self.wandb.init(**self.init_kwargs)
        cfg = getattr(runner, "cfg", None)
        if cfg is not None:
            self.wandb.config.update({k: str(v) for k, v in dict(cfg).items()},
                                     allow_val_change=True)

    def after_train_iter(self, runner, log_vars):
        if self.wandb and runner.iter % self.interval == 0:
            out = {f"train/{k}": float(v) for k, v in dict(log_vars).items()}
            if hasattr(runner, "lr_fn"):        # the LR of the step just taken
                out["learning_rate"] = float(runner.lr_fn(max(runner.iter - 1, 0)))
            self.wandb.log(out, step=runner.iter)

    def after_train_epoch(self, runner):
        if not self.wandb:
            return
        for h in getattr(runner, "hooks", []):
            for name, val in _flatten(getattr(h, "features", None) or {}):
                if isinstance(val, torch.Tensor):
                    val = val.float().cpu().numpy()
                self.wandb.log({f"features/{name}":
                                self.wandb.Histogram(np.asarray(val).ravel())},
                               step=runner.iter)
        path = runner.ckpt.latest_path() if self.log_checkpoint else None
        if path:
            art = self.wandb.Artifact(
                f"checkpoint-{getattr(self.wandb.run, 'id', 'run')}", type="model",
                metadata=dict(epoch=runner.epoch) if self.log_checkpoint_metadata else None)
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(os.path.realpath(path))
            self.wandb.log_artifact(art)

    def after_val_epoch(self, runner, metrics):
        if not self.wandb:
            return
        self.wandb.log({f"val/{k}": v for k, v in metrics.items()
                        if isinstance(v, (int, float))}, step=runner.iter)
        results = getattr(runner, "last_val_results", None)
        ds = getattr(runner, "val_dataset", None)
        if not results or ds is None or not self.num_eval_images:
            return
        class_labels = dict(enumerate(getattr(ds, "CLASSES", None) or []))
        table = self.wandb.Table(columns=["image_name", "prediction"])
        for i in range(min(self.num_eval_images, len(results), len(ds))):
            info = ds.data_infos[i]
            name = info.get("filename", info.get("file_name", ""))
            box_data = [dict(position=dict(minX=float(d[0]), minY=float(d[1]),
                                           maxX=float(d[2]), maxY=float(d[3])),
                             class_id=int(c), scores=dict(score=float(d[4])),
                             domain="pixel")
                        for c, dets in enumerate(results[i]) for d in np.asarray(dets)
                        if d[4] >= self.bbox_score_thr]
            img = self.wandb.Image(os.path.join(getattr(ds, "img_prefix", "") or "", name),
                                   boxes=dict(predictions=dict(box_data=box_data,
                                                               class_labels=class_labels)))
            table.add_data(info.get("filename", str(i)), img)
        self.wandb.log({"eval/predictions": table}, step=runner.iter)

    def after_run(self, runner):
        if self.wandb:
            self.wandb.finish()


@HOOKS.register_module()
class WandbLoggerMulti(WandbLogger):
    """The multi-domain variant (``:372-383``): the metrics of a domain's
    evaluation (``runner.val_domain``) go under ``val/<domain>/``."""

    def after_val_epoch(self, runner, metrics):
        if not self.wandb:
            return
        domain = getattr(runner, "val_domain", None)
        if domain:
            metrics = {f"{domain}/{k}": v for k, v in metrics.items()}
        super().after_val_epoch(runner, metrics)


@HOOKS.register_module()
class ProfilerHook(Hook):
    """A ``torch.profiler`` trace (host and, on a card, device activity) of
    ``num_iters`` training iterations: it starts once ``start_iter``
    iterations are done and stops ``num_iters`` later (or at the end of the
    run), writing a Chrome trace ``trace_iter{a}-{b}.json`` into
    ``out_dir`` (default ``work_dir/profiler``; ``:392-424``). Under data
    parallel rank 0 alone traces."""

    rank0_only = True

    def __init__(self, start_iter: int = 10, num_iters: int = 3,
                 out_dir: Optional[str] = None, **kw):
        self.start_iter = start_iter
        self.num_iters = num_iters
        self.out_dir = out_dir
        self.prof = None
        self.trace_path: Optional[str] = None
        self._done = False

    def after_train_iter(self, runner, log_vars):
        if self._done:
            return
        it = runner.iter
        if self.prof is None and it >= self.start_iter:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self._start = it
        elif self.prof is not None and it >= self._start + self.num_iters:
            self._stop(runner)

    def _stop(self, runner):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        out_dir = self.out_dir or os.path.join(runner.work_dir, "profiler")
        os.makedirs(out_dir, exist_ok=True)
        self.trace_path = os.path.join(out_dir, f"trace_iter{self._start}-{runner.iter}.json")
        self.prof.export_chrome_trace(self.trace_path)
        runner.logger.info(f"ProfilerHook: trace of iterations {self._start + 1}-"
                           f"{runner.iter} in {self.trace_path}")
        self.prof = None
        self._done = True

    def after_run(self, runner):
        if self.prof is not None:
            self._stop(runner)
