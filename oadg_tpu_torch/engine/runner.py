"""The epoch-based training runner (port of ``oadg_tpu/engine/runner.py:27-281``).

``EpochBasedRunner`` owns the model, its optimizer and LR schedule, the
train step (``make_train_step``, with the OA-Mix preprocess when the
pipeline has one) and the test step. Each epoch it sets the loader's epoch
(so that the batch order is a function of the seed and the epoch), and per
batch it uploads the loader's pinned batch (``upload_train_batch``), runs
the step with a generator seeded from ``(seed, iter)`` alone
(``step_generator``: a resumed run draws what the uninterrupted run drew),
reads every logged value in one device-to-host copy (``fetch_log_vars``),
raises ``FloatingPointError`` on a non-finite loss and calls the hooks.
Every ``log_config.interval`` iterations it writes the window's means with
``lr``, ``time`` (the step, from its call to its values on the host) and
``data_time`` (waiting for the loader and the upload) to the text log and to
``work_dir/log.json``. After each epoch it saves a checkpoint and, with a
val loader, evaluates (``run_test`` and ``dataset.evaluate``).

Checkpoints take mmcv's layout (not the JAX package's Orbax one):
``work_dir/epoch_{n}.pth`` holds ``meta`` (``epoch``, ``iter``, ``seed``),
``state_dict`` (the model's, on the CPU) and ``optimizer`` (the optimizer's
state dict: SGD's momentum buffers, Adam's moments), and ``latest.pth``
links to the newest. ``resume``
restores all three and the step's LR counter, strictly; ``load_weights``
(the config's ``load_from``) grafts the weights alone, from such a file or
a published mmdet one. ``init_detector(checkpoint=...)``
and ``tools/torch_test.py`` read such a file as it is.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import math
import os
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..parallel import get_dist_info
from .optim import build_lr_schedule, build_optimizer
from .train_step import make_test_step, make_train_step, upload_train_batch


TEXT_LOG = "train.log"


def get_root_logger(work_dir: Optional[str] = None, log_level=logging.INFO) -> logging.Logger:
    """The port's logger: stderr and, when ``work_dir`` is named, its text log
    ``work_dir/train.log``. Each call that names a work dir moves the file
    to that work dir's log, so that a second run in one process writes into
    its own work dir. Under data parallel only rank 0 writes the file, and
    the other ranks log errors alone (mmcv's rule)."""
    logger = logging.getLogger("oadg_tpu_torch")
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    rank = get_dist_info()[0]
    if not logger.handlers:
        logger.setLevel(log_level)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if rank != 0:
        logger.setLevel(logging.ERROR)
        return logger
    if work_dir is None:
        return logger
    path = os.path.abspath(os.path.join(work_dir, TEXT_LOG))
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
        if h.baseFilename == path:
            return logger
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def step_generator(seed: int, it: int, device, rank: int = 0) -> torch.Generator:
    """The generator of iteration ``it`` on rank ``rank``: on ``device``,
    seeded with ``seed * 2**32 + it`` on rank 0, so that its draws depend
    on (seed, it) alone (one process is rank 0); on another rank with a
    hash of (seed, it, rank), a stream of its own."""
    base = (int(seed) % 2 ** 31) * 2 ** 32 + int(it)
    if rank:
        digest = hashlib.sha256(f"{base}:{int(rank)}".encode()).digest()
        base = int.from_bytes(digest[:8], "little") >> 1
    g = torch.Generator(device=device)
    g.manual_seed(base)
    return g


def fetch_log_vars(log_vars: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's scalar log values -> host floats, in one device-to-host
    copy (which waits for the step)."""
    keys = list(log_vars)
    values = torch.stack([log_vars[k].detach().float().reshape(()) for k in keys]).cpu()
    return dict(zip(keys, values.tolist()))


def _on_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def model_state_dict(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A checkpoint (``{"state_dict": ...}``) or a bare state dict -> the
    state dict, without ``num_batches_tracked`` entries."""
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


class Checkpointer:
    """``epoch_{n}.pth`` files and the ``latest.pth`` link in ``work_dir``."""

    def __init__(self, work_dir: str):
        self.dir = os.path.abspath(work_dir)
        os.makedirs(self.dir, exist_ok=True)

    def save(self, model: torch.nn.Module, optimizer, meta: Dict[str, Any]) -> str:
        name = f"epoch_{meta['epoch']}.pth"
        path = os.path.join(self.dir, name)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"meta": dict(meta), "state_dict": _on_cpu(model.state_dict()),
                    "optimizer": _on_cpu(optimizer.state_dict())}, tmp)
        os.replace(tmp, path)
        link = os.path.join(self.dir, f"latest.pth.{os.getpid()}.tmp")
        os.symlink(name, link)
        os.replace(link, os.path.join(self.dir, "latest.pth"))
        return path

    def latest_path(self) -> Optional[str]:
        """``latest.pth``, else the ``epoch_{n}.pth`` of the largest n, else None."""
        latest = os.path.join(self.dir, "latest.pth")
        if os.path.exists(latest):
            return latest
        epochs = [(int(m.group(1)), p) for p in glob.glob(os.path.join(self.dir, "epoch_*.pth"))
                  if (m := re.fullmatch(r"epoch_(\d+)\.pth", os.path.basename(p)))]
        return max(epochs)[1] if epochs else None

    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        return torch.load(path, map_location="cpu", weights_only=True)


class EpochBasedRunner:
    """``model`` (from ``init_detector``, in its compute dtype) trained by
    ``cfg``'s optimizer, ``optimizer_config.grad_clip``, ``lr_config``,
    ``runner.max_epochs``, ``log_config.interval``,
    ``checkpoint_config.interval``, ``custom_hooks`` and ``evaluation``,
    over ``train_loader``'s batches; ``preprocess`` (the OA-Mix one) runs
    inside the step.

    Under data parallel (a process group; ``apis.train_detector(...,
    distributed=True)``) each rank runs this runner on its slice of the
    batches, with its own step generators (``step_generator(...,
    rank)``: OA-Mix's table is drawn for the rank's images); the logged
    values are the global batch's, so every rank sees the same loss (the
    NaN check stops them together); only rank 0 (``self.rank``) writes
    checkpoints, ``log.json`` and ``train.log`` and runs the hooks marked
    ``rank0_only``; every rank runs the evaluation's forward on its slice
    of the val set and gets the whole set's results (``multi_gpu_test``)."""

    def __init__(self, model: torch.nn.Module, cfg, train_loader, work_dir: str,
                 val_dataset=None, val_loader=None, preprocess=None, logger=None,
                 seed: int = 0):
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.loader = train_loader
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.logger = logger or get_root_logger(work_dir)
        self.json_log = os.path.join(work_dir, "log.json")
        self.max_epochs = int(dict(cfg.get("runner") or {}).get("max_epochs", 12))
        self.log_interval = int(dict(cfg.get("log_config") or {}).get("interval", 50))
        self.ckpt_interval = int(dict(cfg.get("checkpoint_config") or {}).get("interval", 1))
        self.val_dataset = val_dataset
        self.val_loader = val_loader
        self.seed = int(seed)
        self.rank, self.world = get_dist_info()
        self.lr_fn = build_lr_schedule(cfg.get("lr_config"), float(cfg["optimizer"]["lr"]),
                                       max(len(train_loader), 1), max_epochs=self.max_epochs)
        self.optimizer = build_optimizer(
            model, cfg["optimizer"],
            grad_clip=dict(cfg.get("optimizer_config") or {}).get("grad_clip"))
        self.step = make_train_step(model, self.optimizer, self.lr_fn, preprocess=preprocess)
        self.test_fn = make_test_step(model)
        self.ckpt = Checkpointer(work_dir)
        self.epoch = 0
        self.iter = 0
        self.hooks = self._build_hooks(cfg)

    def _build_hooks(self, cfg) -> List:
        from ..core.hook import Hook  # noqa: F401  (registers the hook types)
        from ..utils.registry import HOOKS, build_from_cfg
        return [build_from_cfg(dict(hc), HOOKS) for hc in list(cfg.get("custom_hooks") or [])]

    def call_hooks(self, stage: str, *args):
        for h in self.hooks:
            if self.rank == 0 or not getattr(h, "rank0_only", False):
                getattr(h, stage)(self, *args)

    def enable_head_l1(self):
        """``YOLOXModeSwitchHook``: the single-stage head's extra L1 loss on,
        in place, its weights kept (``oadg_tpu/engine/runner.py:147-160``
        rebuilds the detector with ``bbox_head.use_l1=True``). A two-stage
        model has no ``bbox_head`` and is left as it is, as the rebuild
        leaves it; a head without ``use_l1`` is left as it is with a
        warning, as the JAX registry drops the key it does not take."""
        head = getattr(self.model, "bbox_head", None)
        if head is None:
            return
        if not hasattr(head, "use_l1"):
            import warnings
            warnings.warn(f"{type(head).__name__}: dropping config key 'use_l1' "
                          "(not implemented by this module)")
            return
        head.use_l1 = True

    # ---------------- checkpoints ----------------

    def save(self) -> Optional[str]:
        """The checkpoint of this epoch (rank 0 writes it; other ranks None)."""
        if self.rank != 0:
            return None
        t0 = time.perf_counter()
        path = self.ckpt.save(self.model, self.optimizer,
                              dict(epoch=self.epoch, iter=self.iter, seed=self.seed))
        self.last_save_ms = (time.perf_counter() - t0) * 1e3
        self.logger.info(f"saved {path} in {self.last_save_ms:.3f} ms")
        return path

    def resume(self, path: Optional[str] = None, auto: bool = False):
        """Model, momentum, epoch, iter and the step's LR counter from
        ``path`` or, with ``auto``, from the work dir's newest checkpoint
        (none there: start from scratch)."""
        path = path or (self.ckpt.latest_path() if auto else None)
        if path is None:
            self.logger.info(f"no checkpoint in {self.work_dir} to resume from")
            return
        ckpt = Checkpointer.load(path)
        self.model.load_state_dict(model_state_dict(ckpt), strict=True)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        meta = ckpt.get("meta", {})
        self.epoch = int(meta.get("epoch", 0))
        self.iter = self.step.t = int(meta.get("iter", 0))
        self.logger.info(f"resumed from {path}: epoch {self.epoch}, iter {self.iter}")

    def load_weights(self, ckpt: Dict[str, Any]) -> Dict[str, List[str]]:
        """``load_from``: the weights of a checkpoint (the port's, or a
        published mmdet one) or state dict alone, grafted by
        ``load_mmdet_checkpoint`` (its report is returned and logged; a
        detector checkpoint lacking a tensor raises); epoch, iter and the
        optimizer's state stay fresh."""
        from ..utils.checkpoint import load_mmdet_checkpoint
        return load_mmdet_checkpoint(self.model, ckpt, self.logger)

    # ---------------- loops ----------------

    def train_epoch(self):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(self.epoch)
        window: List[Dict[str, float]] = []
        n = len(self.loader)
        t_data = time.perf_counter()
        for i, batch in enumerate(self.loader):
            arrs = upload_train_batch(batch, self.device)
            data_time = time.perf_counter() - t_data
            t0 = time.perf_counter()
            lr = self.lr_fn(self.step.t)
            scal = fetch_log_vars(self.step(arrs, step_generator(self.seed, self.iter,
                                                                 self.device, self.rank)))
            step_time = time.perf_counter() - t0
            self.iter += 1
            if not math.isfinite(scal["loss"]):
                raise FloatingPointError(f"non-finite loss at iter {self.iter}: {scal}")
            scal["time"] = step_time
            scal["data_time"] = data_time
            window.append(scal)
            self.call_hooks("after_train_iter", scal)
            if (i + 1) % self.log_interval == 0:
                avg = {k: float(np.mean([w[k] for w in window])) for k in window[0]}
                self.logger.info(f"Epoch [{self.epoch + 1}][{i + 1}/{n}] lr: {lr:.3e}, "
                                 + ", ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
                self._write_json(dict(mode="train", epoch=self.epoch + 1, iter=self.iter,
                                      lr=lr, **avg))
                window.clear()
            t_data = time.perf_counter()

    def _write_json(self, entry: Dict[str, Any]):
        if self.rank != 0:
            return
        with open(self.json_log, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def run(self):
        self.logger.info(f"Start training: {self.max_epochs} epochs, "
                         f"{len(self.loader)} iters/epoch, from epoch {self.epoch}")
        self.call_hooks("before_run")
        while self.epoch < self.max_epochs:
            self.call_hooks("before_train_epoch")
            self.train_epoch()
            self.call_hooks("after_train_epoch")
            self.epoch += 1
            if self.epoch % self.ckpt_interval == 0:
                self.save()
            if self.val_loader is not None and self.val_dataset is not None:
                metrics = self.evaluate()
                self.logger.info(f"Epoch {self.epoch} eval: {metrics}")
                self._write_json(dict(mode="val", epoch=self.epoch, **metrics))
                self.call_hooks("after_val_epoch", metrics)
        self.call_hooks("after_run")

    def evaluate(self, metric=None) -> Dict[str, Any]:
        """The val set through the test step (``multi_gpu_test``: under data
        parallel each rank runs its slice and every rank gets the whole set's
        results), scored by the val dataset's ``evaluate`` with ``metric`` or
        ``evaluation.metric``."""
        from ..apis.inference import _num_classes
        from ..apis.test import multi_gpu_test
        results = multi_gpu_test(dict(test_fn=self.test_fn, num_classes=_num_classes(self.cfg)),
                                 self.val_loader)
        self.last_val_results = results
        kwargs = {}
        ev = dict(self.cfg.get("evaluation") or {})
        if metric or ev.get("metric"):
            kwargs["metric"] = metric or ev["metric"]
        return self.val_dataset.evaluate(results, **kwargs)
