"""The training API (port of ``oadg_tpu/apis/train.py:20-155``):
``init_random_seed``, ``set_random_seed`` and ``train_detector``, which
builds the train loader, the OA-Mix preprocess, the val loader, the runner
and its starting point (backbone init, ``resume_from``, ``auto_resume``,
``load_from``; ``build_runner``), then runs it, in one process or data
parallel over a ``torch.distributed`` group (``:95-106``).
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from ..data import build_dataloader, build_dataset, static_hw_from_pipeline
from ..engine.preprocess import make_oadg_preprocess
from ..engine.runner import Checkpointer, EpochBasedRunner, get_root_logger, model_state_dict
from ..parallel import broadcast_state, is_distributed
from .test import build_test_loader

_REMOTE = ("http://", "https://", "open-mmlab://", "torchvision://", "modelzoo://", "mmcls://")


def init_random_seed(seed: Optional[int] = None) -> int:
    """``seed``, or a random one below 2**31 when None; under data parallel
    rank 0's, broadcast (the ranks must shuffle alike)."""
    if seed is not None:
        return seed
    seed = int(np.random.randint(2 ** 31))
    if is_distributed():
        box = [seed]
        torch.distributed.broadcast_object_list(box, src=0)
        seed = int(box[0])
    return seed


def set_random_seed(seed: int, deterministic: bool = False):
    """Seed numpy's, Python's and torch's global generators (the pipeline's
    ``Resize`` and ``RandomFlip`` draw from numpy's); ``deterministic`` also
    makes cuDNN pick deterministic algorithms."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def _find_pipeline_op(pipeline, op_type: str):
    return next((p for p in pipeline or [] if isinstance(p, dict)
                 and p.get("type") == op_type), None)


def _checkpoint_file(path: str, what: str) -> str:
    if str(path).startswith(_REMOTE):
        raise NotImplementedError(f"{what} {path!r}: the port reads checkpoint files on "
                                  "disk; model-zoo names and URLs wait for "
                                  "utils/model_zoo.py (ROADMAP A, 'Long tail')")
    return str(path)


def load_backbone_weights(model: torch.nn.Module, path: str, logger=None):
    """The backbone's tensors from a checkpoint file (a state dict, or one
    under ``"state_dict"``; keys with or without the ``backbone.`` prefix):
    every key the backbone has with the same shape is loaded, the rest is
    reported (mmcv's ``Pretrained`` init loads non-strictly too)."""
    sd = model_state_dict(torch.load(_checkpoint_file(path, "backbone init_cfg"),
                                     map_location="cpu", weights_only=True))
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()}
    own = model.backbone.state_dict()
    take = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.backbone.load_state_dict(take, strict=False)
    if logger is not None:
        logger.info(f"backbone from {path}: {len(take)} of {len(own)} tensors loaded; "
                    f"{len(set(own) - set(take))} missing, {len(set(sd) - set(take))} "
                    "unused")


def train_detector(model: torch.nn.Module, dataset, cfg, distributed: bool = False,
                   validate: bool = False, timestamp=None, meta=None,
                   work_dir: Optional[str] = None) -> EpochBasedRunner:
    """Train ``model`` (``init_detector(cfg, num_views=..., dtype=...).model``,
    on the device it is to train on) on ``dataset`` (built, or its config)
    as ``cfg`` says, evaluating on ``cfg.data.val`` after each epoch with
    ``validate``. -> the runner, after its run.

    ``distributed=True`` trains data parallel over the process group that
    ``parallel.init_distributed`` joined (every rank calls this): each rank
    loads its slice of the batches (``samples_per_gpu`` images a rank),
    the step computes the JAX package's global-batch step, rank 0 writes
    the work dir. It must agree with whether a group is initialized."""
    if bool(distributed) != is_distributed():
        raise ValueError(f"train_detector(distributed={distributed}) with "
                         f"{'a' if is_distributed() else 'no'} process group: call "
                         "parallel.init_distributed first, or pass distributed="
                         f"{is_distributed()}")
    runner = build_runner(model, dataset, cfg, validate=validate, work_dir=work_dir)
    runner.run()
    return runner


def build_runner(model: torch.nn.Module, dataset, cfg, validate: bool = False,
                 work_dir: Optional[str] = None) -> EpochBasedRunner:
    """``train_detector``'s runner before its run: the train loader (pinned
    batches on the card), the OA-Mix preprocess when the pipeline has an
    ``OAMix`` op, the val loader with ``validate``, and the starting point
    (the backbone's ``init_cfg``, then ``resume_from``, ``auto_resume`` or
    ``load_from``), broadcast from rank 0 under data parallel."""
    work_dir = work_dir or cfg.get("work_dir") or "./work_dirs/default"
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(work_dir)
    if isinstance(dataset, dict):
        dataset = build_dataset(dataset)
    device = next(model.parameters()).device
    pin = device.type == "cuda"

    data_cfg = dict(cfg["data"])
    train_cfg = dict(data_cfg["train"])
    pipeline = train_cfg.get("pipeline") or dict(train_cfg.get("dataset") or {}).get("pipeline")
    loader = build_dataloader(
        dataset, samples_per_gpu=int(data_cfg.get("samples_per_gpu", 2)),
        workers_per_gpu=int(data_cfg.get("workers_per_gpu", 2)),
        seed=cfg.get("seed", 0), static_hw=static_hw_from_pipeline(pipeline),
        max_gt=int(cfg.get("max_gt", 128)), pin_memory=pin)

    preprocess = None
    oamix_op = _find_pipeline_op(pipeline, "OAMix")
    if oamix_op is not None:
        preprocess = make_oadg_preprocess(dict(oamix_op),
                                          dict(_find_pipeline_op(pipeline, "Normalize") or {}),
                                          out_dtype=getattr(model, "dtype", None))
        logger.info("OA-Mix runs on the card inside the train step")

    val_dataset = val_loader = None
    if validate:
        val_dataset, val_loader = build_test_loader(cfg, pin_memory=pin, split="val")

    runner = EpochBasedRunner(model, cfg, loader, work_dir, val_dataset=val_dataset,
                              val_loader=val_loader, preprocess=preprocess, logger=logger,
                              seed=int(cfg.get("seed", 0) or 0))
    model_cfg = dict(cfg.get("model") or {})
    init_cfg = dict(dict(model_cfg.get("backbone") or {}).get("init_cfg") or {})
    pretrained = (init_cfg.get("checkpoint") if init_cfg.get("type") == "Pretrained"
                  else None) or model_cfg.get("pretrained")
    if pretrained:
        load_backbone_weights(model, pretrained, logger)
    if cfg.get("resume_from"):
        runner.resume(_checkpoint_file(cfg["resume_from"], "resume_from"))
    elif cfg.get("auto_resume"):
        runner.resume(auto=True)
    elif cfg.get("load_from"):
        runner.load_weights(Checkpointer.load(_checkpoint_file(cfg["load_from"], "load_from")))
    broadcast_state(model)
    return runner
