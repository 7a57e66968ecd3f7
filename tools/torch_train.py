"""Train a detector with the PyTorch port (the counterpart of ``tools/train.py``,
with its arguments): the config's train set through the detector on the
card, a checkpoint after each epoch and, unless ``--no-validate``, an
evaluation on the val set.

    python tools/torch_train.py CONFIG [--work-dir DIR] [--resume-from CKPT]
        [--auto-resume] [--no-validate] [--seed N] [--deterministic]
        [--cfg-options key=value ...] [--gpu-id N] [--device cuda|cpu]
        [--launcher none|pytorch|slurm|mpi]

The weights start from the seed (``init_detector``), then from the config's
backbone ``init_cfg``, ``resume_from`` / ``--auto-resume`` or ``load_from``.
The work dir (default ``./work_dirs/<config name>``) receives the config,
the text log ``train.log``, ``log.json`` and ``epoch_{n}.pth`` (``meta``, ``state_dict``,
``optimizer``) with ``latest.pth``; ``tools/torch_test.py CONFIG
epoch_{n}.pth`` scores such a file. The model runs on the card unless
``--device cpu``. A bfloat16 model is trained through the API:
``train_detector(init_detector(cfg, ..., dtype=torch.bfloat16).model, ...)``.

Data parallel: ``--launcher pytorch`` (or ``slurm``, ``mpi``) joins the
process group its launcher started (``parallel.init_distributed``: NCCL,
one card a process at its local rank; gloo with ``--device cpu``) and
trains the global batch of ``samples_per_gpu`` images a rank; rank 0
writes the work dir. ``tools/torch_dist_train.sh CONFIG GPUS [args]``
starts GPUS processes through ``torch.distributed.run``.
"""
import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402

from oadg_tpu_torch.apis import (init_detector, init_random_seed, set_random_seed,
                                 train_detector)
from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.data import build_dataset
from oadg_tpu_torch.engine.runner import get_root_logger
from oadg_tpu_torch.parallel import join_launcher


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--resume-from")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none", choices=["none", "pytorch", "slurm", "mpi"])
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--gpu-id", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    distributed = args.launcher != "none"
    rank, device = 0, (f"cuda:{args.gpu_id}" if args.device == "cuda" else args.device)
    if distributed:
        rank, device = join_launcher(args.launcher, args.device, args.local_rank)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    elif not cfg.get("work_dir"):
        cfg["work_dir"] = osp.join("./work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(cfg["work_dir"], exist_ok=True)
    cfg["resume_from"] = args.resume_from or cfg.get("resume_from")
    cfg["auto_resume"] = args.auto_resume

    logger = get_root_logger(cfg["work_dir"])
    seed = init_random_seed(args.seed if args.seed is not None else cfg.get("seed"))
    set_random_seed(seed, deterministic=args.deterministic)
    cfg["seed"] = seed
    logger.info(f"Set random seed to {seed}")
    if rank == 0:
        cfg.dump(osp.join(cfg["work_dir"], osp.basename(args.config)))

    num_views = int(cfg.get("num_views", 1) or 1)
    model = init_detector(cfg, device=device, seed=seed, num_views=num_views).model
    dataset = build_dataset(dict(cfg["data"]["train"]))
    return train_detector(model, dataset, cfg, distributed=distributed,
                          validate=not args.no_validate, work_dir=cfg["work_dir"])


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
