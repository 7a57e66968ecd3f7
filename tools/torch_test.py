"""Test a detector with the PyTorch port (the counterpart of ``tools/test.py``):
run the config's test set through the detector on the card and score it.

    python tools/torch_test.py CONFIG CHECKPOINT [--eval bbox] [--out results.pkl]
        [--cfg-options data.test.ann_file=...] [--device cuda|cpu]
        [--launcher none|pytorch|slurm|mpi]

``CHECKPOINT`` is a ``torch.save``d ``state_dict`` of the port's model, or
``none`` for seeded random weights. ``--eval bbox`` prints the COCO summary;
``--out`` pickles the per-image per-class detections. The model runs on the
card unless ``--device cpu``.

With ``--launcher`` (``tools/torch_dist_test.sh CONFIG CHECKPOINT GPUS
[args]``) each process joins the launcher's group, tests its slice of the
images (``multi_gpu_test``) and gets the whole set's results; rank 0 alone
writes ``--out`` and prints the metrics.
"""
import argparse
import os.path as osp
import pickle
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402

from oadg_tpu_torch.apis import build_test_loader, load_model_state, multi_gpu_test
from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.parallel import join_launcher


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a torch.save'd state_dict, or 'none'")
    p.add_argument("--out", help="output result pickle")
    p.add_argument("--eval", nargs="+", help="evaluation metrics, e.g. bbox")
    p.add_argument("--show-dir", help="directory for drawn detections")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--launcher", default="none", choices=["none", "pytorch", "slurm", "mpi"])
    p.add_argument("--local_rank", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.show_dir:
        sys.exit("--show-dir: drawing detections needs core/visualization, which "
                 "the port has not yet (ROADMAP A, 'Long tail')")
    rank, device = 0, args.device
    if args.launcher != "none":
        rank, device = join_launcher(args.launcher, args.device, args.local_rank)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    dataset, loader = build_test_loader(cfg, pin_memory=args.device.startswith("cuda"))
    model_state = load_model_state(cfg, args.checkpoint, device=device)
    results = multi_gpu_test(model_state, loader, progress=True)   # single_gpu_test's in one process
    metrics = None
    if rank != 0:
        return metrics
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        print(f"wrote {args.out}")
    if args.eval:
        metrics = dataset.evaluate(results, metric=args.eval)
        print(metrics)
    return metrics


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
