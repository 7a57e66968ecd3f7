"""Corruption robustness benchmark with the PyTorch port (the counterpart of
``tools/analysis_tools/test_robustness.py``, with its arguments): for each
(corruption, severity) cell, test the detector on the config's test set with
a ``Corrupt`` op at pipeline position 1, score it, add the cell to a pickle,
then print P / mPC / rPC.

    python tools/torch_test_robustness.py CONFIG CHECKPOINT
        [--corruptions benchmark|all|holdout|noise|blur|weather|digital|NAME ...]
        [--severities 0 1 2 3 4 5] [--out robustness_results.pkl] [--eval bbox]
        [--load-dataset corrupted [--corrupted-root DIR]]
        [--cfg-options key=value ...] [--device cuda|cpu]
        [--launcher none|pytorch|slurm|mpi]

``CHECKPOINT`` is a ``torch.save``d ``state_dict`` of the port's model, or
``none`` for seeded random weights. The model is built once; each cell
builds its own loader. Severity 0 (the clean set) is evaluated once and its
scores are reused for every corruption. ``--load-dataset corrupted`` reads
the cell's images from ``<root>-c/<corruption>/<severity>/`` instead (as
``tools/torch_get_corrupted_dataset.py`` writes them; ``<root>`` is the test
set's ``img_prefix`` unless ``--corrupted-root``). The pickle,
``{corruption: {severity: {metric: value}}}``, is rewritten after every
cell. Each image of a cell is corrupted from its own seeded generator
(``ops/corruptions.py`` ``sample_seed``), so a cell is the same in every
run. The model runs on the card unless ``--device cpu``. With
``--launcher`` each process joins the launcher's group and tests its slice
of every cell (``multi_gpu_test``); rank 0 alone writes the pickle and
prints.
"""
import argparse
import copy
import os
import os.path as osp
import pickle
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

import torch  # noqa: E402

from oadg_tpu_torch.apis import build_test_loader, load_model_state, multi_gpu_test
from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.parallel import join_launcher
from oadg_tpu_torch.ops.corruptions import (BENCHMARK_CORRUPTIONS, CORRUPTIONS,
                                            HOLDOUT_CORRUPTIONS)
from torch_robustness_eval import get_results

CORRUPTION_SETS = {
    "benchmark": BENCHMARK_CORRUPTIONS,
    "all": list(CORRUPTIONS),
    "holdout": HOLDOUT_CORRUPTIONS,
    "noise": ["gaussian_noise", "shot_noise", "impulse_noise"],
    "blur": ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur"],
    "weather": ["snow", "frost", "fog", "brightness"],
    "digital": ["contrast", "elastic_transform", "pixelate", "jpeg_compression"],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="corruption robustness benchmark (PyTorch port)")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a torch.save'd state_dict, or 'none'")
    p.add_argument("--corruptions", nargs="+", default=["benchmark"])
    p.add_argument("--severities", nargs="+", type=int, default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--out", default="robustness_results.pkl")
    p.add_argument("--eval", nargs="+", default=["bbox"])
    p.add_argument("--load-dataset", default=None, choices=[None, "corrupted"],
                   help="'corrupted': read <root>-c/<corruption>/<severity>/")
    p.add_argument("--corrupted-root", default=None)
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none", choices=["none", "pytorch", "slurm", "mpi"])
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def resolve_corruptions(names):
    """Set names and corruption names -> corruptions, in order, once each."""
    out = []
    for n in names:
        out.extend(CORRUPTION_SETS.get(n, [n]))
    seen = set()
    return [c for c in out if not (c in seen or seen.add(c))]


def cell_test_cfg(test_cfg, corruption, severity, load_dataset=None, corrupted_root=None):
    """The test set of one cell: the clean one at severity 0; the images of
    a corrupted copy with ``load_dataset='corrupted'``; otherwise a
    ``Corrupt`` op at pipeline position 1."""
    test_cfg = copy.deepcopy(dict(test_cfg))
    if severity == 0:
        return test_cfg
    if load_dataset == "corrupted":
        root = corrupted_root or (str(test_cfg["img_prefix"]).rstrip("/" + os.sep) + "-c")
        test_cfg["img_prefix"] = osp.join(root, corruption, str(severity)) + os.sep
    else:
        pipeline = list(test_cfg["pipeline"])
        pipeline.insert(1, dict(type="Corrupt", corruption=corruption, severity=severity))
        test_cfg["pipeline"] = pipeline
    return test_cfg


def main(argv=None):
    args = parse_args(argv)
    rank, device = 0, args.device
    if args.launcher != "none":
        rank, device = join_launcher(args.launcher, args.device, args.local_rank)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    corruptions = resolve_corruptions(args.corruptions)
    unknown = [c for c in corruptions if c not in CORRUPTIONS]
    if unknown:
        sys.exit(f"unknown corruptions {unknown}; sets: {sorted(CORRUPTION_SETS)}")
    model_state = load_model_state(cfg, args.checkpoint, device=device)
    aggregated, clean_cell = {}, None
    images, seconds = 0, 0.0
    for corr in corruptions:
        aggregated.setdefault(corr, {})
        for severity in args.severities:
            if severity == 0 and clean_cell is not None:
                aggregated[corr][0] = clean_cell           # evaluated once
                continue
            cell_cfg = copy.deepcopy(cfg)
            cell_cfg["data"]["test"] = cell_test_cfg(cfg["data"]["test"], corr, severity,
                                                     args.load_dataset, args.corrupted_root)
            dataset, loader = build_test_loader(cell_cfg,
                                                pin_memory=args.device.startswith("cuda"))
            t0 = time.perf_counter()
            results = multi_gpu_test(model_state, loader)    # single_gpu_test's in one process
            dt = time.perf_counter() - t0
            images, seconds = images + len(results), seconds + dt
            metrics = dataset.evaluate(results, metric=args.eval)    # every rank: same cells
            metrics = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
            aggregated[corr][severity] = metrics
            if severity == 0:
                clean_cell = metrics
            if rank:
                continue
            print(f"\n[{corr} sev {severity}] {metrics} ({len(results)} images in {dt:.3f} s)",
                  flush=True)
            with open(args.out, "wb") as f:
                pickle.dump(aggregated, f)
    if rank:
        return None
    if seconds:
        print(f"sweep: {images} images in {seconds:.3f} s of test loops, "
              f"{images / seconds:.3f} images/s")
    return get_results(args.out, dataset="coco",
                       metric="bbox_mAP" if "bbox" in args.eval else "mAP")


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
