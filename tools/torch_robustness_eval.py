"""Aggregate a robustness pickle into P / mPC / rPC (the counterpart of
``tools/analysis_tools/robustness_eval.py``, with its arguments).

    python tools/torch_robustness_eval.py RESULTS.pkl [--dataset coco|voc]
        [--metric bbox_mAP]

``RESULTS.pkl`` is what ``tools/torch_test_robustness.py`` writes:
``{corruption: {severity: {metric: value}}}``. P is the clean score (the
first benchmark corruption's severity 0), mPC the mean over the benchmark
corruptions present and severities 1-5, rPC = mPC / P (0 when P is 0). A
missing cell counts as 0.
"""
import argparse
import os.path as osp
import pickle
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from oadg_tpu_torch.ops.corruptions import BENCHMARK_CORRUPTIONS


def get_results(filename, dataset="coco", task="bbox", metric=None, prints="mPC",
                aggregate="benchmark"):
    """-> ``dict(P, mPC, rPC, results, corruptions)``; ``results`` is the
    (corruptions, 6 severities) table of ``metric``."""
    with open(filename, "rb") as f:
        agg = pickle.load(f)
    metric = metric or ("bbox_mAP" if dataset == "coco" else "mAP")
    corruptions = [c for c in BENCHMARK_CORRUPTIONS if c in agg]
    results = np.zeros((len(corruptions), 6))
    for ci, corr in enumerate(corruptions):
        for sev in range(6):
            cell = agg.get(corr, {}).get(sev)
            if cell is not None:
                results[ci, sev] = cell.get(metric, 0.0)
    p = results[0, 0]
    mpc = float(np.mean(results[:, 1:]))
    rpc = mpc / p if p > 0 else 0.0
    if prints:
        print(f"P (clean {metric}): {p:.4f}")
        print(f"mPC ({len(corruptions)} corruptions, sev 1-5): {mpc:.4f}")
        print(f"rPC: {rpc:.4f}")
        for ci, corr in enumerate(corruptions):
            print(f"  {corr}: {np.mean(results[ci, 1:]):.4f}")
    return dict(P=p, mPC=mpc, rPC=rpc, results=results, corruptions=corruptions)


def main(argv=None):
    p = argparse.ArgumentParser(description="robustness aggregation")
    p.add_argument("filename", help="results pickle from tools/torch_test_robustness.py")
    p.add_argument("--dataset", default="coco", choices=["coco", "voc"])
    p.add_argument("--task", default="bbox")
    p.add_argument("--metric", default=None)
    args = p.parse_args(argv)
    return get_results(args.filename, dataset=args.dataset, task=args.task,
                       metric=args.metric)


if __name__ == "__main__":
    main()
