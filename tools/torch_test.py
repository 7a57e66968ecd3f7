"""Test a detector with the PyTorch port (the counterpart of ``tools/test.py``):
run the config's test set through the detector on the card and score it.

    python tools/torch_test.py CONFIG CHECKPOINT [--eval bbox] [--out results.pkl]
        [--cfg-options data.test.ann_file=...] [--device cuda|cpu]

``CHECKPOINT`` is a ``torch.save``d ``state_dict`` of the port's model, or
``none`` for seeded random weights. ``--eval bbox`` prints the COCO summary;
``--out`` pickles the per-image per-class detections. The model runs on the
card unless ``--device cpu``.
"""
import argparse
import os.path as osp
import pickle
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
from oadg_tpu_torch.config import DictAction, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a torch.save'd state_dict, or 'none'")
    p.add_argument("--out", help="output result pickle")
    p.add_argument("--eval", nargs="+", help="evaluation metrics, e.g. bbox")
    p.add_argument("--show-dir", help="directory for drawn detections")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.show_dir:
        sys.exit("--show-dir: drawing detections needs core/visualization, which "
                 "the port has not yet (ROADMAP A, 'Long tail')")
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    dataset, loader = build_test_loader(cfg, pin_memory=args.device.startswith("cuda"))
    model_state = load_model_state(cfg, args.checkpoint, device=args.device)
    results = single_gpu_test(model_state, loader, progress=True)
    metrics = None
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        print(f"wrote {args.out}")
    if args.eval:
        metrics = dataset.evaluate(results, metric=args.eval)
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
