"""Test a detector on the Diverse Weather Dataset's domains with the PyTorch
port (the counterpart of ``tools/test_dwd.py``): each dataset config of the
config's ``data.test`` list (an ``SdgodDataset`` per weather domain) runs
through the detector on the card and is scored with VOC mAP.

    python tools/torch_test_dwd.py CONFIG CHECKPOINT [--out-dir DIR]
        [--cfg-options key=value ...] [--device cuda|cpu]

``CHECKPOINT`` is a ``torch.save``d ``state_dict`` of the port's model, or
``none`` for seeded random weights. A domain is named by its config's
``domain`` key or the basename of its ``img_prefix``. ``DIR/dwd_results.json``
(default ``.``) receives each domain's metrics (``mAP`` and ``AP_<class>``)
and ``mean_mAP``, their mean. The model runs on the card unless ``--device
cpu``. With ``--launcher`` each process joins the launcher's group and tests
its slice of each domain (``multi_gpu_test``); rank 0 alone prints and
writes the results.
"""
import argparse
import json
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402

from oadg_tpu_torch.apis import build_test_loader, load_model_state, multi_gpu_test
from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.parallel import join_launcher


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test on the Diverse Weather domains "
                                            "with the PyTorch port")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a torch.save'd state_dict, or 'none'")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--eval", nargs="+", default=["mAP"],
                   help="tools/test_dwd.py's option; VOC mAP is the only metric")
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    p.add_argument("--launcher", default="none", choices=["none", "pytorch", "slurm", "mpi"])
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def domain_name(dom_cfg) -> str:
    """The ``domain`` key, else the basename of ``img_prefix``."""
    dom_cfg = dict(dom_cfg)
    return dom_cfg.get("domain", osp.basename(str(dom_cfg.get("img_prefix",
                                                              "domain")).rstrip("/")))


def main(argv=None):
    args = parse_args(argv)
    rank, device = 0, args.device
    if args.launcher != "none":
        rank, device = join_launcher(args.launcher, args.device, args.local_rank)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    test_cfgs = cfg["data"]["test"]
    if isinstance(test_cfgs, dict):
        test_cfgs = [test_cfgs]
    model_state = load_model_state(cfg, args.checkpoint, device=device)
    pin = args.device.startswith("cuda")

    summary = {}
    for dom_cfg in test_cfgs:
        name = domain_name(dom_cfg)
        dataset, loader = build_test_loader(cfg, dom_cfg, pin_memory=pin)
        results = multi_gpu_test(model_state, loader)    # single_gpu_test's in one process
        if rank:
            continue
        metrics = dataset.evaluate(results, metric="mAP")
        summary[name] = metrics
        print(f"\n[{name}] {metrics}")
    if rank:
        return None

    maps = [m["mAP"] for m in summary.values()]
    if maps:
        summary["mean_mAP"] = sum(maps) / len(maps)
        print(f"\nmean mAP over {len(maps)} domains: {summary['mean_mAP']:.4f}")
    with open(osp.join(args.out_dir or ".", "dwd_results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
