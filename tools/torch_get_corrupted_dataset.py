"""Write a corrupted copy of a test set with the PyTorch port (the
counterpart of ``tools/analysis_tools/get_corrupted_dataset.py``, with its
arguments): ``<out>/<corruption>/<severity>/<file name>`` for every image
of the config's test set.

    python tools/torch_get_corrupted_dataset.py CONFIG --out DIR
        [--corruptions benchmark|...|NAME ...] [--severities 1 2 3 4 5]
        [--cfg-options key=value ...]

Images are read with the port's ``imread`` and written as PNG by its
``imwrite``; the port has no JPEG writer, so a file name that does not end
in ``.png`` stops the tool before it writes anything. Image ``i`` of a cell
draws from the generator the ``Corrupt`` op gives it (``sample_seed(i,
corruption, severity)``), so ``tools/torch_test_robustness.py
--load-dataset corrupted`` on the copy sees the images its on-the-fly cells
see.
"""
import argparse
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.data import build_dataset
from oadg_tpu_torch.data.pipelines.image_io import imread, imwrite
from oadg_tpu_torch.ops.corruptions import corrupt_numpy, sample_seed
from torch_test_robustness import resolve_corruptions


def main(argv=None):
    p = argparse.ArgumentParser(description="generate a corrupted dataset (PyTorch port)")
    p.add_argument("config")
    p.add_argument("--out", required=True)
    p.add_argument("--corruptions", nargs="+", default=["benchmark"])
    p.add_argument("--severities", nargs="+", type=int, default=[1, 2, 3, 4, 5])
    p.add_argument("--cfg-options", nargs="+", action=DictAction)
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)
    tc = dict(cfg["data"]["test"])
    tc["test_mode"] = True
    tc["pipeline"] = [dict(type="LoadImageFromFile")]
    dataset = build_dataset(tc)
    names = [info["filename"] for info in dataset.data_infos]
    not_png = [n for n in names if not n.lower().endswith(".png")]
    if not_png:
        raise ValueError(f"{len(not_png)} images (first {not_png[0]!r}) are not PNG: the "
                         "port writes PNG only and has no JPEG writer")
    for corr in resolve_corruptions(args.corruptions):
        for sev in args.severities:
            for i, name in enumerate(names):
                img = imread(osp.join(dataset.img_prefix, name))
                out = corrupt_numpy(img, corr, sev,
                                    rng=np.random.RandomState(sample_seed(i, corr, sev)))
                dst = osp.join(args.out, corr, str(sev), name)
                os.makedirs(osp.dirname(dst), exist_ok=True)
                imwrite(dst, out)
            print(f"{corr}/{sev}: {len(names)} images", flush=True)


if __name__ == "__main__":
    main()
