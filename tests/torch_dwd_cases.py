"""Tiny Diverse Weather Dataset (DWD) fixtures for the CPU tests of the DWD
path (``test_torch_dwd.py``).

``tiny_dwd_model`` shrinks the DWD OA-DG config's R101-DC5 Faster R-CNN
(``configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py``) in place: the
caffe-style ResNet at ``base_channels=8`` (its stride-16 ``layer4`` then has
256 channels, the RPN's and the RoI extractor's input), a 16-wide RPN tower,
a 32-wide box head, small proposal budgets. ``write_voc_domain`` writes one
VOC2007-layout domain (``JPEGImages/*.jpg``, ``Annotations/*.xml``,
``ImageSets/Main/<split>.txt``) whose objects carry the cases the datasets
sort out: difficult flags, a class the dataset does not know, a box under
``min_size``, an image without objects, XMLs without a size. ``tiny_dwd_cfg`` points the DWD
config's train, val and test sets at such domains. The module imports no
JAX.
"""
import os
import textwrap

import numpy as np

DWD = "configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py"
SDGOD_CLASSES = ("bus", "bike", "car", "motor", "person", "rider", "truck")
SIZES = ((64, 96), (60, 96), (72, 96), (64, 88))
TRAIN_SCALES = [(96, 48), (96, 64)]      # Resize range mode: long edge 96, short 48-64
TEST_SCALE = (96, 64)


def tiny_dwd_model(model, depth=50):
    """``model`` (the DWD OA-DG config's) made tiny in place, its backbone
    seeded (the config's model-zoo ``init_cfg`` dropped)."""
    model["backbone"].update(depth=depth, base_channels=8, stem_channels=8, init_cfg=None)
    model["rpn_head"].update(in_channels=256, feat_channels=16)
    model["roi_head"]["bbox_roi_extractor"].update(out_channels=256)
    model["roi_head"]["bbox_head"].update(in_channels=256, fc_out_channels=32)
    model["roi_head"]["bbox_head"]["cont_predictor_cfg"] = dict(
        num_linear=2, feat_channels=16, return_relu=True)
    model["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                              nms=dict(iou_threshold=0.7), min_bbox_size=0)
    model["train_cfg"]["rpn"]["sampler"]["num"] = 32
    model["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    return model


def textured_image(rng, h, w):
    """A smooth colour texture plus noise: compresses like a photograph."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / rng.uniform(5, 11)) + np.cos(yy / rng.uniform(4, 9))) * 60 + 128
    base = np.stack([base, np.roll(base, 7, 0), np.roll(base, 11, 1)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _object(name, box, difficult=None):
    diff = "" if difficult is None else f"<difficult>{difficult}</difficult>"
    x1, y1, x2, y2 = box
    return (f"<object><name>{name}</name>{diff}<bndbox><xmin>{x1}</xmin><ymin>{y1}"
            f"</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")


def write_voc_domain(root, name, imwrite, seed=0, sizes=SIZES, split="test", sizeless=()):
    """Write one domain under ``root/name/VOC2007`` with ``imwrite(path,
    img)`` (a JPEG writer) -> its ``img_prefix`` (with a trailing ``/``).

    Image 0 has no object (filtered out of a train set), every other image
    3-5 objects of the 7 classes, the first of them difficult, one of class
    ``dog`` (not a DWD class), one 3 px wide (ignored under ``min_size=5``);
    the XMLs of the images in ``sizeless`` have no ``size``."""
    rng = np.random.RandomState(seed)
    dom = os.path.join(root, name, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(dom, sub), exist_ok=True)
    ids = []
    for i, (h, w) in enumerate(sizes):
        img_id = f"{name}_{i:03d}"
        ids.append(img_id)
        imwrite(os.path.join(dom, "JPEGImages", f"{img_id}.jpg"), textured_image(rng, h, w))
        objects = []
        for k in range(0 if i == 0 else int(rng.randint(3, 6))):
            bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
            x, y = rng.randint(1, w - bw), rng.randint(1, h - bh)
            cls = SDGOD_CLASSES[rng.randint(len(SDGOD_CLASSES))]
            objects.append(_object(cls, (x, y, x + bw, y + bh),
                                   difficult=1 if k == 0 else (0 if k % 2 else None)))
        if i:
            objects.append(_object("dog", (2, 2, 20, 20), 0))
            objects.append(_object(SDGOD_CLASSES[i % 7], (5, 6, 8, 30), 0))
        size = "" if i in sizeless else (
            f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>")
        with open(os.path.join(dom, "Annotations", f"{img_id}.xml"), "w") as f:
            f.write(textwrap.dedent(f"""\
                <annotation><filename>{img_id}.jpg</filename>{size}
                {''.join(objects)}</annotation>"""))
    with open(os.path.join(dom, "ImageSets", "Main", f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return dom + "/"


def ann_file(img_prefix, split="test"):
    return os.path.join(img_prefix, "ImageSets", "Main", f"{split}.txt")


def tiny_dwd_cfg(root, imwrite, domains=("daytime_clear", "night_sunny"), **options):
    """The DWD OA-DG config at a tiny size: the tiny model; the first
    domain (as a train split) for training through ``RepeatDataset`` times
    2, the train pipeline's ``Resize`` over ``TRAIN_SCALES`` (range mode,
    canvas 64x96); every domain a test set and the first the val set at
    ``TEST_SCALE``; batches of 2 from one loader thread, 16 gts a batch row,
    one epoch logged every iteration; ``options`` merged last."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(DWD)
    tiny_dwd_model(cfg["model"])
    prefixes = [write_voc_domain(str(root), d, imwrite, seed=i)
                for i, d in enumerate(domains)]
    write_voc_domain(str(root), domains[0], imwrite, seed=0, split="train")
    test = []
    for d, p in zip(domains, prefixes):
        dom = dict(cfg["data"]["val"], ann_file=ann_file(p), img_prefix=p, domain=d)
        dom["pipeline"][1]["img_scale"] = TEST_SCALE
        test.append(dom)
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1,
            "data.train.dataset.ann_file": ann_file(prefixes[0], "train"),
            "data.train.dataset.img_prefix": prefixes[0],
            "data.train.dataset.pipeline.2.img_scale": list(TRAIN_SCALES),
            "data.val.ann_file": ann_file(prefixes[0]), "data.val.img_prefix": prefixes[0],
            "data.val.pipeline.1.img_scale": TEST_SCALE,
            "max_gt": 16, "runner.max_epochs": 1, "log_config.interval": 1}
    opts.update(options)
    cfg.merge_from_dict(opts)
    cfg["data"]["test"] = test
    return cfg
