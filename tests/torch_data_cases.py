"""A tiny COCO-json Cityscapes dataset on disk for the test and train paths'
CPU tests (``test_torch_data.py``, ``test_torch_eval.py``,
``test_torch_test_loop.py``, ``test_torch_train_loop.py``).

Four seeded BGR images written as PNG by ``cv2.imwrite`` with adaptive
filters, in two aspect ratios: with the test scale ``TEST_SCALE`` = (160, 96)
the 120x200 and 100x150 images are resized (by 0.8 and 0.96), the 80x160 and
96x160 ones are not. The annotation file holds the 8 Cityscapes classes
under their Cityscapes ids and one class that is not among them, crowd
boxes, an ``ignore`` box and boxes under 1 px, so that the datasets' filters
show. ``coco_fixture`` makes seeded evaluator inputs without files. The
module imports no JAX, so the card tests (``test_torch_cuda.py``) use it too.
"""
import json
import os

import numpy as np

SIZES = ((120, 200), (80, 160), (96, 160), (100, 150))
TRAIN_SIZES = ((64, 96), (60, 96), (64, 90), (56, 96))
TRAIN_SCALES = [(96, 48), (96, 64)]      # Resize range mode: long edge 96, short 48-64
TEST_SCALE = (160, 96)
CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
           "bicycle")
CAT_IDS = (24, 25, 26, 27, 28, 31, 32, 33)
FLAGSHIP = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"


def textured_image(rng, h, w):
    """A smooth colour texture plus noise: compresses like a photograph."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / rng.uniform(5, 11)) + np.cos(yy / rng.uniform(4, 9))) * 60 + 128
    base = np.stack([base, np.roll(base, 7, 0), np.roll(base, 11, 1)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_imwrite(path, img):
    import cv2
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])


def write_dataset(root, seed=0, sizes=SIZES, boxes_per_image=8, imwrite=_cv2_imwrite):
    """Write the images under ``root/leftImg8bit`` (with ``imwrite(path,
    img)``; OpenCV's adaptive filters by default) and the annotations to
    ``root/annotations.json`` -> (ann_file, img_prefix)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "leftImg8bit")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"city_{i:02d}_leftImg8bit.png"
        imwrite(os.path.join(img_dir, name), textured_image(rng, h, w))
        images.append(dict(id=100 + i, file_name=name, width=w, height=h))
        for k in range(boxes_per_image):
            bw, bh = rng.uniform(4, w / 2), rng.uniform(4, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append(dict(
                id=len(annotations) + 1, image_id=100 + i,
                category_id=int(CAT_IDS[rng.randint(len(CAT_IDS))]),
                bbox=[x, y, bw, bh], area=bw * bh, iscrowd=int(k == 5),
                **({"ignore": 1} if k == 6 else {})))
        annotations.append(dict(id=len(annotations) + 1, image_id=100 + i,
                                category_id=99, bbox=[1.0, 2.0, 10.0, 12.0],
                                area=120.0, iscrowd=0))
        annotations.append(dict(id=len(annotations) + 1, image_id=100 + i,
                                category_id=CAT_IDS[0], bbox=[3.0, 4.0, 0.5, 9.0],
                                area=4.5, iscrowd=0))
    categories = [dict(id=c, name=n) for c, n in zip(CAT_IDS, CLASSES)]
    categories.append(dict(id=99, name="license plate"))
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    return ann_file, img_dir + os.sep


def cfg_options(ann_file, img_prefix):
    """``--cfg-options`` that point the flagship's test set at the dataset
    and shrink the test scale to ``TEST_SCALE``."""
    return {"data.test.ann_file": ann_file, "data.test.img_prefix": img_prefix,
            "data.test.pipeline.1.img_scale": TEST_SCALE}


def tiny_model(cfg):
    """``cfg.model`` made tiny in place, as the JAX package's
    ``__graft_entry__._flagship_model_cfg(tiny=True)`` makes it (R18-FPN at
    16 channels, 32 sampled anchors and 16 rois an image), with a small
    test-time proposal budget."""
    m = cfg["model"]
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    m["rpn_head"].update(in_channels=16, feat_channels=16)
    m["roi_head"]["bbox_roi_extractor"].update(out_channels=16)
    m["roi_head"]["bbox_head"].update(in_channels=16, fc_out_channels=32)
    m["roi_head"]["bbox_head"]["cont_predictor_cfg"] = dict(
        num_linear=2, feat_channels=16, return_relu=True)
    m["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                          nms=dict(iou_threshold=0.7), min_bbox_size=0)
    m["train_cfg"]["rpn"]["sampler"]["num"] = 32
    m["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    m["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    m["test_cfg"]["rcnn"].update(max_per_img=10)
    return cfg


def tiny_train_cfg(root, imwrite=_cv2_imwrite, flip_ratio=0.5, scales=None, **options):
    """The flagship OA-DG config at a tiny size for training: the tiny model,
    the 4 images of ``TRAIN_SIZES`` written under ``root`` as its train, val
    and test sets (``RepeatDataset`` times 1), the flagship's train pipeline
    with ``Resize`` over ``scales`` (``TRAIN_SCALES``: range mode, canvas
    64x96) and ``RandomFlip(flip_ratio)``, the test scale (96, 64), batches
    of 2 from one loader thread, 16 gts a batch row, 2 epochs logged every
    iteration, a 3-iteration warmup; ``options`` are merged last
    (``--cfg-options`` keys)."""
    from oadg_tpu_torch.config import load_config
    ann_file, img_prefix = write_dataset(str(root), sizes=TRAIN_SIZES, imwrite=imwrite)
    cfg = tiny_model(load_config(FLAGSHIP))
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1, "data.train.times": 1,
            "data.train.dataset.ann_file": ann_file,
            "data.train.dataset.img_prefix": img_prefix,
            "data.train.dataset.pipeline.2.img_scale": list(scales or TRAIN_SCALES),
            "data.train.dataset.pipeline.3.flip_ratio": flip_ratio,
            "max_gt": 16, "runner.max_epochs": 2, "log_config.interval": 1,
            "lr_config.warmup_iters": 3}
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann_file, f"data.{split}.img_prefix": img_prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 64)})
    opts.update(options)
    cfg.merge_from_dict(opts)
    return cfg


def coco_fixture(seed, n_images=5, cats=(1, 2, 3), crowd=True):
    """(gts, results): per image {cat: (xywh (n, 4), iscrowd (n,))} and
    {cat: (m, 5) xywh + score}. Ground truth of every area range; the
    detections jitter it, miss some, and add false positives until one
    image holds more than 100 of a class; scores have ties."""
    rng = np.random.RandomState(seed)
    gts, results = [], []
    for i in range(n_images):
        g, r = {}, {}
        for c in cats:
            n = rng.randint(0, 9)
            wh = np.exp(rng.uniform(np.log(3), np.log(220), (n, 2)))
            xy = rng.uniform(0, 600, (n, 2))
            boxes = np.concatenate([xy, wh], 1)
            iscrowd = (rng.rand(n) < 0.15).astype(float) if crowd else np.zeros(n)
            g[c] = (boxes, iscrowd)
            keep = boxes[rng.rand(n) < 0.8]
            jit = keep + rng.normal(0, 0.08, keep.shape) * keep[:, [2, 3, 2, 3]]
            m = 110 if (i == 1 and c == cats[0]) else rng.randint(0, 20)
            fp = np.concatenate([rng.uniform(0, 600, (m, 2)),
                                 np.exp(rng.uniform(np.log(2), np.log(250), (m, 2)))], 1)
            dets = np.concatenate([jit, fp])
            scores = np.round(rng.uniform(0, 1, len(dets)), 2)   # ties
            r[c] = np.concatenate([dets, scores[:, None]], 1)
        gts.append(g)
        results.append(r)
    return gts, results


def assert_equal_nested(got, want, path="root"):
    """Equal structure, keys, types of container, and values (arrays by
    dtype, shape and bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, got, want)
        for k in want:
            assert_equal_nested(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_nested(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)
