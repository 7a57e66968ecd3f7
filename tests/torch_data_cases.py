"""A tiny COCO-json Cityscapes dataset on disk for the test path's CPU tests
(``test_torch_data.py``, ``test_torch_eval.py``, ``test_torch_test_loop.py``).

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
