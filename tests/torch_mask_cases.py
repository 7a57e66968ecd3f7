"""Shared cases of the Mask R-CNN parity tests (``test_torch_mask.py``,
``test_torch_mask_slice.py``): the Cityscapes Mask R-CNN config made tiny,
instance polygons and RLEs, and a small PNG set whose COCO json carries
them."""
import json
import os

import numpy as np

MASK_CONFIG = "configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py"
CAT_IDS = (24, 25, 26, 27, 28, 31, 32, 33)          # Cityscapes' person .. bicycle
CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")


def tiny_mask_model(model):
    """The config's ``model`` (either package's) made tiny in place: R18-FPN
    at 16 channels, the mask head's 2 convs of 16 channels, 32 sampled
    anchors and 16 rois an image (4 mask slots), a small proposal budget;
    no pretrained backbone."""
    model["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    model["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    model["rpn_head"].update(in_channels=16, feat_channels=16)
    model["roi_head"]["bbox_roi_extractor"].update(out_channels=16)
    model["roi_head"]["mask_roi_extractor"].update(out_channels=16)
    model["roi_head"]["bbox_head"].update(in_channels=16, fc_out_channels=32)
    model["roi_head"]["mask_head"].update(num_convs=2, in_channels=16, conv_out_channels=16)
    model["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                              nms=dict(iou_threshold=0.7), min_bbox_size=0)
    model["train_cfg"]["rpn"]["sampler"]["num"] = 32
    model["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    return model


def with_mask_pipeline(pipeline):
    """The Cityscapes dataset base's train pipeline with masks: its
    ``LoadAnnotations`` loads them and its ``Collect`` keeps them (the
    config file loads boxes only)."""
    out = []
    for p in pipeline:
        p = dict(p)
        if p["type"] == "LoadAnnotations":
            p["with_mask"] = True
        if p["type"] == "Collect":
            p["keys"] = list(p["keys"]) + ["gt_masks"]
        out.append(p)
    return out


def polygon(rng, x, y, w, h):
    """A flat ``[x0, y0, ...]`` octagon touching the four sides of the box
    (x, y, w, h), its inner points jittered: a convex-ish instance outline."""
    a, b = rng.uniform(0.15, 0.45, 2)
    c, d = rng.uniform(0.55, 0.85, 2)
    pts = [(a, 0), (c, 0), (1, b), (1, d), (c, 1), (a, 1), (0, d), (0, b)]
    return [float(v) for px, py in pts for v in (x + px * w, y + py * h)]


def rle(rng, x, y, w, h, img_h, img_w):
    """An uncompressed column-major RLE (``counts``, ``size``) of a filled
    ellipse in the box (x, y, w, h)."""
    yy, xx = np.mgrid[0:img_h, 0:img_w]
    inside = (((xx + 0.5 - x - w / 2) / (w / 2)) ** 2
              + ((yy + 0.5 - y - h / 2) / (h / 2)) ** 2) <= 1
    flat = inside.T.reshape(-1).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [0]])))
    counts = np.diff(np.concatenate([[0], edges, [flat.size]]))    # zeros first
    return {"counts": [int(v) for v in counts], "size": [img_h, img_w]}


def write_mask_dataset(root, sizes=((64, 96), (60, 90), (64, 96), (48, 80)), seed=0,
                       per_image=(3, 5)):
    """PNGs (the port's encoder) of ``sizes`` under ``root/leftImg8bit/`` and
    a COCO json of the 8 Cityscapes classes whose instances carry polygons
    (one an image an RLE, one a crowd box) -> (ann_file, img_prefix)."""
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "leftImg8bit")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"city_{i:02d}_leftImg8bit.png"
        imwrite(os.path.join(img_dir, name), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i, file_name=name, width=w, height=h))
        for k in range(rng.randint(*per_image) + 2):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            seg = rle(rng, x, y, bw, bh, h, w) if k == 1 else [polygon(rng, x, y, bw, bh)]
            annotations.append(dict(id=len(annotations) + 1, image_id=i,
                                    category_id=int(rng.choice(CAT_IDS)), bbox=[x, y, bw, bh],
                                    area=bw * bh, iscrowd=int(k == 2), segmentation=seg))
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=n) for c, n in zip(CAT_IDS, CLASSES)]), f)
    return ann_file, img_dir + os.sep
