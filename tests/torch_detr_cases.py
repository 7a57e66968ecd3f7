"""Shared cases of the DETR, Deformable DETR and PanopticFPN parity tests
(``tests/test_torch_detr_parts.py``, ``tests/test_torch_detr_heads.py``,
the data-parallel heads of ``tests/test_torch_dist_step.py`` and the config
sweep).

``tiny_model(name, model)``: the published config's ``model`` (either
package's) narrowed in place: ResNet-18 at base width 8 (C3..C5 of 16, 32
and 64 channels), 8 classes; DETR's and Deformable DETR's transformers at
16 channels, 2 heads, one encoder and two decoder layers, 10 queries (so
both ``d0.`` and the last layer's losses run); Deformable DETR's
ChannelMapper to 16 channels (3 levels, ``num_outs`` dropped as given;
``lean``: 2 levels and one attention head);
PanopticFPN as ``torch_mask_cases.tiny_mask_model`` (R18-FPN at 16
channels, 16 rois an image) with its semantic head at 16 channels and 6
stuff classes, and, with ``repaired``, mmdet's 14x14 mask RoI layer (the
config names none: its 7x7 fallback cannot train, ROADMAP C).

``randomize`` fills a JAX variable tree (from ``jax.eval_shape``) as
``torch_onestage_cases.randomize`` does, the query and level embeddings
N(0, 1). ``jax_draws`` are the RPN's and the RoI sampler's uniforms that the
JAX two-stage ``forward_train`` draws from ``KEYS`` (its ``make_rng``
patched to hand them out), for the port's ``UniformDraws``.
"""
import os.path as osp

import numpy as np

import torch_onestage_cases as oc

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = {"detr": "configs/detr/detr_r50_8x2_150e_coco.py",
           "deformable_detr": "configs/deformable_detr/deformable_detr_r50_16x2_50e_coco.py",
           "panoptic_fpn": "configs/panoptic_fpn/panoptic_fpn_r50_fpn_1x_coco.py"}
NUM_CLASSES = 8
STUFF_CLASSES = 6
HW = (64, 96)
MASK_ROI_14 = dict(type="SingleRoIExtractor",
                   roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
                   out_channels=16, featmap_strides=[4, 8, 16, 32])


def tiny_model(name, model, repaired=True, lean=False):
    """``model`` (a config's ``model``, either package's) made tiny in place;
    with ``lean``, Deformable DETR samples with one head on the backbone's
    last two levels (JAX's attention loops over heads and levels, and its
    compile time grows with their product; the module test of
    ``MSDeformAttention`` holds 2 heads on 3 levels)."""
    model["backbone"].update(depth=18, base_channels=8, stem_channels=8, init_cfg=None)
    if name in ("detr", "deformable_detr"):
        model["bbox_head"].update(num_classes=NUM_CLASSES, num_query=10, embed_dims=16,
                                  num_heads=2, num_encoder_layers=1, num_decoder_layers=2,
                                  feedforward_channels=32)
        if name == "detr":
            model["bbox_head"]["in_channels"] = 64
        elif lean:
            model["backbone"]["out_indices"] = (2, 3)
            model["neck"].update(in_channels=[32, 64], out_channels=16)
            model["bbox_head"]["num_heads"] = 1
        else:
            model["neck"].update(in_channels=[16, 32, 64], out_channels=16)
        model["test_cfg"]["max_per_img"] = 20
        return model
    model["neck"].update(in_channels=[8, 16, 32, 64], out_channels=16)
    model["rpn_head"].update(in_channels=16, feat_channels=16)
    rh = model["roi_head"]
    rh["bbox_roi_extractor"].update(out_channels=16)
    rh["bbox_head"].update(in_channels=16, fc_out_channels=32, num_classes=NUM_CLASSES)
    rh["mask_head"].update(num_convs=2, in_channels=16, conv_out_channels=16,
                           num_classes=NUM_CLASSES)
    if repaired:
        rh["mask_roi_extractor"] = dict(MASK_ROI_14)
    model["semantic_head"].update(in_channels=16, conv_out_channels=16, num_convs=2,
                                  num_classes=STUFF_CLASSES)
    model["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                              nms=dict(iou_threshold=0.7), min_bbox_size=0)
    model["train_cfg"]["rpn"]["sampler"]["num"] = 32
    model["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    return model


def jax_model(name, repaired=True, lean=False):
    from oadg_tpu.config import Config
    cfg = Config.fromfile(osp.join(ROOT, CONFIGS[name]), import_custom_modules=False)
    return tiny_model(name, cfg["model"], repaired, lean)


def torch_model(name, repaired=True, lean=False):
    from oadg_tpu_torch.config import load_config
    return oc._plain(tiny_model(name, load_config(osp.join(ROOT, CONFIGS[name]))["model"],
                                repaired, lean))


def batch(seed=4, semantic=False):
    """``torch_onestage_cases.batch`` (2 images of 64x96, 4 gts each, the
    last of the last image padding); with ``semantic`` seeded box-cropped
    gt masks (56x56) and a (2, 64, 96) label map of the stuff classes with
    255 void blocks."""
    b = oc.batch(seed, n=2, g=4, hw=HW)
    if semantic:
        rng = np.random.RandomState(seed + 1)
        b = oc.with_masks(b, seed + 2, m0=56)
        sem = rng.randint(0, STUFF_CLASSES, (2, HW[0] // 4, HW[1] // 4)).repeat(4, 1).repeat(4, 2)
        sem[:, :8, :16] = 255
        b["gt_semantic_seg"] = sem.astype(np.uint8)
    return b


def randomize(variables, seed=2):
    """``torch_onestage_cases.randomize`` with the embeddings N(0, 1)."""
    rng = np.random.RandomState(seed + 100)
    embeds = {}

    def strip(tree, path=()):
        out = {}
        for k, v in tree.items():
            if k in ("query_embed", "level_embed"):
                embeds[path + (k,)] = rng.normal(0, 1, v.shape).astype(np.float32)
            else:
                out[k] = strip(v, path + (k,)) if hasattr(v, "items") else v
        return out

    filled = oc.randomize(strip(variables), seed)
    for path, v in embeds.items():
        node = filled
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = v
    return filled


KEYS = (31, 32)


def jax_draws(num_anchors, num_cand, n=2):
    """The uniforms of the JAX RPN's and RoI sampler's positives and
    negatives drawn from ``KEYS`` -> the port's ``UniformDraws`` table."""
    import jax
    import torch

    def pair(key, size):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (size,)), jax.random.uniform(kn, (size,))

    rpn = [pair(k, num_anchors) for k in jax.random.split(jax.random.PRNGKey(KEYS[0]), n)]
    roi = [pair(k, num_cand) for k in jax.random.split(jax.random.PRNGKey(KEYS[1]), n)]
    as_t = lambda x: torch.from_numpy(np.asarray(x))          # noqa: E731
    return {"rpn.pos": as_t([p for p, _ in rpn]), "rpn.neg": as_t([q for _, q in rpn]),
            "rcnn.pos": as_t([p for p, _ in roi]), "rcnn.neg": as_t([q for _, q in roi])}


def torch_batch(b):
    """A numpy NHWC batch -> the port's tensors, ``img`` NCHW."""
    import torch
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    out["img"] = out["img"].permute(0, 3, 1, 2).contiguous()
    return out
