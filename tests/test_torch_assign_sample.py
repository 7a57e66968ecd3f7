"""The port's MaxIoU assigner and random sampler against the JAX package.

Same seeded boxes on both sides; the port's samplers are handed the uniform
draws ``jax.random.uniform`` makes from the key the JAX sampler splits, so
assignments, labels and sampled index sets agree exactly. Batched port
calls are held to the JAX functions vmapped over images.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.core.bbox.assign_sample import MaxIoUAssigner as JaxAssigner
from oadg_tpu.core.bbox.assign_sample import RandomSampler as JaxSampler
from oadg_tpu_torch.core.bbox.assign_sample import MaxIoUAssigner, RandomSampler

N_IMG, N_BOX, N_GT = 3, 400, 6
ASSIGNERS = {
    "rpn": dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                match_low_quality=True),
    "rcnn": dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                 match_low_quality=False),
    "single_argmax": dict(pos_iou_thr=0.6, neg_iou_thr=(0.1, 0.4),
                          min_pos_iou=0.2, gt_max_assign_all=False),
}


def _inputs(seed=0):
    """Boxes near the gts (so every assignment code occurs), padded gts,
    invalid candidates, and a duplicated gt (ties in the low-quality pass)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((N_IMG, N_GT, 4), np.float32)
    xy = rng.uniform(0, 150, (N_IMG, N_GT, 2))
    wh = rng.uniform(10, 80, (N_IMG, N_GT, 2))
    gt[..., :2], gt[..., 2:] = xy, xy + wh
    gt[1, 3] = gt[1, 2]                                      # duplicate gt
    gt_valid = np.ones((N_IMG, N_GT), bool)
    gt_valid[0, 4:] = False                                  # padding
    gt_valid[2, :] = False                                   # image without gts
    src = gt[:, rng.randint(0, N_GT, N_BOX)]                 # (N_IMG, N_BOX, 4)
    jitter = rng.normal(0, 1, src.shape) * (src[..., 2:3] - src[..., 0:1]) * 0.25
    boxes = (src + jitter).astype(np.float32)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    box_valid = rng.rand(N_IMG, N_BOX) > 0.05
    labels = rng.randint(0, 8, (N_IMG, N_GT)).astype(np.int32)
    return boxes, gt, gt_valid, labels, box_valid


@pytest.mark.parametrize("name", sorted(ASSIGNERS))
def test_assigner_matches_jax(name):
    boxes, gt, gt_valid, labels, box_valid = _inputs()
    ja, ta = JaxAssigner(**ASSIGNERS[name]), MaxIoUAssigner(**ASSIGNERS[name])
    want = jax.vmap(lambda b, g, gv, l, bv: ja.assign(b, g, gv, gt_labels=l,
                                                     box_valid=bv))(
        *map(jnp.asarray, (boxes, gt, gt_valid, labels, box_valid)))
    got = ta.assign(*map(torch.from_numpy, (boxes, gt, gt_valid)),
                    gt_labels=torch.from_numpy(labels),
                    box_valid=torch.from_numpy(box_valid))
    np.testing.assert_array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(), np.asarray(want.max_overlaps),
                               rtol=1e-6, atol=1e-7)
    codes = set(np.unique(got.gt_inds.numpy()))
    assert {-1, 0} <= codes and max(codes) > 1
    assert (got.gt_inds[2] <= 0).all()                      # no gts: no positives


def _draws(keys, n):
    """Per image: the (positive, negative) uniforms a JAX sampler draws."""
    pairs = [jax.random.split(k) for k in keys]
    return [torch.from_numpy(np.stack([np.asarray(jax.random.uniform(p[i], (n,)))
                                       for p in pairs])) for i in (0, 1)]


@pytest.mark.parametrize("num,pos_fraction", [(64, 0.25), (512, 0.5)])
def test_sample_matches_jax(num, pos_fraction):
    boxes, gt, gt_valid, labels, box_valid = _inputs(1)
    assign_cfg = ASSIGNERS["rcnn"]
    jassign = jax.vmap(lambda b, g, gv, l, bv: JaxAssigner(**assign_cfg).assign(
        b, g, gv, gt_labels=l, box_valid=bv))(
        *map(jnp.asarray, (boxes, gt, gt_valid, labels, box_valid)))
    tassign = MaxIoUAssigner(**assign_cfg).assign(
        *map(torch.from_numpy, (boxes, gt, gt_valid)),
        gt_labels=torch.from_numpy(labels), box_valid=torch.from_numpy(box_valid))
    keys = jax.random.split(jax.random.PRNGKey(7), N_IMG)
    js, ts = JaxSampler(num, pos_fraction), RandomSampler(num, pos_fraction)
    want = jax.vmap(js.sample)(keys, jassign)
    got = ts.sample(tassign, *_draws(keys, N_BOX))
    k = min(num, N_BOX)
    for field in ("inds", "is_pos", "valid", "gt_inds", "labels"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field))[:, :k], field)
    assert got.is_pos.any() and (got.valid & ~got.is_pos).any()


@pytest.mark.parametrize("num,pos_fraction", [(32, 0.5), (256, 0.5)])
def test_sample_masks_matches_jax(num, pos_fraction):
    boxes, gt, gt_valid, _, box_valid = _inputs(2)
    cfg = ASSIGNERS["rpn"]
    jassign = jax.vmap(lambda b, g, gv, bv: JaxAssigner(**cfg).assign(
        b, g, gv, box_valid=bv))(*map(jnp.asarray, (boxes, gt, gt_valid, box_valid)))
    tassign = MaxIoUAssigner(**cfg).assign(
        *map(torch.from_numpy, (boxes, gt, gt_valid)),
        box_valid=torch.from_numpy(box_valid))
    keys = jax.random.split(jax.random.PRNGKey(9), N_IMG)
    js, ts = JaxSampler(num, pos_fraction), RandomSampler(num, pos_fraction)
    want_pos, want_neg = jax.vmap(js.sample_masks)(keys, jassign)
    got_pos, got_neg = ts.sample_masks(tassign, *_draws(keys, N_BOX))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_neg.numpy(), np.asarray(want_neg))
    assert (got_pos.sum(1) <= int(round(num * pos_fraction))).all()
    assert ((got_pos | got_neg).sum(1) <= num).all() and got_pos.any()


def test_ohem_config_is_refused():
    """The OHEM Faster R-CNN config names ``OHEMSampler``, which the port has
    not ported: building it raises instead of training with a
    ``RandomSampler`` under that name. (The JAX package builds it and then
    samples at random: ``OHEMSampler.sample`` gets no ``hard_scores``.)"""
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.models import build_detector
    cfg = load_config("configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py")
    assert cfg.model.train_cfg.rcnn.sampler.type == "OHEMSampler"
    with pytest.raises(ValueError, match="OHEMSampler is not ported.*ported slices' types"):
        build_detector(dict(cfg.model), device="cpu")


@pytest.mark.parametrize("site", ["rpn.assigner", "rpn.sampler", "rcnn.assigner",
                                  "rcnn.sampler", "yolo.assigner"])
def test_unported_assigner_or_sampler_type_raises(site):
    """Each place that builds an assigner or a sampler from the config takes
    its ported type, or none (the default), and refuses any other."""
    from oadg_tpu_torch.models.dense_heads import RPNHead, YOLOV3Head
    from oadg_tpu_torch.models.roi_heads import StandardRoIHead
    head, key = site.split(".")
    ported = {"assigner": "GridAssigner" if head == "yolo" else "MaxIoUAssigner",
              "sampler": "RandomSampler"}[key]
    base = dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3),
                sampler=dict(num=8, pos_fraction=0.5))

    def build(train_cfg):
        if head == "rpn":
            return RPNHead(in_channels=4, feat_channels=4, train_cfg=train_cfg, device="cpu",
                           anchor_generator=dict(type="AnchorGenerator", scales=[8],
                                                 ratios=[1.0], strides=[4]),
                           bbox_coder=dict(type="DeltaXYWHBBoxCoder"))
        if head == "rcnn":
            return StandardRoIHead(
                bbox_roi_extractor=dict(type="SingleRoIExtractor", out_channels=4,
                                        featmap_strides=[4],
                                        roi_layer=dict(type="RoIAlign", output_size=7)),
                bbox_head=dict(type="Shared2FCBBoxHead", in_channels=4, fc_out_channels=8,
                               num_classes=2), train_cfg=train_cfg, device="cpu")
        return YOLOV3Head(num_classes=2, in_channels=[4, 4, 4], out_channels=[4, 4, 4],
                          train_cfg=train_cfg, device="cpu")

    build(base)                                              # no type: the default
    build(dict(base, **{key: dict(base[key], type=ported)}))
    with pytest.raises(ValueError, match="ATSSThing is not ported"):
        build(dict(base, **{key: dict(base[key], type="ATSSThing")}))
