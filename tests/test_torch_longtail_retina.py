"""RetinaNet and the tiled NMS of the port against the JAX package, on the CPU.

RetinaNet (``configs/retinanet/retinanet_r50_fpn_1x_coco.py``) piece by
piece, each JAX function traced once, on inputs made with numpy from a seed
and weights carried over by ``jax_variables_to_state_dict``:

- the octave anchors (``octave_base_scale`` x ``2 ** (i / scales_per_octave)``):
  base anchors and grids equal bit for bit;
- the FPN's extra levels (``start_level=1``; ``add_extra_convs`` False,
  ``on_input`` (from C5's channels), ``on_lateral``, ``on_output`` and
  ``True``; ``relu_before_extra_convs``): rtol 1e-5 with a floor of 1e-6 of
  the largest magnitude (the convolutions' sums reassociate);
- ``RetinaHead``: the maps (same tolerance), the focal and L1 losses and
  every gradient of the tiny detector (the config's ResNet-FPN narrowed,
  one conv a tower): losses rtol 1e-5, gradients within 1e-4 of their
  largest magnitude; ``get_bboxes`` (``simple_test``) dets within 1e-5 of
  the largest coordinate, labels and validity exact; the test-time
  augmentation of ``tests/test_tta.py:107`` (a flipped view) against
  JAX's ``aug_test``;
- the tiled ``nms_padded``: keep sets equal to JAX's (256-box tiles) and to
  the port's one-tile resolution on random cases with tied scores, bfloat16
  scores, more than one tile, valid rows scattered (so the sorted tail is
  all invalid), none valid, and batched leading dimensions; the flagship's
  RPN shape (2 images x 5 levels x 1000), a DWD-like single level, a
  YOLOv3-like class-offset NMS (375 priors x 8 classes) and a TTA-like
  pooled one (2 images x 4 views x 100 detections, bfloat16 scores) against
  JAX's and the one-tile version, and ``multiclass_nms`` (1000 x 8
  candidates) against JAX's.
  The full-size cases (12,000 and 24,000 candidates; RetinaNet's 400,000)
  run on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.core.anchor import AnchorGenerator as JAnchors
from oadg_tpu.core.post_processing.nms import batched_nms_padded as jax_batched_nms
from oadg_tpu.core.post_processing.nms import multiclass_nms as jax_multiclass_nms
from oadg_tpu.core.post_processing.nms import nms_padded as jax_nms_padded
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.necks.fpn import FPN as JFPN
from oadg_tpu_torch.core.anchor import AnchorGenerator
from oadg_tpu_torch.core.post_processing.nms import (batched_nms_padded, multiclass_nms,
                                                     nms_padded)
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.necks import FPN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
HW = 64


def _close(got, want, rtol=1e-5, floor=1e-6, msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-12), err_msg=msg)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------- anchors ----

@pytest.mark.parametrize("octave", [(4, 3), (4, 1), (3, 2)])
def test_octave_anchors_equal_jax_bit_for_bit(octave):
    base, per = octave
    kw = dict(octave_base_scale=base, scales_per_octave=per, ratios=[0.5, 1.0, 2.0],
              strides=[8, 16, 32, 64, 128])
    j, p = JAnchors(**kw), AnchorGenerator(**kw)
    for a, b in zip(j.base_anchors, p.base_anchors):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    sizes = [(13, 21), (7, 11), (4, 6), (2, 3), (1, 2)]
    np.testing.assert_array_equal(np.asarray(j.grid_priors_cat(sizes)),
                                  p.grid_priors_cat(sizes).numpy())


# -------------------------------------------------------------------- FPN ----

FPN_CHANNELS = [8, 16, 24, 40]


def _fpn_inputs():
    rng = np.random.RandomState(0)
    return [rng.normal(0, 1, (2, 32 // 2 ** i, 48 // 2 ** i, c)).astype(np.float32)
            for i, c in enumerate(FPN_CHANNELS)]


@pytest.mark.parametrize("extra,relu", [(False, False), ("on_input", False),
                                        ("on_input", True), ("on_lateral", True),
                                        ("on_output", False), (True, True)])
def test_fpn_extra_levels_match_jax(extra, relu):
    kw = dict(in_channels=FPN_CHANNELS, out_channels=12, num_outs=5, start_level=1,
              add_extra_convs=extra, relu_before_extra_convs=relu)
    xs = _fpn_inputs()
    jfpn = JFPN(**kw)
    jx = [jnp.asarray(x) for x in xs]
    want, variables = jfpn.init_with_output(jax.random.PRNGKey(0), jx)
    fpn = FPN(**kw)
    fpn.load_state_dict(_sub(jax_variables_to_state_dict(
        {"params": {"neck_m": variables["params"]}}), "neck."), strict=True)
    with torch.no_grad():
        got = fpn([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(want) == 5
    if extra:       # mmdet's keys: the extra convs follow the outputs in fpn_convs
        assert len(fpn.fpn_convs) == 5
        first = {"on_input": FPN_CHANNELS[-1], True: FPN_CHANNELS[-1]}.get(extra, 12)
        assert fpn.fpn_convs[3].conv.weight.shape[1] == first
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1).numpy(), w, msg=f"level {i}")


# -------------------------------------------------------------- RetinaNet ----

RETINA = dict(
    type="RetinaNet",
    backbone=dict(type="ResNet", depth=18, base_channels=8, stem_channels=8,
                  out_indices=(0, 1, 2, 3), frozen_stages=1,
                  norm_cfg=dict(type="BN", requires_grad=True), norm_eval=True,
                  style="pytorch"),
    neck=dict(type="FPN", in_channels=[8, 16, 32, 64], out_channels=16, start_level=1,
              add_extra_convs="on_input", num_outs=5),
    bbox_head=dict(type="RetinaHead", num_classes=8, in_channels=16, stacked_convs=1,
                   feat_channels=16,
                   anchor_generator=dict(type="AnchorGenerator", octave_base_scale=4,
                                         scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                                         strides=[8, 16, 32, 64, 128]),
                   bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[.0] * 4,
                                   target_stds=[1.0] * 4),
                   loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                                 alpha=0.25, loss_weight=1.0),
                   loss_bbox=dict(type="L1Loss", loss_weight=1.0)),
    train_cfg=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
                                 min_pos_iou=0, ignore_iof_thr=-1),
                   allowed_border=-1, pos_weight=-1, debug=False),
    test_cfg=dict(nms_pre=100, min_bbox_size=0, score_thr=0.05,
                  nms=dict(type="nms", iou_threshold=0.5), max_per_img=20))


def _retina_batch():
    rng = np.random.RandomState(4)
    n, g = 2, 4
    x1 = rng.uniform(0, 40, (n, g))
    y1 = rng.uniform(0, 40, (n, g))
    gt = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, 30, (n, g)), HW),
                   np.minimum(y1 + rng.uniform(8, 30, (n, g)), HW)], -1).astype(np.float32)
    valid = np.ones((n, g), bool)
    valid[1, -1] = False
    gt[1, -1] = 0
    return {"img": rng.normal(0, 1, (n, HW, HW, 3)).astype(np.float32),
            "gt_bboxes": gt, "gt_labels": rng.randint(0, 8, (n, g)).astype(np.int32),
            "gt_valid": valid, "img_shape": np.array([[HW, HW]] * n, np.float32),
            "scale_factor": np.ones((n, 4), np.float32)}


def _randomize_retina(variables):
    """Random frozen-BN statistics and a class head whose scores spread
    well above ``score_thr``, so that detections exist and are far apart."""
    rng = np.random.RandomState(2)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, sub in params.items():
            if k.startswith("FrozenBN") or k == "downsample_bn":
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(k, {}))

    walk(v["params"], v["batch_stats"])
    for name, std in (("retina_cls", 0.3), ("retina_reg", 0.05)):
        node = v["params"]["head"][name]["Conv_0"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
        node["bias"] = np.zeros_like(node["bias"])
    return v


def _torch(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["img"] = t["img"].permute(0, 3, 1, 2).contiguous()
    return t


@pytest.fixture(scope="module")
def retina():
    batch = _retina_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(RETINA, num_views=1)
    variables = _randomize_retina(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jb["img"], "img_shape": jb["img_shape"]}))

    def loss_fn(params, stats, b):
        losses = jdet.apply({"params": params, "batch_stats": stats}, b, "train",
                            rngs={"sampling": jax.random.PRNGKey(5)})
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jb)
    jtest = jax.jit(lambda v, b: jdet.apply(v, b, "test"))(variables, jb)
    flip = dict(jb, img=jb["img"][:, :, ::-1, :])
    jaug = jax.jit(lambda v, views: jdet.apply(v, (views, ((True, "horizontal"),)),
                                                "aug_test"))(variables, (flip,))

    det = build_detector(RETINA, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    det.train()
    tb = _torch(batch)
    losses = det.forward_train(tb, UniformDraws())
    sum(losses.values()).backward()
    det.eval()
    with torch.no_grad():
        test = det.simple_test(tb)
        tflip = dict(tb, img=tb["img"].flip(-1))
        aug = det.aug_test([tflip], [(True, "horizontal")])
    return dict(jlosses=jlosses, losses=losses, det=det, test=test, jtest=jtest,
                aug=aug, jaug=jaug,
                want_grads=jax_variables_to_state_dict(
                    {"params": jax.tree_util.tree_map(np.asarray, jgrads)}))


@pytest.mark.parametrize("key", ["loss_cls", "loss_bbox"])
def test_retina_losses_match_jax(retina, key):
    got = float(retina["losses"][key].detach())
    np.testing.assert_allclose(got, float(retina["jlosses"][key]), rtol=1e-5)
    assert got > 0


def test_retina_gradients_match_jax(retina):
    det, want = retina["det"], retina["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    # the backbone's stem and layer1 are frozen (frozen_stages=1)
    assert all(not k.startswith(("backbone.conv1", "backbone.layer1."))
               for k, _ in trainable)
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=name)
    assert any(k.startswith("neck.fpn_convs.4") for k, _ in trainable)


def _check_dets(got, want):
    dets, labels, valid = (t.numpy() for t in got)
    jd, jl, jv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    assert valid.sum() >= 5
    np.testing.assert_allclose(dets[..., :4], jd[..., :4], rtol=0,
                               atol=1e-5 * np.abs(jd[..., :4]).max())
    np.testing.assert_allclose(dets[..., 4], jd[..., 4], rtol=1e-5, atol=1e-7)


def test_retina_simple_test_matches_jax(retina):
    _check_dets(retina["test"], retina["jtest"])


def test_retina_flip_tta_matches_jax(retina):
    _check_dets(retina["aug"], retina["jaug"])


# ------------------------------------------------------------ tiled NMS ----

def _boxes(rng, shape, extent=200.0, size=(5, 60)):
    x1 = rng.uniform(0, extent, shape)
    y1 = rng.uniform(0, extent, shape)
    w = rng.uniform(*size, shape)
    h = rng.uniform(*size, shape)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _nms_case(name):
    rng = np.random.RandomState(abs(hash(name)) % 2 ** 31)
    if name == "ties":                 # scores on a 0.05 grid: many equal
        boxes = _boxes(rng, (900,))
        scores = (np.round(rng.uniform(0, 1, 900) * 20) / 20).astype(np.float32)
        return boxes, scores, rng.uniform(0, 1, 900) < 0.9, torch.float32
    if name == "bf16":
        boxes = _boxes(rng, (700,))
        return boxes, rng.uniform(0, 1, 700).astype(np.float32), None, torch.bfloat16
    if name == "scattered_valid":      # 30% valid anywhere: the sorted tail is invalid
        boxes = _boxes(rng, (1100,))
        return (boxes, rng.uniform(0, 1, 1100).astype(np.float32),
                rng.uniform(0, 1, 1100) < 0.3, torch.float32)
    if name == "none_valid":
        boxes = _boxes(rng, (600,))
        return boxes, rng.uniform(0, 1, 600).astype(np.float32), np.zeros(600, bool), torch.float32
    if name == "one_tile":
        boxes = _boxes(rng, (200,))
        return boxes, rng.uniform(0, 1, 200).astype(np.float32), None, torch.float32
    if name == "dense":                # heavy overlap: long suppression chains
        boxes = _boxes(rng, (1000,), extent=60.0, size=(30, 50))
        return boxes, rng.uniform(0, 1, 1000).astype(np.float32), None, torch.float32
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ties", "bf16", "scattered_valid", "none_valid",
                                  "one_tile", "dense"])
def test_tiled_nms_equals_jax_and_one_tile(name):
    boxes, scores, valid, dt = _nms_case(name)
    tb = torch.from_numpy(boxes)
    ts = torch.from_numpy(scores).to(dt)
    tv = None if valid is None else torch.from_numpy(valid)
    tiled = nms_padded(tb, ts, 0.5, tv)
    one = nms_padded(tb, ts, 0.5, tv, tile_size=None)
    assert torch.equal(tiled, one)
    jscores = jnp.asarray(ts.float().numpy()).astype(
        jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    want = jax_nms_padded(jnp.asarray(boxes), jscores, 0.5,
                          None if valid is None else jnp.asarray(valid))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(want))
    if name == "none_valid":
        assert not tiled.any()
    else:
        assert 0 < int(tiled.sum()) < len(scores)


@pytest.mark.parametrize("tile", [64, 128, 256])
def test_tiled_nms_batched_flagship_rpn_shape(tile):
    """The flagship's training proposals: 2 images x 5 levels x 1000
    candidates (a level with fewer anchors padded invalid), per (image,
    level), as ``RPNHead.get_proposals`` calls it."""
    rng = np.random.RandomState(7)
    boxes = _boxes(rng, (2, 5, 1000), extent=400.0, size=(8, 120))
    scores = rng.uniform(0, 1, (2, 5, 1000)).astype(np.float32)
    valid = np.ones((2, 5, 1000), bool)
    valid[:, 4, 512:] = False
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    tiled = nms_padded(tb, ts, 0.7, tv, tile_size=tile)
    assert torch.equal(tiled, nms_padded(tb, ts, 0.7, tv, tile_size=None))
    want = jax.jit(jax.vmap(jax.vmap(lambda b, s, v: jax_nms_padded(b, s, 0.7, v))))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(want))
    assert not tiled[:, 4, 512:].any()


def test_tiled_nms_single_level_dwd_like():
    """One level of 3000 proposals (the DWD config's is 12,000; that size
    runs on the card)."""
    rng = np.random.RandomState(8)
    boxes = _boxes(rng, (3000,), extent=1200.0, size=(16, 300))
    scores = rng.uniform(0, 1, 3000).astype(np.float32)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    tiled = nms_padded(tb, ts, 0.7)
    assert torch.equal(tiled, nms_padded(tb, ts, 0.7, tile_size=None))
    want = jax.jit(lambda b, s: jax_nms_padded(b, s, 0.7))(jnp.asarray(boxes),
                                                           jnp.asarray(scores))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(want))


def test_multiclass_nms_yolo_like_matches_jax():
    """``multiclass_nms`` over 1000 priors x 8 classes (YOLOv3's request is
    3 x 1000 x 8) with about a quarter of the scores above ``score_thr``."""
    rng = np.random.RandomState(9)
    boxes = _boxes(rng, (1000,), extent=500.0, size=(10, 150))
    scores = np.zeros((1000, 9), np.float32)
    scores[:, :8] = rng.uniform(0, 1, (1000, 8)) ** 4
    got = multiclass_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                         0.05, 0.45, 100, 8)
    want = jax_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.45, 100, 8)
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    assert int(got[2].sum()) == 100


@pytest.mark.parametrize("name", ["yolo_multiclass", "tta_pooled"])
def test_tiled_batched_nms_equals_jax_and_one_tile(name):
    """``batched_nms_padded`` (classes apart by the coordinate offset) as
    YOLOv3's request (375 priors x 8 classes, scores above 0.05 valid) and
    the test-time augmentation's pooled detections (4 views x 100 on each
    of 2 images, bfloat16 scores) call it."""
    rng = np.random.RandomState(len(name))
    if name == "yolo_multiclass":
        boxes = _boxes(rng, (1, 3000), extent=500.0, size=(10, 200))
        scores = (rng.uniform(0, 1, (1, 3000)) ** 2).astype(np.float32)
        labels = np.tile(np.arange(8), 375)[None]
        dt, thr = torch.float32, 0.45
    else:
        boxes = _boxes(rng, (2, 400), extent=500.0, size=(10, 200))
        scores = rng.uniform(0, 1, (2, 400)).astype(np.float32)
        labels = rng.randint(0, 8, (2, 400))
        dt, thr = torch.bfloat16, 0.5
    ts = torch.from_numpy(scores).to(dt)
    valid = ts.float() > 0.05
    args = (torch.from_numpy(boxes), ts, torch.from_numpy(labels), thr, valid)
    tiled = batched_nms_padded(*args)
    assert torch.equal(tiled, batched_nms_padded(*args, tile_size=None))
    jscores = jnp.asarray(ts.float().numpy()).astype(
        jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    want = jax.vmap(lambda b, s, i, v: jax_batched_nms(b, s, i, thr, valid=v))(
        jnp.asarray(boxes), jscores, jnp.asarray(labels), jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(want))
    assert 0 < int(tiled.sum()) < int(valid.sum())
