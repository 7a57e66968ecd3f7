"""The port's YOLOv3 OA-DG path against the JAX package, on the CPU.

The YOLOv3 config (``configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py``:
Darknet-53, ``YOLOV3Neck``, ``YOLOV3HeadCont`` with live BN, the SSD-style
float32 train pipeline, OA-Mix on every view) module by module, each JAX
function traced once, on inputs made with numpy from a seed and weights
carried over by ``jax_variables_to_state_dict``:

- ``ConvModule`` with live and frozen BN (train and eval mode): output and
  the moving statistics after a train-mode call, float32 rtol 1e-5 (the
  float32 batch statistics sum in another order); in bfloat16 one
  bfloat16 step of the largest magnitude on at most 1e-3 of values
  (measured 2e-5; the convolutions round differently there);
- Darknet-53's ``norm_eval`` and ``frozen_stages`` (its values against
  JAX's: ``test_torch_yolo_slice.py``);
- ``YOLOV3Neck`` (narrowed, odd sizes so that the upsample is cropped) and
  the narrowed heads in train mode: rtol 1e-5, floor 1e-5 of the largest for
  the neck (its live BNs renormalize 17 convolutions' reassociated sums),
  1e-6 for the head; the bfloat16 head's maps within two bfloat16 steps of
  their largest, its moving statistics rtol 1e-3 with a floor of 1e-3 of the
  largest (means near 0; measured 1.4e-4);
- ``YOLOAnchorGenerator`` and the grid targets' masks and classes: exact;
  ``YOLOBBoxCoder`` and the encoded targets within one float32 ulp (of 1 for
  the targets, of the largest coordinate for decoded boxes: XLA contracts a
  multiply and an add into one rounding on some values; measured 4% of
  encoded values one ulp apart);
- every loss term of ``YOLOV3HeadCont`` (and ``YOLOV3Head``'s four) with
  JAX's uniforms for the cont rows: rtol 1e-5; in bfloat16 one bfloat16
  step (2**-8) relative;
- ``get_bboxes``: labels, validity and order exact, boxes 1e-3 px, scores
  1e-5;
- ``Expand``, ``MinIoURandomCrop``, ``PhotoMetricDistortion`` and the float32
  ``Resize`` after ``np.random.seed``: exact, and the global generator left
  in the same state;
- the ``keep_orig=False`` preprocess against JAX's ``oamix_batch`` with
  ``num_views = V + 1`` on the same draw tables (``OAMIX_GEO_PW=force``):
  the augmented views to ``test_torch_oamix.py``'s composed tolerance, the
  boxes equal;
- the slice as a whole, float32 and bfloat16: ``test_torch_yolo_slice.py``;
- the entry points: ``init_detector`` on both YOLOv3 configs, and
  ``tools/torch_train.py`` then ``tools/torch_test.py`` on the tiny config
  (``torch_yolo_cases.tiny_train_cfg``).
"""
import os
import subprocess
import sys

import cv2  # noqa: F401  (the JAX package's transforms resize with it)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_yolo_cases as cases
from oadg_tpu.data.pipelines import transforms as jax_transforms
from oadg_tpu.models.dense_heads.yolo_head import YOLOAnchorGenerator as JAnchors
from oadg_tpu.models.dense_heads.yolo_head import YOLOV3Head as JHead
from oadg_tpu.models.dense_heads.yolo_head import YOLOV3HeadCont as JHeadCont
from oadg_tpu.models.layers import ConvModule as JConvModule
from oadg_tpu.models.necks.yolo_neck import YOLOV3Neck as JNeck
from oadg_tpu.core.bbox.coder import YOLOBBoxCoder as JCoder
from oadg_tpu.ops.oamix_device import oamix_batch as jax_oamix_batch
from oadg_tpu_torch.apis import init_detector, prepare_image
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.core.anchor import YOLOAnchorGenerator
from oadg_tpu_torch.core.bbox import YOLOBBoxCoder
from oadg_tpu_torch.data.pipelines import transforms as port_transforms
from oadg_tpu_torch.engine import make_oadg_preprocess
from oadg_tpu_torch.models.backbones import Darknet
from oadg_tpu_torch.models.dense_heads import YOLOV3Head, YOLOV3HeadCont
from oadg_tpu_torch.models.layers import BatchNorm, ConvModule
from oadg_tpu_torch.models.necks import YOLOV3Neck
from oadg_tpu_torch.utils.draws import UniformDraws
from test_torch_oamix import (_check_view, _gts, _image, _jax_table, _table,  # noqa: F401
                              jax_production_path)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
STEP = 2.0 ** -8
ULP = 2.0 ** -22           # one float32 ulp at 1..2


# ---------------------------------------------------------- ConvModule ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["live", "frozen", "live eval"])
def test_conv_module_bn_matches_jax(mode, dtype):
    """Live BN (train mode: batch statistics, the moving ones updated),
    frozen BN (``norm_eval``: the stored ones, never updated) and live BN in
    eval mode (the stored ones)."""
    rng = np.random.RandomState(1)
    x = rng.normal(0.3, 1.5, (3, 12, 10, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jm = JConvModule(24, 3, 1, 1, norm_cfg=dict(type="BN", _eval=mode == "frozen"),
                     act="leaky_relu", dtype=jdt)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = cases.randomize({"params": {"m": v["params"]}, "batch_stats": {"m": v["batch_stats"]}})
    v = {c: {"conv1": v[c]["m"]} for c in v}
    jv = {c: v[c]["conv1"] for c in v}
    if mode == "live eval":
        want, stats = jm.apply(jv, jnp.asarray(x)), jv["batch_stats"]
    else:
        want, new = jm.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
        stats = new["batch_stats"]
    m = ConvModule(16, 24, 3, 1, 1, norm_cfg=dict(type="BN"), act="leaky_relu",
                   dtype=BF16 if dtype == "bfloat16" else None)
    m.load_state_dict(cases.port_state(v, "neck_m", "neck.conv1."), strict=True)
    m.train(mode == "live")
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        assert got.dtype == torch.float32
        cases.close(cases.nhwc(got), want, 1e-5, 1e-6)
    else:
        assert got.dtype == BF16
        diff = np.abs(cases.nhwc(got) - want)
        assert diff.max() <= STEP * np.abs(want).max() * 2
        assert np.mean(diff > 0) <= 1e-3
    for key, leaf in (("running_mean", "mean"), ("running_var", "var")):
        cases.close(cases.to_np(getattr(m.bn, key)), stats["FrozenBN_0"][leaf], 1e-5, 1e-7)
    moved = not np.array_equal(cases.to_np(m.bn.running_mean), jv["batch_stats"]["FrozenBN_0"]["mean"])
    assert moved == (mode == "live")


def test_bn_keys_are_batchnorm2d_keys():
    assert set(BatchNorm(4).state_dict()) == set(torch.nn.BatchNorm2d(4).state_dict()) - {
        "num_batches_tracked"}
    m = ConvModule(3, 4, 3, norm_cfg=dict(type="BN"), act="leaky_relu")
    assert m.conv.bias is None and set(m.state_dict()) == {
        "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"}
    assert set(ConvModule(3, 4, 1).state_dict()) == {"conv.weight", "conv.bias"}


# ------------------------------------------------------------ Darknet ----

def test_darknet_norm_eval_and_frozen_stages():
    """``norm_eval`` keeps the backbone's BNs in eval mode through
    ``train()``; without it they train; ``frozen_stages`` = 2 freezes
    ``conv1`` and ``conv_res_block1`` (mmdet's ``_freeze_stages``)."""
    x = torch.from_numpy(np.random.RandomState(5).normal(0, 1, (2, 3, 32, 32)).astype(
        np.float32))
    m = Darknet(frozen_stages=2).train()
    bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
    assert len(bns) == 52 and not any(b.training for b in bns)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    m(x)
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    frozen = {k for k, p in m.named_parameters() if not p.requires_grad}
    assert frozen == {k for k in before if k.startswith(("conv1.", "conv_res_block1."))
                      and "running" not in k}
    live = Darknet(norm_eval=False).train()
    assert all(b.training for b in live.modules() if isinstance(b, BatchNorm))
    live(x)
    assert not torch.equal(live.conv1.bn.running_mean, torch.zeros(32))


# --------------------------------------------------------- neck, head ----

def test_neck_matches_jax_in_train_mode():
    """The narrowed neck on levels of odd size (10x10, 5x5, 3x3: the
    upsampled 6x6 is cropped to 5x5): outputs and moving statistics."""
    rng = np.random.RandomState(6)
    feats = [rng.normal(0, 1, (3, s, s, c)).astype(np.float32)
             for s, c in ((10, 24), (5, 32), (3, 40))]
    jm = JNeck(in_channels=[40, 32, 24], out_channels=[32, 24, 16])
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    v = cases.randomize({c: {"neck_m": v[c]} for c in v})
    jv = {c: v[c]["neck_m"] for c in v}
    want, new = jax.jit(lambda v, f: jm.apply(v, f, mutable=["batch_stats"]))(
        jv, [jnp.asarray(f) for f in feats])
    m = YOLOV3Neck(in_channels=[40, 32, 24], out_channels=[32, 24, 16])
    m.load_state_dict(cases.port_state(jv, "neck_m", "neck."), strict=True)
    got = m.train()([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert [g.shape[2] for g in got] == [3, 5, 10]
    for g, w in zip(got, want):
        cases.close(cases.nhwc(g), w, 1e-5, 1e-5)
    stats = cases.port_state({"batch_stats": new["batch_stats"]}, "neck_m", "neck.")
    for k, w in stats.items():
        cases.close(m.state_dict()[k].numpy(), w.numpy(), 1e-5, 1e-7)


def _head_inputs(n=4):
    rng = np.random.RandomState(7)
    feats = [rng.normal(0, 1, (n, 8 * f, 8 * f, c)).astype(np.float32)
             for f, c in zip((1, 2, 4), (32, 24, 16))]
    gt, lbl, valid = cases.gts(rng, n // 2, 6, 256, 256)
    return feats, np.tile(gt, (2, 1, 1)), np.tile(lbl, (2, 1)), np.tile(valid, (2, 1))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def head_run(request):
    """``YOLOV3HeadCont`` (num_views 2) in train mode on 4 feature rows
    (image 256x256): JAX's outputs and losses with the cont uniforms drawn
    from the sampling key, and the port's."""
    bf = request.param == "bfloat16"
    feats, gt, lbl, valid = _head_inputs()
    jf = [jnp.asarray(f) for f in feats]
    head = JHeadCont(**cases.HEAD_CFG, **cases.CONT_KW, num_views=2,
                     dtype=jnp.bfloat16 if bf else None)
    v = jax.jit(head.init)(jax.random.PRNGKey(0), jf)
    v = cases.randomize({c: {"head": v[c]} for c in v})
    jv = {c: v[c]["head"] for c in v}

    def run(v, f, gt, valid, lbl, key):
        outs, new = head.apply(v, f, mutable=["batch_stats"])
        losses = head.apply(dict(v, batch_stats=new["batch_stats"]), outs, gt, valid, lbl, key,
                            method=head.loss, mutable=["batch_stats"])[0]
        return outs, new, losses

    outs, new, jlosses = jax.jit(run)(jv, jf, jnp.asarray(gt), jnp.asarray(valid),
                                      jnp.asarray(lbl), jax.random.PRNGKey(cases.KEY_SEED))
    port = YOLOV3HeadCont(**cases.HEAD_CFG, **cases.CONT_KW, num_views=2,
                          dtype=BF16 if bf else None)
    port.load_state_dict(cases.port_state(jv, "head", "bbox_head."), strict=True)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    maps, conts = port.train()(tf)
    draws = UniformDraws(given=cases.cont_draws(2, 3 * (64 + 256 + 1024)))
    losses = port.loss((maps, conts), torch.from_numpy(gt), torch.from_numpy(valid),
                       torch.from_numpy(lbl), draws)
    return dict(bf=bf, jax_outs=outs, jstats=new["batch_stats"], jlosses=jlosses,
                maps=maps, conts=conts, losses=losses, port=port)


def test_head_outputs_and_statistics_match_jax(head_run):
    """float32 rtol 1e-5; bfloat16 within two bfloat16 steps of each map's
    largest, its moving statistics (float32 sums of bfloat16 values) rtol
    1e-3 with a floor of 1e-3 of the largest (measured 1.4e-4)."""
    for g, w in zip(head_run["maps"] + head_run["conts"],
                    list(head_run["jax_outs"][0]) + list(head_run["jax_outs"][1])):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if head_run["bf"]:
            assert g.dtype == BF16
            assert np.abs(cases.nhwc(g) - w).max() <= 2 * STEP * np.abs(w).max()
        else:
            cases.close(cases.nhwc(g), w, 1e-5, 1e-6)
    stats = cases.port_state({"batch_stats": head_run["jstats"]}, "head", "bbox_head.")
    assert len(stats) == 12
    for k, w in stats.items():
        cases.close(head_run["port"].state_dict()[k].numpy(), w.numpy(),
                    *((1e-3, 1e-3) if head_run["bf"] else (1e-5, 1e-7)))


@pytest.mark.parametrize("key", cases.LOSS_KEYS)
def test_head_loss_matches_jax(head_run, key):
    got, want = float(head_run["losses"][key].detach()), float(head_run["jlosses"][key])
    assert head_run["losses"][key].dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=STEP if head_run["bf"] else 1e-5)
    assert got > 0


def test_plain_head_loss_matches_jax():
    """``YOLOV3Head`` (the base config's) on one view: its four terms."""
    feats, gt, lbl, valid = _head_inputs(2)
    jf = [jnp.asarray(f) for f in feats]
    head = JHead(**cases.HEAD_CFG, train_cfg=dict(assigner=dict(
        type="GridAssigner", pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0)))
    v = jax.jit(head.init)(jax.random.PRNGKey(0), jf)
    v = cases.randomize({c: {"head": v[c]} for c in v})
    jv = {c: v[c]["head"] for c in v}

    def run(v, f, gt, valid, lbl):
        outs, new = head.apply(v, f, mutable=["batch_stats"])
        return head.apply(dict(v, batch_stats=new["batch_stats"]), outs[0], gt, valid, lbl,
                          method=head.loss, mutable=["batch_stats"])[0]

    want = jax.jit(run)(jv, jf, jnp.asarray(gt[:2]), jnp.asarray(valid[:2]),
                        jnp.asarray(lbl[:2]))
    port = YOLOV3Head(**cases.HEAD_CFG)
    port.load_state_dict(cases.port_state(jv, "head", "bbox_head."), strict=True)
    outs_t = port.train()([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    got = port.loss(outs_t, torch.from_numpy(gt[:2]), torch.from_numpy(valid[:2]),
                    torch.from_numpy(lbl[:2]))
    assert set(got) == set(want) == {"loss_cls", "loss_conf", "loss_xy", "loss_wh"}
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)


def test_anchors_coder_and_targets_match_jax_exactly():
    sizes = [(2, 3), (4, 6), (8, 12)]
    ja = JAnchors(cases.ANCHORS["base_sizes"], cases.ANCHORS["strides"])
    pa = YOLOAnchorGenerator(cases.ANCHORS["base_sizes"], cases.ANCHORS["strides"])
    jp, pp = ja.grid_priors(sizes), pa.grid_priors(sizes)
    assert pa.num_base_priors == [3, 3, 3]
    for g, w in zip(pp, jp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    priors = torch.cat(pp)
    strides = torch.cat([torch.full((len(p),), float(s)) for p, s in zip(pp, (32, 16, 8))])
    rng = np.random.RandomState(8)
    gt, lbl, valid = cases.gts(rng, 3, 7, 64, 96, pad=2)
    gt[0, 1] = gt[0, 0]                                        # two gts on one prior
    gt[2, 2] = [10, 10, 10.5, 10.25]                           # below every IoU
    matched = torch.from_numpy(gt[0])[torch.arange(len(priors)) % 7]
    enc = YOLOBBoxCoder().encode(priors, matched, strides)
    jenc = JCoder().encode(jnp.asarray(priors.numpy()), jnp.asarray(matched.numpy()),
                           jnp.asarray(strides.numpy()))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=0, atol=ULP)
    pred = torch.from_numpy(rng.uniform(-1, 1, (len(priors), 4)).astype(np.float32))
    dec = np.asarray(JCoder().decode(jnp.asarray(priors.numpy()), jnp.asarray(pred.numpy()),
                                     jnp.asarray(strides.numpy())))
    np.testing.assert_allclose(YOLOBBoxCoder().decode(priors, pred, strides).numpy(), dec,
                               rtol=0, atol=np.spacing(np.abs(dec).max()))
    head = JHead(**cases.HEAD_CFG)
    feats = [jnp.zeros((1, h, w, c)) for (h, w), c in zip(sizes, (32, 24, 16))]
    v = jax.jit(head.init)(jax.random.PRNGKey(0), feats)
    tgt, neg = jax.jit(lambda v, *a: head.apply(
        v, *a, method=lambda m, p, s, g, gv, gl: jax.vmap(
            lambda a, b, c: m._targets_single(p, None, s, a, b, c))(g, gv, gl)))(
        v, jnp.asarray(priors.numpy()), jnp.asarray(strides.numpy()), jnp.asarray(gt),
        jnp.asarray(valid), jnp.asarray(lbl))
    port = YOLOV3Head(**cases.HEAD_CFG)
    maps = [torch.zeros(3, 39, h, w) for h, w in sizes]
    got, gneg = port.get_targets(maps, torch.from_numpy(gt), torch.from_numpy(valid),
                                 torch.from_numpy(lbl))
    tgt = np.asarray(tgt)
    np.testing.assert_array_equal(got[..., 4:].numpy(), tgt[..., 4:])
    np.testing.assert_allclose(got[..., :4].numpy(), tgt[..., :4], rtol=0, atol=ULP)
    np.testing.assert_array_equal(gneg.numpy(), np.asarray(neg))
    assert got[..., 4].sum() > 5 and gneg.any()


def test_get_bboxes_matches_jax():
    rng = np.random.RandomState(9)
    n, sizes = 2, [(3, 4), (6, 8), (12, 16)]
    maps = [rng.normal(0, 2, (n, h, w, 39)).astype(np.float32) for h, w in sizes]
    shapes = np.array([[96, 128], [90, 120]], np.float32)
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [0.75, 0.75, 0.75, 0.75]], np.float32)
    test_cfg = dict(nms_pre=200, score_thr=0.05, conf_thr=0.005,
                    nms=dict(type="nms", iou_threshold=0.45), max_per_img=50)
    head = JHead(**cases.HEAD_CFG, test_cfg=test_cfg)
    v = head.init(jax.random.PRNGKey(0), [jnp.zeros((1, h, w, c)) for (h, w), c in
                                          zip(sizes, (32, 24, 16))])
    want = jax.jit(lambda v, m, sh, sf: head.apply(v, (m,), sh, sf, method=head.get_bboxes))(
        v, [jnp.asarray(m) for m in maps], jnp.asarray(shapes), jnp.asarray(sf))
    port = YOLOV3Head(**cases.HEAD_CFG, test_cfg=test_cfg)
    dets, labels, valid = port.get_bboxes(
        ([torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps],), torch.from_numpy(shapes),
        torch.from_numpy(sf))
    wd, wl, wv = (np.asarray(x) for x in want)
    assert wv.sum() > 20
    np.testing.assert_array_equal(valid.numpy(), wv)
    np.testing.assert_array_equal(labels.numpy()[wv], wl[wv])
    np.testing.assert_allclose(dets.numpy()[..., :4][wv], wd[..., :4][wv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.numpy()[..., 4][wv], wd[..., 4][wv], rtol=0, atol=1e-5)


# ------------------------------------------------------------ pipeline ----

def _sample(seed, h=80, w=120, n=6):
    rng = np.random.RandomState(100 + seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    gt, lbl, _ = cases.gts(rng, 1, n, h, w, pad=0)
    return dict(img=img, img_shape=img.shape, ori_shape=img.shape, gt_bboxes=gt[0],
                gt_labels=lbl[0].astype(np.int64), img_fields=["img"],
                bbox_fields=["gt_bboxes"])


OPS = [("Expand", dict(mean=[0, 0, 0], to_rgb=True, ratio_range=(1, 2))),
       ("MinIoURandomCrop", dict(min_ious=(0.4, 0.5, 0.6, 0.7, 0.8, 0.9), min_crop_size=0.3)),
       ("PhotoMetricDistortion", {}),
       ("Resize", dict(img_scale=[(64, 64), (96, 96)], keep_ratio=True))]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("op", [o for o, _ in OPS])
def test_pipeline_op_matches_jax(op, seed):
    kwargs = dict(OPS)[op]
    jop, pop = getattr(jax_transforms, op)(**kwargs), getattr(port_transforms, op)(**kwargs)
    a, b = _sample(seed), _sample(seed)
    np.random.seed(seed)
    want = jop(a)
    after_jax = np.random.rand()
    np.random.seed(seed)
    got = pop(b)
    assert np.random.rand() == after_jax
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["img"].dtype == np.float32


def test_photometric_distortion_covers_the_hsv_tail():
    """A 1x70 row: cv2's HSV->BGR vector loop takes the first 64 pixels,
    its scalar loop the last 6; every op drawn."""
    img = np.random.RandomState(11).uniform(0, 255, (5, 70, 3)).astype(np.float32)
    for seed in range(12):
        np.random.seed(seed)
        want = jax_transforms.PhotoMetricDistortion()(dict(img=img.copy()))["img"]
        np.random.seed(seed)
        got = port_transforms.PhotoMetricDistortion()(dict(img=img.copy()))["img"]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- keep_orig=False ----

def test_keep_orig_false_preprocess_matches_jax_oamix():
    """Every view augmented: the port's preprocess on a (B, V) draw table
    against JAX's ``oamix_batch`` with ``num_views = V + 1`` on the same
    table (one image a call), normalized by the YOLOv3 config's
    ``img_norm_cfg`` (mean 0, std 255, to_rgb)."""
    cfg = load_config(cases.YOLO_OADG)
    oamix_cfg = dict(cfg["oamix_config"], score_thresh=10)
    oamix_cfg.pop("type")
    assert oamix_cfg["keep_orig"] is False and oamix_cfg["num_views"] == 2
    h, w, v = 96, 128, 2
    images = [_image(40 + i) for i in range(2)]
    gts = [_gts(40 + i) for i in range(2)]
    labels = np.random.RandomState(40).randint(0, 8, (2, gts[0][0].shape[0])).astype(np.int32)
    tables = [[_table(40 + 10 * i + j, oamix_cfg["version"]) for j in range(v)]
              for i in range(2)]
    table = {k: np.stack([np.stack([t[k] for t in views]) for views in tables])
             for k in tables[0][0]}
    pre = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"])
    got = pre({"img_raw": torch.from_numpy(np.stack(images)),
               "gt_bboxes": torch.from_numpy(np.stack([g for g, _ in gts])),
               "gt_labels": torch.from_numpy(labels),
               "gt_valid": torch.from_numpy(np.stack([gv for _, gv in gts])),
               "img_shape": torch.tensor([[h, w]] * 2, dtype=torch.float32)},
              torch.Generator(), draws=table)
    assert got["img"].shape == (2 * v, 3, h, w)
    assert {k: t.shape for k, t in pre.draws.items()}["op_idx"][:2] == (2, v)
    jcfg = dict(oamix_cfg, num_views=v + 1)
    fn = jax.jit(lambda im, gt, gv, shape, dr: jax_oamix_batch(
        im, gt, gv, shape, jax.random.PRNGKey(0), jcfg, draws=dr))
    for i in range(2):
        jt = [_jax_table(t, images[i], *gts[i], oamix_cfg) for t in tables[i]]
        jt = {k: jnp.asarray(np.stack([t[k] for t in jt])[None]) for k in jt[0]}
        want = {k: np.asarray(x) for k, x in fn(
            jnp.asarray(images[i][None], jnp.float32), jnp.asarray(gts[i][0][None]),
            jnp.asarray(gts[i][1][None]), jnp.asarray([[h, w]], jnp.float32), jt).items()}
        assert want["aug"].shape == (1, v, h, w, 3)
        for j in range(v):
            view = got["img"][j * 2 + i].permute(1, 2, 0).numpy()[..., ::-1] * 255
            _check_view(torch.from_numpy(np.rint(view).astype(np.uint8)), want["aug"][0, j])
        for k in ("multilevel_boxes", "multilevel_valid", "oamix_boxes", "oamix_valid"):
            np.testing.assert_array_equal(got[k][i].numpy(), want[k][0], err_msg=k)
    for k in ("gt_bboxes", "gt_labels", "gt_valid"):
        torch.testing.assert_close(got[k][2:], got[k][:2], rtol=0, atol=0)


# -------------------------------------------------------- entry points ----

@pytest.mark.parametrize("config,head", [(cases.YOLO_OADG, YOLOV3HeadCont),
                                         (cases.YOLO_BASE, YOLOV3Head)])
def test_init_detector_takes_the_yolo_configs(config, head):
    """Both YOLOv3 configs at full width on the CPU: types, class count,
    the BNs' modes for serving and training, and one 64x96 request."""
    cfg = load_config(config)
    views = int(cfg.get("num_views", 1))
    handle = init_detector(cfg, device="cpu", num_views=views)
    m = handle.model
    assert type(m).__name__ == "YOLOV3" and type(m.bbox_head) is head
    assert handle.num_classes == 8 and len(handle.CLASSES) == 8
    bns = {k: b.training for k, b in m.named_modules() if isinstance(b, BatchNorm)}
    assert len(bns) == 52 + 17 + 3 + 3 * (head is YOLOV3HeadCont)
    assert all(t == (views > 1 and not k.startswith("backbone.")) for k, t in bns.items())
    img = np.random.RandomState(12).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    m.eval()
    dets, labels, valid = handle.test(prepare_image(img, cfg, "cpu"))
    assert dets.shape == (1, 100, 5) and labels.shape == valid.shape == (1, 100)
    assert torch.isfinite(dets).all()


def test_tools_train_then_test_the_tiny_yolo_config(tmp_path):
    """``tools/torch_train.py`` (2 epochs of 2 iterations, OA-Mix on every
    view, an evaluation after each; the neck's and head's BN statistics move,
    the backbone's not) and ``tools/torch_test.py`` on its checkpoint, as
    subprocesses on the CPU; ``build_runner`` with ``resume_from``
    ``epoch_1.pth`` restores its weights and BN buffers bit for bit, its
    iteration and epoch. (A resumed run does not equal the straight one: the
    pipeline's random ops draw from numpy's global generator, which a
    checkpoint does not hold, in the JAX package as in mmdet.)"""
    cfg = cases.tiny_train_cfg(tmp_path / "data")
    path = str(tmp_path / "tiny_yolo.py")
    cfg.dump(path)
    work = str(tmp_path / "work")
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_train.py"), path,
                          "--device", "cpu", "--work-dir", work, "--seed", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    import json
    lines = [json.loads(x) for x in open(os.path.join(work, "log.json"))]
    train = [x for x in lines if x["mode"] == "train"]
    assert len(train) == 4 and sum(x["mode"] == "val" for x in lines) == 2
    assert all(set(cases.LOSS_KEYS) <= set(x) and np.isfinite(x["loss"]) for x in train)
    ckpt = torch.load(os.path.join(work, "epoch_2.pth"), weights_only=True)
    first = torch.load(os.path.join(work, "epoch_1.pth"), weights_only=True)
    sd, sd1 = ckpt["state_dict"], first["state_dict"]
    moved = [k for k in sd if "running_" in k and not torch.equal(sd[k], sd1[k])]
    assert moved and all(not k.startswith("backbone.") for k in moved)
    from oadg_tpu_torch.apis.train import build_runner
    cfg.resume_from = os.path.join(work, "epoch_1.pth")
    det = init_detector(cfg, device="cpu", seed=1, num_views=2).model
    runner = build_runner(det, cfg.data.train, cfg, work_dir=str(tmp_path / "resumed"))
    assert runner.iter == runner.step.t == 2 and runner.epoch == 1
    for k, v in det.state_dict().items():      # weights and BN buffers, bit for bit
        assert torch.equal(v, sd1[k]), k
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_test.py"), path,
                          os.path.join(work, "epoch_2.pth"), "--device", "cpu", "--eval",
                          "bbox"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "bbox_mAP" in run.stdout + run.stderr
