"""DCNv2, ResNeXt and the caffe-C4 Faster R-CNN of the port against the JAX
package, on the CPU.

- ``modulated_deform_conv2d`` (``ops/deform_conv.py``) against JAX's, on
  seeded inputs with offsets of several pixels (some taps fall wholly
  outside the map and must give exactly 0), with deform groups 1 and 2,
  stride 2 and dilation 2: values, and the gradients of the input, the
  offsets, the modulation and the weight, rtol 1e-5 with a floor of 1e-5
  of the largest magnitude (each gradient sums many taps); in bfloat16
  (flax's cast points: the table, the corner weights and the product in
  bfloat16, float32 accumulation) within two bfloat16 steps of the largest
  magnitude;
- the DCNv2 ResNet-50 (``dcn=dict(type='DCNv2')``, ``stage_with_dcn=(False,
  True, True, True)``) and ResNeXt (``groups`` x ``base_width``), narrowed,
  with JAX's weights (``conv_offset`` random, as JAX draws it) and random
  frozen-BN statistics: every stage's output rtol 1e-5 with a floor of
  1e-5 of the largest magnitude; the BN after the deformable and the grouped
  3x3 is applied after it, as in the JAX package (``norm()``), not folded;
- the C4 detector of ``tests/test_forward.py:219`` (a 3-stage caffe ResNet,
  RPN on the one stride-16 level, ``ResLayer`` res5 on 14x14 RoIAlign
  features, the avg-pooled ``BBoxHead``), with the configs' ``type`` keys
  written out and ``bbox_head.in_channels`` set to the shared head's 2048
  (JAX's ``Dense`` takes its width from its input): the training losses
  rtol 1e-5, every trainable gradient within 1e-4 of its largest
  magnitude, ``simple_test``'s detections within 1e-5 of the largest
  coordinate, labels exact. A ReLU whose input sits within float32 noise of
  0 (1e-6 of its largest magnitude) may pass the gradient on one side and
  not on the other: a row of a weight that feeds such a channel may miss
  the 1e-4 bound (measured: one row of ``shared_head.layer4.1.conv1``, of
  1,568 x 512 ReLU inputs after 2048 input channels, 1.5e-4 of the
  largest off); such a row must be at a recorded tie, within 1e-2 of the
  largest magnitude, and there may be at most 4 of them. The shared head's BN affines are frozen by
  ``norm_cfg.requires_grad=False`` as in mmdet; the JAX package trains
  them (ROADMAP C), which the last test shows.
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.backbones.resnet import ResNet as JResNet
from oadg_tpu.models.backbones.resnet import ResNeXt as JResNeXt
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.ops.deform_conv import modulated_deform_conv2d as jax_mdcn
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.backbones import ResNet, ResNeXt
from oadg_tpu_torch.models.backbones.resnet import Bottleneck
from oadg_tpu_torch.ops.deform_conv import modulated_deform_conv2d
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from test_torch_baseline import KEYS, _jax_draws
from test_torch_train_step import _batch, _randomize

torch.set_num_threads(2)
BF16_STEP = 2.0 ** -8


def _close(got, want, rtol=1e-5, floor=1e-5, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-12), err_msg=msg)


# ------------------------------------------------------------------ DCNv2 ----

DCN_CASES = {"s1": dict(stride=1, padding=1, dilation=1, dg=1),
             "s2": dict(stride=2, padding=1, dilation=1, dg=1),
             "dil2-dg2": dict(stride=1, padding=2, dilation=2, dg=2)}


def _dcn_inputs(case):
    c = DCN_CASES[case]
    rng = np.random.RandomState(len(case))
    b, cin, h, w, cout, k = 2, 6, 11, 13, 5, 3
    ho = (h + 2 * c["padding"] - c["dilation"] * (k - 1) - 1) // c["stride"] + 1
    wo = (w + 2 * c["padding"] - c["dilation"] * (k - 1) - 1) // c["stride"] + 1
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    off = rng.normal(0, 2.5, (b, ho, wo, c["dg"] * k * k * 2)).astype(np.float32)
    off[0, 0, 0, :2] = -40.0                  # tap 0 of pixel (0, 0) wholly outside
    mask = rng.uniform(0.1, 1, (b, ho, wo, c["dg"] * k * k)).astype(np.float32)
    wt = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return c, x, off, mask, wt, bias


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("case", list(DCN_CASES))
def test_modulated_deform_conv_and_gradients_match_jax(case):
    c, x, off, mask, wt, bias = _dcn_inputs(case)
    kw = dict(stride=c["stride"], padding=c["padding"], dilation=c["dilation"],
              deform_groups=c["dg"])
    rng = np.random.RandomState(1)

    def jfun(x, off, mask, wt):
        y = jax_mdcn(x, off, mask, wt, bias=jnp.asarray(bias), **kw)
        return jnp.sum(y * jnp.asarray(dy)), y

    want_y = jax_mdcn(*map(jnp.asarray, (x, off, mask, wt)), bias=jnp.asarray(bias), **kw)
    dy = rng.normal(0, 1, want_y.shape).astype(np.float32)
    (_, want_y), grads = jax.value_and_grad(jfun, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, off, mask, wt)))
    tx, toff, tmask = (_nchw(a).requires_grad_(True) for a in (x, off, mask))
    tw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))).requires_grad_(True)
    y = modulated_deform_conv2d(tx, toff, tmask, tw, bias=torch.from_numpy(bias), **kw)
    (y * _nchw(dy)).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), want_y, floor=1e-6)
    for name, got, want in (("x", tx.grad.permute(0, 2, 3, 1), grads[0]),
                            ("offset", toff.grad.permute(0, 2, 3, 1), grads[1]),
                            ("mask", tmask.grad.permute(0, 2, 3, 1), grads[2]),
                            ("weight", tw.grad.permute(2, 3, 1, 0), grads[3])):
        _close(got.numpy(), want, msg=name)
    # tap 0 of pixel (0, 0) reads nothing: its modulation gets no gradient
    assert float(tmask.grad[0, 0, 0, 0]) == 0.0


def test_modulated_deform_conv_bf16_follows_flax_cast_points():
    c, x, off, mask, wt, bias = _dcn_inputs("s1")
    kw = dict(stride=1, padding=1, dilation=1, deform_groups=1)
    want = np.asarray(jax_mdcn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(off), jnp.asarray(mask),
                               jnp.asarray(wt, jnp.bfloat16), **kw).astype(jnp.float32))
    got = modulated_deform_conv2d(_nchw(x).to(torch.bfloat16), _nchw(off), _nchw(mask),
                                  torch.from_numpy(np.ascontiguousarray(
                                      wt.transpose(3, 2, 0, 1))).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    f32 = modulated_deform_conv2d(_nchw(x), _nchw(off), _nchw(mask), torch.from_numpy(
        np.ascontiguousarray(wt.transpose(3, 2, 0, 1))), **kw).permute(0, 2, 3, 1).numpy()
    got = got.float().permute(0, 2, 3, 1).numpy()
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * BF16_STEP * top
    # and bfloat16 is not float32: the rounding shows
    assert np.abs(got - f32).max() > 0


# ------------------------------------------------------ backbones vs JAX ----

def _random_variables(init, *args, seed=0):
    """Variables of the shapes ``init(*args)`` makes (traced, not compiled):
    LeCun-normal kernels (the JAX package's default), zero biases, identity
    BN."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, *args)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _randomize_bn(variables, seed=0):
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, sub in params.items():
            if k.startswith("FrozenBN") or k == "downsample_bn":
                shape = sub["scale"].shape
                sub["scale"] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, shape).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(k, {}))

    walk(v["params"], v["batch_stats"])
    return v


BACKBONES = {
    "dcn": (JResNet, ResNet, dict(depth=50, base_channels=8, stem_channels=8,
                                  dcn=dict(type="DCNv2", deform_groups=1),
                                  stage_with_dcn=(False, True, True, True))),
    "resnext": (JResNeXt, ResNeXt, dict(depth=50, groups=4, base_width=4,
                                        base_channels=16, stem_channels=8)),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_matches_jax(name):
    jcls, cls, kw = BACKBONES[name]
    x = np.random.RandomState(2).normal(0, 1, (2, 48, 64, 3)).astype(np.float32)
    jm = jcls(**kw)
    variables = _randomize_bn(_random_variables(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    sd = jax_variables_to_state_dict({k: {"backbone_m": v} for k, v in variables.items()})
    m = cls(**kw)
    m.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    if name == "dcn":
        offsets = [k for k in sd if "conv_offset.weight" in k]
        assert len(offsets) == 13 and all(float(sd[k].abs().max()) > 0 for k in offsets)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1).numpy(), w, msg=f"stage {i}")


# ---------------------------------------------------------------- C4 ----

NORM = dict(type="BN", requires_grad=False)
C4 = dict(
    type="FasterRCNN",
    backbone=dict(type="ResNet", depth=50, num_stages=3, strides=(1, 2, 2),
                  dilations=(1, 1, 1), out_indices=(2,), frozen_stages=1, norm_cfg=NORM,
                  style="caffe", base_channels=8, stem_channels=8),
    rpn_head=dict(type="RPNHead", in_channels=128, feat_channels=32,
                  anchor_generator=dict(type="AnchorGenerator", scales=[2, 4],
                                        ratios=[1.0], strides=[16]),
                  bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0.0] * 4,
                                  target_stds=[1.0] * 4)),
    roi_head=dict(
        type="StandardRoIHead",
        shared_head=dict(type="ResLayer", depth=50, stage=3, stride=2, style="caffe",
                         norm_cfg=NORM),
        bbox_roi_extractor=dict(type="SingleRoIExtractor",
                                roi_layer=dict(type="RoIAlign", output_size=14,
                                               sampling_ratio=0),
                                out_channels=128, featmap_strides=[16]),
        bbox_head=dict(type="BBoxHead", with_avg_pool=True, in_channels=2048,
                       num_classes=8)),
    train_cfg=dict(
        rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7, neg_iou_thr=0.3,
                               min_pos_iou=0.3),
                 sampler=dict(type="RandomSampler", num=32, pos_fraction=0.5,
                              add_gt_as_proposals=False)),
        rpn_proposal=dict(nms_pre=60, max_per_img=30, nms=dict(iou_threshold=0.7),
                          min_bbox_size=0),
        rcnn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.5,
                                min_pos_iou=0.5, match_low_quality=False),
                  sampler=dict(type="RandomSampler", num=16, pos_fraction=0.25))),
    test_cfg=dict(rpn=dict(nms_pre=40, max_per_img=20, nms=dict(iou_threshold=0.7),
                           min_bbox_size=0),
                  rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5), max_per_img=5)))
B, G = 2, 5


@contextlib.contextmanager
def _relu_ties(det):
    """Record, for every bottleneck's three ReLUs (after conv1, conv2 and the
    residual sum), the channels whose input comes within 1e-6 of its
    largest magnitude of 0 without being 0 (an exact 0 is 0 on both sides,
    and both pass no gradient there): ``{weight name: rows}``."""
    ties, handles = {}, []
    for name, block in det.named_modules():
        if not isinstance(block, Bottleneck):
            continue
        feeds = [[f"{name}.conv1.weight"], [f"{name}.conv2.weight"],
                 [f"{name}.conv3.weight"]
                 + ([f"{name}.downsample.0.weight"] if block.downsample is not None else [])]
        calls = []

        def hook(mod, inp, feeds=feeds, calls=calls):
            z = inp[0].detach()
            near = ((z != 0) & (z.abs() < 1e-6 * z.abs().max())).any(dim=(0, 2, 3))
            for w in feeds[len(calls) % 3]:
                ties.setdefault(w, set()).update(near.nonzero().flatten().tolist())
            calls.append(1)

        handles.append(block.relu.register_forward_pre_hook(hook))
    try:
        yield ties
    finally:
        for h in handles:
            h.remove()


@pytest.fixture(scope="module")
def c4():
    batch = {k: v[:B] for k, v in _batch().items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(C4, num_views=1)
    variables = _randomize(_random_variables(
        lambda r, b: jdet.init(r, b, "test"),
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jb["img"], "img_shape": jb["img_shape"]}))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 2]

    def loss_fn(params, stats, b):
        losses = jdet.apply({"params": params, "batch_stats": stats}, b, "train")
        return sum(v for k, v in losses.items() if "loss" in k), losses

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jb)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 2
    jtest = jax.jit(lambda v, b: jdet.apply(v, b, "test"))(
        variables, {k: jb[k] for k in ("img", "img_shape")})

    det = build_detector(C4, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    det.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = det.extract_feat(tb["img"])
    assert len(feats) == 1 and feats[0].shape[1] == 128
    num_anchors = 2 * feats[0].shape[2] * feats[0].shape[3]
    rp = C4["train_cfg"]["rpn_proposal"]["max_per_img"]
    with _relu_ties(det) as ties:
        losses = det.forward_train(tb, UniformDraws(given=_jax_draws(num_anchors, G + rp)))
    sum(v for k, v in losses.items() if "loss" in k).backward()
    det.eval()
    with torch.no_grad():
        test = det.simple_test(tb)
    return dict(det=det, losses=losses, jlosses=jlosses, test=test, jtest=jtest, ties=ties,
                want=jax_variables_to_state_dict(
                    {"params": jax.tree_util.tree_map(np.asarray, jgrads)}))


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc",
                                 "loss_bbox"])
def test_c4_losses_match_jax(c4, key):
    np.testing.assert_allclose(float(c4["losses"][key].detach()),
                               float(c4["jlosses"][key]), rtol=1e-5)


def test_c4_gradients_match_jax(c4):
    det, want = c4["det"], c4["want"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    assert any(k.startswith("roi_head.shared_head.layer4.2.conv3") for k, _ in trainable)
    exceptions = []
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        top = max(np.abs(w).max(), 1e-12)
        g = p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * top, err_msg=name)
        off = np.abs(g - w).reshape(len(w), -1).max(axis=1) > 1e-4 * top
        for row in np.flatnonzero(off):
            assert row in c4["ties"].get(name, ()), (name, row)
            exceptions.append((name, row))
    assert len(exceptions) <= 4, exceptions


def test_c4_simple_test_matches_jax(c4):
    dets, labels, valid = (t.numpy() for t in c4["test"])
    jd, jl, jv = (np.asarray(t) for t in c4["jtest"])
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    assert valid.sum() > 0
    np.testing.assert_allclose(dets, jd, rtol=0, atol=1e-5 * np.abs(jd).max())


def test_c4_shared_head_bn_frozen_where_jax_trains_it(c4):
    """``norm_cfg=dict(requires_grad=False)`` freezes the shared head's BN
    affines in the port (mmdet's ``ResLayer``); JAX's optimizer mask freezes
    backbone norms only, and its gradients for them are not zero."""
    det, want = c4["det"], c4["want"]
    bn = [k for k, _ in det.named_parameters()
          if k.startswith("roi_head.shared_head.") and ".bn" in k or ".downsample.1." in k]
    bn = [k for k in bn if k.startswith("roi_head.shared_head.")]
    assert len(bn) == 2 * 10
    assert all(not dict(det.named_parameters())[k].requires_grad for k in bn)
    assert sum(float(want[k].abs().max()) > 0 for k in bn) == len(bn)
