"""The port's bfloat16 compute mode against the JAX package's, on the CPU.

``build_detector(..., dtype=torch.bfloat16)`` against ``oadg_tpu``'s
``build_detector(..., dtype=jnp.bfloat16)``: float32 parameters, convolutions
and FCs in bfloat16 with the frozen BN folded into the conv, losses, the
contrastive loss and the serving softmax on float32 casts, RoIAlign on
bfloat16 maps. Inputs are made with numpy from a seed; the tiny flagship
(``__graft_entry__._flagship_model_cfg(tiny=True)``) carries the JAX
variables over through ``jax_variables_to_state_dict`` as the float32 tests
do (``test_torch_train_step.py``, ``test_torch_slice.py``, whose batches,
randomized weights and sampling draws this file reuses). Each JAX function is
traced once.

Tolerances, from bfloat16's step of 2**-8 relative (2**-7 at a value just
above a power of two):

- the folded conv, backbone and FPN: both frameworks widen bfloat16 to
  float32, sum in float32 and round once, so values agree but where a float32
  sum taken in another order lands across a rounding boundary: at most one
  step of the output's magnitude (2**-7 of the largest), on a small share of
  values (at most 1e-3, measured 4e-5);
- proposals on equal inputs: the same indices, scores and validity exactly,
  boxes to 1e-3 px (both decode the bfloat16 deltas in float32);
- RoIAlign's plain forward on bfloat16 maps: float32 sums of the same
  products, rtol 1e-5; its gradient, accumulated in float32 and rounded once,
  within one bfloat16 step of JAX's under ``OADG_ROI_BWD_F32=1`` (measured:
  equal); against JAX's default bfloat16 table (each tap's update rounded,
  then added in bfloat16) the error is measured and bounded by 2**-4 of the
  largest gradient (measured 2.1e-2);
- RPN proposals: the sigmoid of bfloat16 logits is XLA's expansion with
  each operation rounded (``rpn_head.sigmoid``); one step off reorders
  near-tied proposals, so the rows must agree exactly;
- losses of one step: one bfloat16 step, rtol 2**-8 (measured <= 1e-7);
- trainable gradients (float32): kernels within 1e-2 of their largest
  magnitude (measured 7.0e-3, from bfloat16 activations in the backward);
  biases within 1.25e-1 (measured 9.1e-2): XLA's CPU backend adds a bias
  gradient's terms one by one in bfloat16 (``test_jax_cpu_sums_a_bias_
  gradient_in_bfloat16``), the port in float32; one SGD update on identical
  gradients 1e-6;
- serving: RoI features (float32 from bfloat16 maps) rtol 1e-4, atol 1e-5,
  as ``test_torch_slice.py``; head outputs as the folded conv; validity,
  labels and order exactly, boxes and scores to 1e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import pytest
import torch

from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.backbones.resnet import conv_norm
from oadg_tpu.models.dense_heads.rpn_head import RPNHead as JRPNHead
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.models.layers import build_norm, norm_eval_cfg
from oadg_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align
from oadg_tpu.core.bbox.coder import DeltaXYWHBBoxCoder as JCoder
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.core.bbox import DeltaXYWHBBoxCoder
from oadg_tpu_torch.core.post_processing.nms import sort_desc
from oadg_tpu_torch.engine import build_optimizer, make_oadg_preprocess, make_train_step
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.dense_heads import RPNHead
from oadg_tpu_torch.models.layers import Conv, FrozenBN, Linear, conv_frozen_bn
from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD,
                                          roi_align_multilevel,
                                          roi_align_multilevel_ref)
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

import test_torch_slice as slice_case
import test_torch_train_step as step_case

torch.set_num_threads(2)
BF16 = torch.bfloat16
STEP = 2.0 ** -8                 # bfloat16's relative step
FLAGSHIP = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"


def _np(t):
    return t.detach().float().numpy()


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def assert_bf16_close(got, want, share=1e-3):
    """``got`` equals ``want`` but for at most ``share`` of the values, each
    at most one bfloat16 step of the largest magnitude (2**-7) apart."""
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert diff.max() <= 2 * STEP * np.abs(want).max(), diff.max()
    assert np.mean(diff > 0) <= share, np.mean(diff > 0)


# ----------------------------------------------------------- folded conv ----

class _ConvNorm(fnn.Module):
    """``conv_norm``: a conv with its frozen BN folded in (resnet.py:30)."""
    feats: int
    k: int
    s: int
    p: int
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        norm = build_norm(norm_eval_cfg(None, True), self.dtype)
        return conv_norm(x, self.feats, self.k, self.s, self.p, norm, self.dtype, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,k,s,p", [(3, 7, 2, 3), (16, 3, 1, 1), (16, 1, 2, 0)],
                         ids=["stem7x7s2", "3x3", "1x1s2"])
def test_folded_conv_matches_jax(dtype, cin, k, s, p):
    """The 7x7/s2 stem (JAX's space-to-depth form), a 3x3 and a strided 1x1,
    each with a randomized frozen BN folded in."""
    rng = np.random.RandomState(k + s)
    x = rng.normal(0, 1, (2, 32, 48, cin)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jm = _ConvNorm(24, k, s, p, jdt)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(k), jnp.asarray(x)))
    bn = dict(scale=rng.uniform(0.5, 1.5, 24), bias=rng.normal(0, 0.3, 24))
    stats = dict(mean=rng.normal(0, 0.3, 24), var=rng.uniform(0.5, 1.5, 24))
    v["params"]["FrozenBN_0"] = {k_: a.astype(np.float32) for k_, a in bn.items()}
    v["batch_stats"]["FrozenBN_0"] = {k_: a.astype(np.float32) for k_, a in stats.items()}
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))).astype(np.float32)

    tdt = None if dtype == "float32" else BF16
    conv, frozen = Conv(cin, 24, k, s, p, bias=False, dtype=tdt), FrozenBN(24)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(v["params"]["conv"]["Conv_0"]["kernel"]
                                           .transpose(3, 2, 0, 1).copy()))
        frozen.weight.copy_(torch.from_numpy(v["params"]["FrozenBN_0"]["scale"]))
        frozen.bias.copy_(torch.from_numpy(v["params"]["FrozenBN_0"]["bias"]))
        frozen.running_mean.copy_(torch.from_numpy(v["batch_stats"]["FrozenBN_0"]["mean"]))
        frozen.running_var.copy_(torch.from_numpy(v["batch_stats"]["FrozenBN_0"]["var"]))
        got = conv_frozen_bn(conv, frozen, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == (torch.float32 if tdt is None else BF16)
    if tdt is None:
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
        with torch.no_grad():          # the fold is the conv followed by the BN
            unfolded = frozen(conv(torch.from_numpy(x).permute(0, 3, 1, 2)))
        np.testing.assert_allclose(_np(got), _np(unfolded), rtol=1e-5, atol=1e-5)
    else:
        assert_bf16_close(_nhwc(got), want)


def test_reduced_layers_cast_like_flax():
    """``Conv`` and ``Linear`` at bfloat16 against ``flax.linen.Conv`` and
    ``Dense`` with ``dtype=bfloat16`` (input, kernel and bias cast, the bias
    added in bfloat16); parameters stay float32 and their gradients come
    back float32; ``dtype=None`` is ``nn.Conv2d`` / ``nn.Linear``."""
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (2, 12, 16, 8)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, 8, 16)).astype(np.float32)
    b = rng.normal(0, 0.3, 16).astype(np.float32)
    want = fnn.Conv(16, (3, 3), padding=[(1, 1), (1, 1)], dtype=jnp.bfloat16).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    conv = Conv(8, 16, 3, 1, 1, dtype=BF16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(b))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == BF16 and conv.weight.dtype == torch.float32
    assert_bf16_close(_nhwc(got), np.asarray(want).astype(np.float32))
    got.float().sum().backward()
    assert conv.weight.grad.dtype == conv.bias.grad.dtype == torch.float32

    xf = rng.normal(0, 1, (30, 40)).astype(np.float32)
    kd = rng.normal(0, 0.2, (40, 24)).astype(np.float32)
    want = fnn.Dense(24, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kd, "bias": b[:8].repeat(3)}}, jnp.asarray(xf))
    fc = Linear(40, 24, dtype=BF16)
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(kd.T.copy()))
        fc.bias.copy_(torch.from_numpy(b[:8].repeat(3)))
    out = fc(torch.from_numpy(xf))
    assert out.dtype == BF16
    assert_bf16_close(_np(out), np.asarray(want).astype(np.float32))

    plain = torch.nn.Conv2d(8, 16, 3, padding=1)
    plain.load_state_dict(conv.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    f32 = Conv(8, 16, 3, 1, 1)
    f32.load_state_dict(conv.state_dict())
    assert torch.equal(f32(xt), plain(xt))


def test_build_detector_takes_float32_or_bfloat16():
    _, model = _flagship_model_cfg(tiny=True)
    for dtype, want in ((None, torch.float32), (torch.float32, torch.float32), (BF16, BF16)):
        det = build_detector(dict(model), device="cpu", dtype=dtype)
        assert det.dtype == want
        assert all(p.dtype == torch.float32 for p in det.parameters())
    with pytest.raises(ValueError):
        build_detector(dict(model), device="cpu", dtype=torch.float16)


# ------------------------------------------------- proposals, ties, decode ----

def _tied_rpn_inputs(seed=0):
    """bfloat16 objectness of 2 images over 3 levels, drawn from 24 values so
    that most scores tie, and bfloat16 deltas; NCHW for the port."""
    rng = np.random.RandomState(seed)
    sizes = [(16, 24), (8, 12), (4, 6)]
    cls = [(rng.randint(-12, 12, (2, h, w, 3)) / 4).astype(np.float32) for h, w in sizes]
    reg = [rng.normal(0, 0.5, (2, h, w, 12)).astype(np.float32) for h, w in sizes]
    to_bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    return [to_bf(c) for c in cls], [to_bf(r) for r in reg], sizes


def test_proposals_select_over_tied_bfloat16_scores_as_jax():
    """Proposals on the same bfloat16 head outputs: ``top_k`` over bfloat16
    logits (ties to the lower index), the sigmoid in bfloat16, NMS on those
    scores, the final ``top_k``; the same rows, scores and boxes as JAX."""
    cls, reg, sizes = _tied_rpn_inputs()
    ag = dict(type="AnchorGenerator", scales=[8], ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16])
    coder = dict(type="DeltaXYWHBBoxCoder", target_means=[0.0] * 4, target_stds=[1.0] * 4)
    cfg = dict(nms_pre=200, max_per_img=150, nms=dict(type="nms", iou_threshold=0.7),
               min_bbox_size=0)
    shapes = np.array([[64, 96], [56, 80]], np.float32)
    jhead = JRPNHead(in_channels=8, feat_channels=8, anchor_generator=ag, bbox_coder=coder)
    want = jax.jit(lambda c, r, s: jhead.apply({}, c, r, s, cfg, method=JRPNHead.get_proposals))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg], jnp.asarray(shapes))
    wb, ws, wv = (np.asarray(t) for t in want)
    head = RPNHead(8, 8, anchor_generator=ag, bbox_coder=coder, test_cfg=cfg)
    to_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF16).permute(0, 3, 1, 2)
    gb, gs, gv = head.get_proposals([to_t(c) for c in cls], [to_t(r) for r in reg],
                                    torch.from_numpy(shapes))
    assert gs.dtype == BF16 and ws.dtype == jnp.bfloat16 and gb.dtype == torch.float32
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(_np(gs), ws.astype(np.float32))
    np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=1e-3)
    # the scores tie: many equal neighbours among the kept rows
    kept = ws.astype(np.float32)[wv]
    assert np.sum(kept[1:] == kept[:-1]) > 50 and wv.sum() > 200


def test_proposal_sigmoid_is_jax_sigmoid_on_every_bfloat16():
    """``rpn_head.sigmoid`` against jitted ``jax.nn.sigmoid`` on every finite
    bfloat16 value above the float32 exp's overflow (x > -88)."""
    from oadg_tpu_torch.models.dense_heads.rpn_head import sigmoid
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(BF16)
    x = x[torch.isfinite(x) & (x.float() > -87.0)]
    want = jax.jit(jax.nn.sigmoid)(jnp.asarray(_np(x)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_np(sigmoid(x)), np.asarray(want).astype(np.float32))
    assert not torch.equal(sigmoid(x), torch.sigmoid(x))     # one rounding is not it


def test_sort_desc_is_top_k_on_bfloat16_ties():
    x = (np.random.RandomState(1).randint(-40, 40, (3, 500)) / 8).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wv, wi = jax.jit(lambda a: jax.lax.top_k(a, 300))(xb)
    gv, gi = sort_desc(torch.from_numpy(x).to(BF16), 300)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(_np(gv), np.asarray(wv).astype(np.float32))


def test_decode_widens_bfloat16_deltas_to_float32_as_jax():
    """``deltas * stds + means`` with numpy float32 ``stds`` promotes JAX's
    bfloat16 deltas to float32 (a numpy array is not weakly typed); the
    port's float32 tensors promote the same way."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 200, (300, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 80, (300, 2))], 1).astype(np.float32)
    deltas = np.asarray(jnp.asarray(rng.normal(0, 1.5, (300, 4)).astype(np.float32))
                        .astype(jnp.bfloat16))
    stds = (0.1, 0.1, 0.2, 0.2)
    want = JCoder((0.0,) * 4, stds).decode(jnp.asarray(anchors), jnp.asarray(deltas),
                                           max_shape=(240.0, 320.0))
    got = DeltaXYWHBBoxCoder((0.0,) * 4, stds).decode(
        torch.from_numpy(anchors), torch.from_numpy(deltas.astype(np.float32)).to(BF16),
        max_shape=(240.0, 320.0))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6 * 320)


# ------------------------------------------------------------- RoIAlign ----

def _pyramid(seed=4):
    """bfloat16 maps of 2 images at 4 levels (C=8) and 80 rois over every
    level, overlapping so that the gradient adds across rois."""
    rng = np.random.RandomState(seed)
    sizes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    maps = [np.asarray(jnp.asarray(rng.normal(0, 1, (2, h, w, 8)).astype(np.float32))
                       .astype(jnp.bfloat16)) for h, w in sizes]
    wh = np.exp(rng.uniform(np.log(3), np.log(150), (80, 2)))
    xy = rng.uniform(-10, 170, (80, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    rois = np.concatenate([rng.randint(0, 2, (80, 1)), boxes], 1).astype(np.float32)
    dy = rng.normal(0, 1, (80, 7, 7, 8)).astype(np.float32)
    return maps, rois, dy


def _jax_roi_grad(maps, rois, dy):
    f = lambda fs: jnp.sum(jax_roi_align(fs, jnp.asarray(rois), 7, (4, 8, 16, 32), 2, 56)
                           * jnp.asarray(dy))
    return [np.asarray(g).astype(np.float32)
            for g in jax.jit(jax.grad(f))([jnp.asarray(m) for m in maps])]


@pytest.fixture(scope="module")
def roi_case():
    maps, rois, dy = _pyramid()
    tmaps = [torch.from_numpy(m.astype(np.float32)).to(BF16).permute(0, 3, 1, 2).requires_grad_()
             for m in maps]
    out = roi_align_multilevel(tmaps, torch.from_numpy(rois), 7, (4, 8, 16, 32), 2, 56)
    (out * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()
    return maps, rois, dy, out, [_nhwc(m.grad) for m in tmaps], tmaps


def test_roi_align_forward_on_bfloat16_maps(roi_case):
    maps, rois, _, out, _, tmaps = roi_case
    want = jax.jit(lambda fs: jax_roi_align(fs, jnp.asarray(rois), 7, (4, 8, 16, 32), 2, 56))(
        [jnp.asarray(m) for m in maps])
    assert want.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        _np(out), _np(roi_align_multilevel_ref([m.detach() for m in tmaps],
                                               torch.from_numpy(rois))))


def test_roi_align_gradient_is_one_bfloat16_rounding_of_jax_f32_table(roi_case, monkeypatch):
    """``OADG_ROI_BWD_F32=1``: JAX accumulates in float32 and rounds once, as
    the port does; the two float32 sums differ in order only."""
    maps, rois, dy, _, grads, tmaps = roi_case
    monkeypatch.setenv("OADG_ROI_BWD_F32", "1")
    want = _jax_roi_grad(maps, rois, dy)
    for g, w, m in zip(grads, want, tmaps):
        assert m.grad.dtype == BF16
        assert np.all(np.abs(g - w) <= STEP * np.abs(w) + 1e-6 * np.abs(w).max())
    assert sum(np.count_nonzero(w) for w in want) > 1000


def test_roi_align_gradient_against_jax_bfloat16_table(roi_case, monkeypatch):
    """JAX's default for bfloat16 maps rounds each tap's update to bfloat16
    and adds them in a bfloat16 table (``roi_align.py:691-701``); the port
    keeps the float32 table. The difference is that table's rounding error:
    measured 2.1e-2 of the largest gradient, bounded here by 2**-4."""
    maps, rois, dy, _, grads, _ = roi_case
    monkeypatch.delenv("OADG_ROI_BWD_F32", raising=False)
    want = _jax_roi_grad(maps, rois, dy)
    scale = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(grads, want))
    assert 0 < err <= 2 ** -4 * scale


# ------------------------------------------------------ one training step ----

@pytest.fixture(scope="module")
def step():
    _, model = _flagship_model_cfg(tiny=True)
    B, V, G = step_case.B, step_case.V, step_case.G
    batch = step_case._batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["img"] = jbatch["img"].astype(jnp.bfloat16)   # the model's dtype, as apis/train.py
    jdet = jax_build_detector(model, num_views=V, dtype=jnp.bfloat16)
    variables = step_case._randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jbatch["img"], "img_shape": jbatch["img_shape"]}))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return step_case.KEYS[(len(calls) - 1) % 3]

    def loss_fn(params, batch_stats, b):
        v = {"params": params, "batch_stats": batch_stats}
        losses = jdet.apply(v, b, "train")

        def pieces(m, b):
            feats = m.extract_feat(b["img"])
            cls, reg = m.rpn(feats)
            props = m.rpn.get_proposals([c[:B] for c in cls], [r[:B] for r in reg],
                                        b["img_shape"][:B], dict(m.train_cfg)["rpn_proposal"])
            return feats, props

        return sum(v_ for k, v_ in losses.items() if "loss" in k), (
            losses, jdet.apply(v, b, method=pieces))

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        (_, (jlosses, (jfeats, jprops))), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 3

    det = init_detector({"model": model}, device="cpu", num_views=V, dtype=BF16).model
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tbatch = step_case._torch_batch(batch)
    tbatch["img"] = tbatch["img"].to(BF16)
    with torch.no_grad():
        feats = det.extract_feat(tbatch["img"])
        cls, reg = det.rpn_head(feats)
        props = det.rpn_head.get_proposals(
            [c[:B] for c in cls], [r[:B] for r in reg], tbatch["img_shape"][:B],
            model["train_cfg"]["rpn_proposal"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=step_case._jax_draws(num_anchors, G + rp, 10))
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    losses = det.forward_train(tbatch, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd, bwd)
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16)
    return dict(model=model, variables=variables, jlosses=jlosses, jgrads=jgrads,
                want_grads=want_grads, losses=losses, det=det, batch=tbatch,
                feats=feats, jfeats=jax.tree_util.tree_map(np.asarray, jfeats),
                props=props, jprops=jax.tree_util.tree_map(np.asarray, jprops))


def test_backbone_and_fpn_match_jax(step):
    assert len(step["feats"]) == len(step["jfeats"]) == 5
    for g, w in zip(step["feats"], step["jfeats"]):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        assert_bf16_close(_nhwc(g), w.astype(np.float32))


def test_training_proposals_match_jax(step):
    (gb, gs, gv), (wb, ws, wv) = step["props"], step["jprops"]
    assert gs.dtype == BF16
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(_np(gs), ws.astype(np.float32))
    np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=1e-3)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                 "acc", "loss_bbox", "loss_cont"])
def test_loss_matches_jax(step, key):
    want = float(step["jlosses"][key])
    got = step["losses"][key].detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=STEP, atol=1e-6)
    if key == "loss_cont":
        assert float(got) > 0


def test_every_trainable_gradient_matches_jax(step):
    det, want = step["det"], step["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    assert len(trainable) == 79
    for name, p in trainable:
        w = want[name].numpy()
        assert p.dtype == p.grad.dtype == torch.float32, name
        tol = 1.25e-1 if name.endswith("bias") else 1e-2
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)
        assert np.abs(w).max() > 0, name
    for name, p in det.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and not np.any(want[name].numpy()), name


def test_jax_cpu_sums_a_bias_gradient_in_bfloat16():
    """Why bias gradients get the wider tolerance: the transpose of a
    bfloat16 bias add is a sum that XLA's CPU backend accumulates term by
    term in bfloat16; the port's sum accumulates in float32 and rounds once,
    the float64 sum rounded to bfloat16 in all but a few channels."""
    g = np.random.RandomState(6).normal(0, 1, (4, 24, 32, 16)).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.zeros_like(gb) + b.astype(jnp.bfloat16),
                     jnp.zeros(16, jnp.float32))
    want = np.asarray(jax.jit(lambda c: vjp(c)[0])(gb))
    seq = torch.zeros(16, dtype=BF16)
    for r in torch.from_numpy(np.asarray(gb).astype(np.float32)).to(BF16).reshape(-1, 16):
        seq = seq + r
    np.testing.assert_array_equal(want, _np(seq))
    bias = torch.zeros(16, requires_grad=True)
    (torch.zeros(4, 16, 24, 32, dtype=BF16) + bias.to(BF16)[:, None, None]).backward(
        torch.from_numpy(np.asarray(gb).astype(np.float32)).to(BF16).permute(0, 3, 1, 2))
    exact = np.asarray(gb).astype(np.float64).sum((0, 1, 2))
    assert np.abs(bias.grad.numpy() - exact).max() < np.abs(want - exact).max() / 4


def test_sgd_update_matches_jax_optimizer(step):
    cfg = load_config(FLAGSHIP)
    det = step["det"]
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    opt = build_optimizer(det, cfg.optimizer)
    for name, p in det.named_parameters():
        p.grad = step["want_grads"][name].clone() if p.requires_grad else None
    opt.step()
    after = {k: p.detach().clone() for k, p in det.named_parameters()}
    with torch.no_grad():
        for name, p in det.named_parameters():
            p.copy_(before[name])
    jparams = step["variables"]["params"]
    tx = jax_build_optimizer(jparams, cfg.optimizer, lambda t: cfg.optimizer["lr"],
                             model_cfg=step["model"])
    jafter = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(step["jgrads"], jparams))}, roi_channels=16)
    moved = 0
    for name, p in det.named_parameters():
        if p.requires_grad:
            assert after[name].dtype == torch.float32
            np.testing.assert_allclose(after[name].numpy(), jafter[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
            moved += not torch.equal(after[name], before[name])
    assert moved == 79


def test_bfloat16_train_step_on_the_cpu():
    """``make_train_step`` on a bfloat16 model with the OA-Mix preprocess
    built with the model's dtype: the images reach the model in bfloat16,
    losses are float32 and finite, trainable parameters (float32) move and
    frozen ones do not, no kernel launches on CPU tensors."""
    cfg = load_config(FLAGSHIP)
    oamix_cfg = dict(cfg["oamix_config"], score_thresh=10)
    oamix_cfg.pop("type")
    _, model = _flagship_model_cfg(tiny=True)
    det = init_detector({"model": model}, device="cpu", num_views=2, dtype=BF16, seed=3).model
    preprocess = make_oadg_preprocess(oamix_cfg, cfg.img_norm_cfg, out_dtype=det.dtype)
    seen = []
    forward_train = det.forward_train
    det.forward_train = lambda b, d: (seen.append(b["img"].dtype), forward_train(b, d))[1]
    # at the config's base LR: the warmup's first LR (1e-5) moves a frozen-BN
    # weight of 1 by less than half a float32 step
    step = make_train_step(det, build_optimizer(det, cfg.optimizer),
                           lambda t: cfg.optimizer["lr"], preprocess=preprocess)
    rng = np.random.RandomState(0)
    gt = step_case._batch()["gt_bboxes"][:2]
    batch = {"img_raw": torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)),
             "gt_bboxes": torch.from_numpy(np.pad(gt, ((0, 0), (0, 11), (0, 0)))),
             "gt_labels": torch.zeros((2, 16), dtype=torch.int64),
             "gt_valid": torch.from_numpy(np.arange(16) < 5).expand(2, 16).clone(),
             "img_shape": torch.tensor([[64.0, 96.0]] * 2)}
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    log = step(batch, torch.Generator().manual_seed(0))
    assert seen == [BF16]
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in log.values())
    assert float(log["loss_cont"]) > 0
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd, bwd)
    for name, p in det.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), before[name]) != p.requires_grad, name


# --------------------------------------------------------------- serving ----

@pytest.fixture(scope="module")
def serving():
    _, model = _flagship_model_cfg(tiny=True)
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    batch = slice_case._batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=1, dtype=jnp.bfloat16)
    variables = slice_case._randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, jbatch))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jdet.apply(v, b, method=slice_case._jax_pieces))(variables, jbatch))
    handle = init_detector({"model": model}, device="cpu", dtype=BF16)
    handle.model.load_state_dict(
        jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    return want, slice_case._port_pieces(handle.model, tbatch), handle, tbatch


def test_serving_head_outputs_match_jax(serving):
    want, got, _, _ = serving
    np.testing.assert_array_equal(got["prop_valid"].numpy(), want["prop_valid"])
    np.testing.assert_allclose(got["proposals"].numpy(), want["proposals"], rtol=0, atol=1e-3)
    assert got["roi_feats"].dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got["roi_feats"]), want["roi_feats"],
                               **slice_case.FEAT_TOL)
    for key in ("cls_score", "bbox_pred"):
        assert got[key].dtype == BF16 and want[key].dtype == jnp.bfloat16
        assert_bf16_close(_np(got[key]), want[key].astype(np.float32))


def test_serving_dets_match_jax(serving):
    want, got, handle, tbatch = serving
    dets, labels, valid = handle.test(tbatch)
    for d, lab, v in ((got["dets"], got["labels"], got["det_valid"]), (dets, labels, valid)):
        assert d.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want["det_valid"])
        np.testing.assert_array_equal(lab.numpy(), want["labels"])
        np.testing.assert_allclose(d.numpy(), want["dets"], rtol=0, atol=1e-3)
    assert 5 <= int(valid.sum()) and len(np.unique(want["labels"])) > 1
