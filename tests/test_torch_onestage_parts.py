"""The one-stage family's parts of the port against the JAX package, on the
CPU, on seeded numpy inputs:

- ``distance2bbox`` (with and without the per-image ``max_shape`` clip) and
  ``level_points`` (offsets 0.5 and 0): bit for bit;
- ``QualityFocalLoss`` (labels of positives, background and -1),
  ``DistributionFocalLoss`` (targets up to ``reg_max - 0.01``) and
  ``VarifocalLoss`` (``iou_weighted`` on and off), with weights and an
  ``avg_factor``: values rtol 1e-6, the gradients of the predictions (and
  of QFL's scores) rtol 1e-5 with a floor of 1e-6 of the largest magnitude;
- ``ATSSAssigner``: assignments, labels and max IoUs exactly, on random
  gts and on gts centred on an anchor or between four anchors, where anchor
  distances tie exactly (the candidate set is every anchor at the k-th
  distance, in both packages); ``TaskAlignedAssigner``, its ranks and its
  top-k mask exactly, on random alignments and on rows repeated so that
  alignments tie (ranks to the lower row); the assigned alignment rtol 1e-6;
- ``gmm_em_1d``: the low-mean responsibilities within 2e-5 (ten float32 EM
  steps, summed in another order); the positives (responsibility > 0.5)
  exactly on cases whose JAX responsibilities all stay 1e-3 away from 0.5
  (asserted: near 0.5 a float32 step may flip a candidate);
- DCNv1 ``deform_conv2d`` (``tests/test_torch_longtail_c4_dcn.py``'s
  inputs: offsets of several pixels, a tap wholly outside the map, stride 2,
  dilation 2 with two deform groups): the output and the gradients of the
  input, the offsets and the weight, rtol 1e-5 with a floor of 1e-5 of the
  largest magnitude (each gradient sums many taps);
- ``ops.misc_ops.bilinear_gather`` against ``oadg_tpu/ops/deform_conv.py:30``
  (samples inside, on the edge and wholly outside the map, which read 0):
  values and the gradients of the map and the positions, same tolerance.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.core.bbox.assign_sample import ATSSAssigner as JATSS
from oadg_tpu.core.bbox.assign_sample import TaskAlignedAssigner as JTaskAligned
from oadg_tpu.core.bbox.assign_sample import _per_gt_topk_mask as jax_topk_mask
from oadg_tpu.core.bbox.assign_sample import _rank_matrix_desc as jax_rank
from oadg_tpu.core.bbox.transforms import distance2bbox as jax_distance2bbox
from oadg_tpu.models.dense_heads.fovea_fsaf_heads import _level_points as jax_level_points
from oadg_tpu.models.dense_heads.paa_head import gmm_em_1d as jax_gmm
from oadg_tpu.models.losses.common import DistributionFocalLoss as JDFL
from oadg_tpu.models.losses.common import QualityFocalLoss as JQFL
from oadg_tpu.models.losses.extra import VarifocalLoss as JVFL
from oadg_tpu.ops.deform_conv import bilinear_gather as jax_bilinear_gather
from oadg_tpu.ops.deform_conv import deform_conv2d as jax_dcn
from oadg_tpu_torch.core.anchor import AnchorGenerator
from oadg_tpu_torch.core.bbox.assign_sample import (ATSSAssigner, TaskAlignedAssigner,
                                                    _per_gt_topk_mask, _rank_matrix_desc)
from oadg_tpu_torch.core.bbox.transforms import distance2bbox
from oadg_tpu_torch.models.dense_heads.fcos_head import level_points
from oadg_tpu_torch.models.dense_heads.paa_head import gmm_em_1d
from oadg_tpu_torch.models.losses import DistributionFocalLoss, QualityFocalLoss, VarifocalLoss
from oadg_tpu_torch.ops.deform_conv import deform_conv2d
from oadg_tpu_torch.ops.misc_ops import bilinear_gather
from test_torch_longtail_c4_dcn import DCN_CASES, _close, _dcn_inputs, _nchw

torch.set_num_threads(2)
T = torch.from_numpy


# ------------------------------------------------------ points and boxes ----

@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_level_points_equal_jax(offset):
    sizes, strides = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], [8, 16, 32, 64, 128]
    jp, jl = jax_level_points(sizes, strides, offset)
    p, lvl = level_points(sizes, strides, offset=offset)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(jl))


def test_distance2bbox_equals_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 90, (2, 50, 2)).astype(np.float32)
    dist = rng.uniform(-5, 60, (2, 50, 4)).astype(np.float32)
    shapes = np.array([[64, 96], [48, 80]], np.float32)
    np.testing.assert_array_equal(distance2bbox(T(pts), T(dist)).numpy(),
                                  np.asarray(jax_distance2bbox(pts, dist)))
    got = distance2bbox(T(pts), T(dist), max_shape=(T(shapes[:, 0:1]), T(shapes[:, 1:2])))
    for i in range(2):
        want = jax_distance2bbox(pts[i], dist[i], max_shape=(shapes[i, 0], shapes[i, 1]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert float(got[..., 0].min()) == 0 and float(got[1, :, 2].max()) == 80


# ----------------------------------------------------------------- losses ----

def _loss_case(kind):
    rng = np.random.RandomState(3)
    n, c = 40, 6
    if kind == "dfl":
        pred = rng.normal(0, 1.5, (n, 17)).astype(np.float32)
        target = np.concatenate([rng.uniform(0, 15.99, n - 3), [0.0, 7.0, 15.99]]).astype(
            np.float32)
    else:
        pred = rng.normal(0, 2, (n, c)).astype(np.float32)
        labels = rng.randint(0, c, n).astype(np.int32)
        labels[::3] = c                                      # background
        labels[1] = -1
        scores = rng.uniform(0, 1, n).astype(np.float32)
        target = (labels, scores)
        if kind == "vfl":
            onehot = np.eye(c + 1, dtype=np.float32)[np.clip(labels, 0, c)][:, :c]
            target = onehot * scores[:, None]
    weight = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return pred, target, weight


LOSSES = {"qfl": (JQFL, QualityFocalLoss, dict(beta=2.0, loss_weight=1.0)),
          "dfl": (JDFL, DistributionFocalLoss, dict(loss_weight=0.25)),
          "vfl": (JVFL, VarifocalLoss, dict(alpha=0.75, gamma=2.0, iou_weighted=True)),
          "vfl-plain": (JVFL, VarifocalLoss, dict(alpha=0.75, gamma=2.0, iou_weighted=False))}


@pytest.mark.parametrize("kind", list(LOSSES))
def test_onestage_losses_and_gradients_match_jax(kind):
    jcls, pcls, kw = LOSSES[kind]
    pred, target, weight = _loss_case(kind.split("-")[0])
    jl, pl = jcls(**kw), pcls(**kw)
    qfl = kind == "qfl"

    def jfun(p, s):
        t = (jnp.asarray(target[0]), s) if qfl else jnp.asarray(target)
        return jl(p, t, jnp.asarray(weight), avg_factor=7.0)

    want, (gp, gs) = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1)))(
        jnp.asarray(pred), jnp.asarray(target[1] if qfl else 0.0))
    tp = T(pred).requires_grad_(True)
    ts = T(target[1]).requires_grad_(True) if qfl else None
    got = pl(tp, (T(target[0]), ts) if qfl else T(target), T(weight), avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    _close(tp.grad.numpy(), gp, floor=1e-6)
    if qfl:
        _close(ts.grad.numpy(), gs, floor=1e-6)


# -------------------------------------------------------------- assigners ----

def _atss_anchors(sizes):
    gen = AnchorGenerator(strides=[8, 16, 32], ratios=[1.0], octave_base_scale=8,
                          scales_per_octave=1)
    per = gen.grid_priors(sizes)
    return torch.cat(per), [len(a) for a in per]


ATSS_CASES = {
    "random": None,
    # centred on an anchor of every level (a multiple of 32), and between
    # four anchors of the finest level: anchor distances tie exactly
    "ties": np.array([[[48.0, 32.0, 80.0, 96.0], [20.0, 4.0, 52.0, 28.0],
                       [0.0, 0.0, 64.0, 64.0], [0, 0, 0, 0]],
                      [[60.0, 44.0, 76.0, 60.0], [4.0, 12.0, 92.0, 52.0],
                       [30.0, 30.0, 34.0, 34.0], [0, 0, 0, 0]]], np.float32),
}


@pytest.mark.parametrize("case", list(ATSS_CASES))
def test_atss_assigner_matches_jax_exactly(case):
    sizes = [(12, 16), (6, 8), (3, 4)]
    anchors, num_level = _atss_anchors(sizes)
    rng = np.random.RandomState(5)
    gt = ATSS_CASES[case]
    if gt is None:
        xy = rng.uniform(0, 90, (2, 4, 2))
        gt = np.concatenate([xy, xy + rng.uniform(6, 50, (2, 4, 2))], -1).astype(np.float32)
    valid = np.array([[True, True, True, False], [True, True, True, False]])
    labels = rng.randint(0, 8, (2, 4)).astype(np.int32)
    got = ATSSAssigner(topk=9).assign(anchors, num_level, T(gt), T(valid), T(labels))
    jfun = jax.jit(lambda a, g, v, l: JATSS(topk=9).assign(a, num_level, g, v, gt_labels=l))
    for i in range(2):
        want = jfun(jnp.asarray(anchors.numpy()), gt[i], valid[i], labels[i])
        np.testing.assert_array_equal(got.gt_inds[i].numpy(), np.asarray(want.gt_inds))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(got.max_overlaps[i].numpy(), np.asarray(want.max_overlaps))
        assert (got.gt_inds[i] > 0).sum() >= 3
    if case == "ties":
        # gt 0 of image 1 is centred between four anchors of the finest level
        # (anchor centres sit on multiples of the stride): four at one distance
        acx = (anchors[:, 0] + anchors[:, 2]) / 2
        acy = (anchors[:, 1] + anchors[:, 3]) / 2
        d = torch.sqrt((acx - 68.0) ** 2 + (acy - 52.0) ** 2)[:num_level[0]]
        assert int((d == d.min()).sum()) == 4


def _aligned_case(ties):
    rng = np.random.RandomState(6)
    n, g, c = 60, 5, 4
    anchors = np.stack(np.meshgrid(np.arange(10) * 8.0, np.arange(6) * 8.0), -1).reshape(-1, 2)
    anchors = np.concatenate([anchors - 4, anchors + 4], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1, (n, c)).astype(np.float32)
    xy = anchors[:, :2] + rng.uniform(-6, 6, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (n, 2))], -1).astype(np.float32)
    if ties:                       # rows 10-19 repeat rows 0-9 (after clipping inside)
        scores[10:20], boxes[10:20] = scores[:10], boxes[:10]
    xy = rng.uniform(0, 50, (g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 40, (g, 2))], -1).astype(np.float32)
    valid = np.array([True, True, True, True, False])
    labels = rng.randint(0, c, g).astype(np.int32)
    return scores, boxes, anchors, gt, valid, labels


@pytest.mark.parametrize("ties", [False, True])
def test_task_aligned_assigner_matches_jax_exactly(ties):
    scores, boxes, anchors, gt, valid, labels = _aligned_case(ties)
    kw = dict(topk=13, alpha=1.0, beta=6.0)
    want, wmet = jax.jit(JTaskAligned(**kw).assign)(*map(jnp.asarray, (scores, boxes, anchors,
                                                                      gt, valid, labels)))
    got, met = TaskAlignedAssigner(**kw).assign(*map(T, (scores, boxes, anchors, gt, valid,
                                                         labels)))
    np.testing.assert_array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(), np.asarray(want.max_overlaps),
                               rtol=1e-6)
    np.testing.assert_allclose(met.numpy(), np.asarray(wmet), rtol=1e-6, atol=1e-30)
    assert (got.gt_inds > 0).sum() >= 4


@pytest.mark.parametrize("ties", [False, True])
def test_rank_and_topk_mask_match_jax(ties):
    rng = np.random.RandomState(7)
    v = rng.uniform(0, 1, (30, 4)).astype(np.float32)
    if ties:
        v[10:20] = v[:10]
        v[:, 3] = 0.5                                   # one column all equal
    valid = np.array([True, True, False, True])
    np.testing.assert_array_equal(_rank_matrix_desc(T(v)).numpy(), np.asarray(jax_rank(v)))
    for k in (1, 5, 13, 40):
        np.testing.assert_array_equal(_per_gt_topk_mask(T(v), k, T(valid)).numpy(),
                                      np.asarray(jax_topk_mask(jnp.asarray(v), k, valid)))


# -------------------------------------------------------------------- GMM ----

def test_gmm_em_1d_matches_jax():
    rng = np.random.RandomState(8)
    g, k = 12, 40
    low = rng.normal(0.4, 0.1, (g, k))
    high = rng.normal(1.6, 0.3, (g, k))
    x = np.where(rng.uniform(0, 1, (g, k)) < 0.4, low, high).astype(np.float32)
    valid = rng.uniform(0, 1, (g, k)) < 0.6
    valid[0] = False                                    # a gt with no candidates
    valid[1, 1:] = False                                # one candidate
    x = np.where(valid, x, 1e8).astype(np.float32)
    want = np.asarray(jax.jit(jax_gmm)(jnp.asarray(x), jnp.asarray(valid)))
    got = gmm_em_1d(T(x), T(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.all(got[~valid] == 0) and np.all(got[1, 0] == want[1, 0])
    away = np.abs(want - 0.5) > 1e-3
    assert away[2:].all()
    np.testing.assert_array_equal(got[away] > 0.5, want[away] > 0.5)
    assert 0 < (want > 0.5).sum() < valid.sum()


# ------------------------------------------------------------------ DCNv1 ----

@pytest.mark.parametrize("case", list(DCN_CASES))
def test_deform_conv_and_gradients_match_jax(case):
    c, x, off, _, wt, bias = _dcn_inputs(case)
    kw = dict(stride=c["stride"], padding=c["padding"], dilation=c["dilation"],
              deform_groups=c["dg"])
    shape = jax.eval_shape(lambda *a: jax_dcn(*a, bias=jnp.asarray(bias), **kw), x, off, wt).shape
    dy = np.random.RandomState(1).normal(0, 1, shape).astype(np.float32)

    def jfun(x, off, wt):
        y = jax_dcn(x, off, wt, bias=jnp.asarray(bias), **kw)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, want_y), grads = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (x, off, wt)))
    tx, toff = (_nchw(a).requires_grad_(True) for a in (x, off))
    tw = T(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))).requires_grad_(True)
    y = deform_conv2d(tx, toff, tw, bias=T(bias), **kw)
    (y * _nchw(dy)).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), want_y, floor=1e-6)
    for name, got, want in (("x", tx.grad.permute(0, 2, 3, 1), grads[0]),
                            ("offset", toff.grad.permute(0, 2, 3, 1), grads[1]),
                            ("weight", tw.grad.permute(2, 3, 1, 0), grads[2])):
        _close(got.numpy(), want, msg=name)
    # tap 0 of pixel (0, 0) reads nothing: its offsets get no gradient
    assert float(toff.grad[0, 0, 0, 0]) == 0.0 == float(toff.grad[0, 1, 0, 0])


# ------------------------------------------------------- bilinear gather ----

def test_bilinear_gather_matches_jax():
    rng = np.random.RandomState(9)
    b, h, w, c = 2, 7, 9, 3
    feats = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    ys = rng.uniform(-2, h + 1, (b, 5, 6)).astype(np.float32)
    xs = rng.uniform(-2, w + 1, (b, 5, 6)).astype(np.float32)
    ys[0, 0, :3] = [0.0, h - 1.0, -1.5]                 # on the edges, wholly outside
    xs[0, 0, :3] = [w - 1.0, 0.0, 3.0]
    dy = rng.normal(0, 1, (b, 5, 6, c)).astype(np.float32)

    def jfun(f, y, x):
        out = jax_bilinear_gather(f, y, x)
        return jnp.sum(out * dy), out

    (_, want), grads = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (feats, ys, xs)))
    tf, ty, tx = (T(a).requires_grad_(True) for a in (feats, ys, xs))
    got = bilinear_gather(tf, ty, tx)
    (got * T(dy)).sum().backward()
    _close(got.detach().numpy(), want, floor=1e-6)
    assert float(got[0, 0, 2].abs().max()) == 0.0
    for name, g, wgt in (("feats", tf.grad, grads[0]), ("ys", ty.grad, grads[1]),
                         ("xs", tx.grad, grads[2])):
        _close(g.numpy(), wgt, msg=name)


# --------------------------------------------- differences from mmdet kept ----

def _tiny_fcos_outs(seed=12):
    rng = np.random.RandomState(seed)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    cls = [rng.normal(0, 1, (2, h, w, 8)).astype(np.float32) for h, w in sizes]
    reg = [np.exp(rng.normal(2, 0.5, (2, h, w, 4))).astype(np.float32) for h, w in sizes]
    ctr = [rng.normal(0, 1, (2, h, w, 1)).astype(np.float32) for h, w in sizes]
    gt = np.array([[[4, 6, 40, 50], [30, 10, 90, 60]], [[8, 4, 30, 40], [0, 0, 0, 0]]],
                  np.float32)
    return (cls, reg, ctr), gt, np.array([[True, True], [True, False]]), \
        np.array([[1, 2], [3, 0]], np.int32)


def test_fcos_classifier_bias_and_ignored_options_as_in_jax():
    """Recorded in ROADMAP C: the JAX FCOS head starts ``conv_cls``'s bias at
    0 (flax's default; mmdet at the 0.01 prior) and the port's seeded init
    keeps it (PAA's, a RetinaHead's, starts at the prior in both); and the
    JAX head takes ``center_sampling`` and ``norm_on_bbox`` and reads
    neither (the loss is the same with them on), which the port keeps."""
    from oadg_tpu.models.dense_heads.fcos_head import FCOSHead as JFCOSHead
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.models.dense_heads import FCOSHead
    import torch_onestage_cases as cases
    kw = dict(num_classes=8, in_channels=16, feat_channels=16, stacked_convs=0)

    def jax_run(*a):
        v = JFCOSHead(**kw).init(jax.random.PRNGKey(0), [jnp.zeros((1, 2, 2, 16))])
        return v["params"]["conv_cls"]["Conv_0"]["bias"], [
            JFCOSHead(**kw, center_sampling=cs, norm_on_bbox=cs).apply(
                {"params": v["params"]}, *a, method=JFCOSHead.loss) for cs in (False, True)]

    outs, gt, valid, labels = _tiny_fcos_outs()
    jbias, jl = jax.jit(jax_run)(outs, gt, valid, labels)
    assert np.all(np.asarray(jbias) == 0)
    fcos = init_detector({"model": cases.tiny_model("fcos")}, device="cpu", seed=3).model
    assert torch.all(fcos.bbox_head.conv_cls.bias == 0)
    paa = init_detector({"model": cases.tiny_model("paa")}, device="cpu", seed=3).model
    assert torch.allclose(paa.bbox_head.retina_cls.bias,
                          torch.full((8,), -float(np.log(99.0))))
    tl = [FCOSHead(**kw, center_sampling=cs, norm_on_bbox=cs).loss(
        [[T(np.ascontiguousarray(x.transpose(0, 3, 1, 2))) for x in o] for o in outs],
        T(gt), T(valid), T(labels)) for cs in (False, True)]
    for k in ("loss_cls", "loss_bbox", "loss_centerness"):
        assert float(jl[0][k]) == float(jl[1][k]) and float(tl[0][k]) == float(tl[1][k])
        np.testing.assert_allclose(float(tl[0][k]), float(jl[0][k]), rtol=1e-5)
