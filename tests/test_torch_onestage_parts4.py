"""Parts of RepPoints, CenterNet, CornerNet and CentripetalNet against the
JAX package, on the CPU, on seeded numpy inputs:

- ``corner_pool`` in its four directions: the values exactly; the
  gradients on an untied input equal JAX's, and on a tied one they follow
  mmcv's rule (all of a tie to the latest index of the running maximum)
  where JAX splits it (the documented difference, ROADMAP C);
- both ``gaussian_radius`` functions within rtol 2e-5 of jitted JAX's,
  ``gen_gaussian_target`` and CenterNet's and CornerNet's targets (the
  jitted JAX heads' ``_targets_single`` vmapped, ``_corner_targets``)
  within two float32 ulp at 1 of JAX's and exactly 1 and 0 where JAX's
  are (XLA's CPU ``exp`` and ``sqrt`` round otherwise than torch's);
  ``class_planes`` bit for bit against JAX's two max-composites;
- RepPoints' ``points2bbox`` (moment and minmax) with the gradients of the
  points and of ``moment_transfer`` (0.01 of it reaches the parameter);
  its init assignment exactly, read from JAX's ``loss`` through a stand-in
  for the module's ``jnp`` that records its ``take_along_axis`` indices
  and ``sum`` operands, with two gts on one point (the later one wins);
- ``GaussianFocalLoss`` and ``AssociativeEmbeddingLoss`` with gradients
  (rtol 1e-5);
- the narrowed Hourglass (``tests/test_p2_backbones_necks.py:66-74``'s
  shape) against jitted JAX in train mode (``mutable=['batch_stats']``):
  the outputs, the moved running statistics and every parameter's
  gradient within 1e-4 of each tensor's largest;
- the reference-side facts: JAX's CornerNet targets hold a cell at exactly
  1 only for a corner on the stride-4 grid, and its corner radius is not
  mmdet's (CenterNet's) for the same box.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_onestage_cases as cases
from oadg_tpu.models.backbones.hourglass import HourglassNet as JHourglassNet
from oadg_tpu.models.dense_heads import reppoints_head as jax_rp
from oadg_tpu.models.dense_heads.centernet_head import CenterNetHead as JCenterNetHead
from oadg_tpu.models.dense_heads.corner_heads import CornerHead as JCornerHead
from oadg_tpu.models.dense_heads.corner_heads import gaussian_radius as jax_corner_radius
from oadg_tpu.models.losses.common import GaussianFocalLoss as JGaussianFocalLoss
from oadg_tpu.models.losses.extra import AssociativeEmbeddingLoss as JAELoss
from oadg_tpu.models.utils import misc as jax_misc
from oadg_tpu.ops.misc_ops import corner_pool as jax_corner_pool
from oadg_tpu_torch.models.backbones.hourglass import HourglassNet
from oadg_tpu_torch.models.dense_heads.centernet_head import CenterNetHead
from oadg_tpu_torch.models.dense_heads.corner_heads import CornerHead
from oadg_tpu_torch.models.dense_heads.corner_heads import gaussian_radius as corner_radius
from oadg_tpu_torch.models.dense_heads.fcos_head import level_points
from oadg_tpu_torch.models.dense_heads.reppoints_head import RepPointsHead
from oadg_tpu_torch.models.losses import AssociativeEmbeddingLoss, GaussianFocalLoss
from oadg_tpu_torch.models.utils import misc
from oadg_tpu_torch.ops.misc_ops import corner_pool
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)
T = torch.from_numpy
DIRECTIONS = ("top", "bottom", "left", "right")
# gts in pixels of a 64x96 image; the first's top-left corner on the
# stride-4 grid (8, 8), the others off it; the last of image 1 padding
CORNER_GTS = np.array([[[8, 8, 40, 30], [5.5, 10.25, 30, 50], [13, 2, 60, 27.5]],
                       [[20.5, 6, 92, 60], [3, 3.75, 20.2, 41], [0, 0, 0, 0]]], np.float32)
CORNER_VALID = CORNER_GTS[..., 2] > 0
CORNER_LABELS = np.array([[1, 1, 4], [0, 7, 0]], np.int32)


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_corner_pool_matches_jax(direction):
    """Values exactly; on untied values the gradient of a weighted sum is
    JAX's."""
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (2, 5, 7, 3)).astype(np.float32)             # NHWC, untied
    coef = rng.normal(0, 1, x.shape).astype(np.float32)
    want = _np(jax.jit(lambda a: jax_corner_pool(a, direction))(x))
    jg = _np(jax.jit(jax.grad(lambda a: jnp.sum(jax_corner_pool(a, direction) * coef)))(x))
    xt = T(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = corner_pool(xt, direction)
    np.testing.assert_array_equal(got.detach().numpy().transpose(0, 2, 3, 1), want)
    (got * T(coef.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), jg, rtol=1e-6, atol=1e-6)


def test_corner_pool_tie_gradient_is_mmcvs():
    """On ``[1, 3, 3, 2, 3]`` (``right``: a running max along the row) the
    port sends all of a tie to the latest index of the running maximum
    (torch's and mmcv's cummax), JAX splits it: the values agree."""
    row = np.array([1, 3, 3, 2, 3], np.float32).reshape(1, 1, 5, 1)     # NHWC
    want = _np(jax.jit(jax.grad(lambda a: jnp.sum(jax_corner_pool(a, "right"))))(row))
    np.testing.assert_allclose(want.reshape(-1), [1, 2.25, 1.25, 0, 0.5])
    xt = T(row.reshape(1, 1, 1, 5).copy()).requires_grad_(True)
    out = corner_pool(xt, "right")
    np.testing.assert_array_equal(out.detach().numpy().reshape(-1),
                                  _np(jax_corner_pool(row, "right")).reshape(-1))
    out.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy().reshape(-1), [1, 1, 2, 0, 1])
    # both give the sum of the gradient to the maxima: only its split differs
    assert xt.grad.sum() == want.sum() == 5


def test_gaussian_radii_and_target_match_jax():
    """Both radii within rtol 2e-5 of jitted JAX's (XLA forms each ``b^2 -
    4ac`` as one fused multiply-add, the port as two roundings, and the third
    case's ``b + sqrt(b^2 - 4ac)`` cancels: ~1e-5 at overlap 0.7);
    ``gen_gaussian_target`` within ``TARGET_ATOL`` and exactly 1 and 0 where
    JAX's is."""
    rng = np.random.RandomState(3)
    h = rng.uniform(0.5, 300, 4000).astype(np.float32)
    w = rng.uniform(0.5, 300, 4000).astype(np.float32)
    for mo in (0.3, 0.7):
        want = _np(jax.jit(lambda a, b: jax_misc.gaussian_radius((a, b), mo))(h, w))
        np.testing.assert_allclose(misc.gaussian_radius((T(h), T(w)), mo).numpy(), want,
                                   rtol=2e-5, atol=0)
    want = _np(jax.jit(lambda a, b: jax_corner_radius(a, b))(h, w))
    np.testing.assert_allclose(corner_radius(T(h), T(w)).numpy(), want, rtol=2e-5, atol=1e-5)
    for i in range(40):
        cx, cy = np.floor(rng.uniform(-4, 50, 2)).astype(np.float32)
        _check_gen_gaussian_target(rng, cx, cy, np.float32(rng.uniform(0, 12)), str(i))


# a target cell of the port within two float32 ulp at 1 of JAX's: XLA's CPU
# ``exp`` and ``sqrt`` round otherwise than torch's by an ulp or a few
TARGET_ATOL = 2.4e-7


def _assert_targets_match(got, want, zeros=True, msg=""):
    """Within ``TARGET_ATOL``; exactly 1 where JAX's is 1 (a
    ``GaussianFocalLoss`` positive) and, with ``zeros``, exactly 0 where
    JAX's is (CenterNet's eps cut-off; the corner targets have none, and
    XLA flushes their far tails' denormals to 0)."""
    np.testing.assert_array_equal(got == 1, want == 1, err_msg=msg)
    if zeros:
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=msg)
    np.testing.assert_allclose(got, want, rtol=0, atol=TARGET_ATOL, err_msg=msg)


def _check_gen_gaussian_target(rng, cx, cy, r, msg):
    hm = rng.uniform(0, 0.3, (32, 48)).astype(np.float32)
    hm[rng.uniform(size=hm.shape) < 0.5] = 0
    want = _np(jax.jit(lambda m, x, y, s: jax_misc.gen_gaussian_target(m, (x, y), s))(
        hm, cx, cy, r))
    got = misc.gen_gaussian_target(T(hm), (torch.tensor(cx), torch.tensor(cy)), torch.tensor(r))
    _assert_targets_match(got.numpy(), want, msg=msg)


@pytest.mark.parametrize("cx,cy,r", [(-3.0, 40.0, 6.5), (20.0, 10.0, 0.2)],
                         ids=["centre-off-the-map", "radius-below-one"])
def test_gen_gaussian_target_edge_cases_match_jax(cx, cy, r):
    """A centre off the map (no cell at 1) and a radius below 1 (sigma
    under 0.5: the neighbour cells near the eps cut-off)."""
    _check_gen_gaussian_target(np.random.RandomState(5), np.float32(cx), np.float32(cy),
                               np.float32(r), f"{cx} {cy} {r}")


@pytest.mark.parametrize("kind", ["centernet", "cornernet"])
def test_class_planes_compose_as_jax(kind):
    """The port's ``amax`` scatter of per-gt maps into their class planes
    equals, bit for bit on the same maps, JAX's composites: CenterNet's
    ``fori_loop`` of ``maximum(hm, g * one_hot)`` and CornerNet's (H, W, G,
    C) product max; a masked gt's map is 0."""
    rng = np.random.RandomState(6)
    g = rng.uniform(0, 1, (2, 5, 6, 7)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.3] = 0
    g[0, 4] = 0                                                        # a masked gt
    labels = np.array([[1, 3, 1, 0, 3], [2, 2, 7, 7, 7]], np.int32)
    onehot = jax.nn.one_hot(labels, 8)                                 # (N, G, C)
    if kind == "centernet":
        def compose(gi, oi):
            return jax.lax.fori_loop(0, 5, lambda i, hm: jnp.maximum(
                hm, gi[i][..., None] * oi[i][None, None]), jnp.zeros((6, 7, 8)))
    else:
        def compose(gi, oi):
            return jnp.max(gi.transpose(1, 2, 0)[..., None] * oi[None, None], axis=2)
    want = _np(jax.jit(jax.vmap(compose))(g, onehot))
    got = misc.class_planes(T(g), T(labels), 8).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_centernet_targets_match_jax():
    b = cases.batch(seed=7, g=5)
    fh, fw = 8, 12                                                     # stride 8 on 64x96
    jhead = JCenterNetHead(num_classes=8, stride=8)
    want = jax.jit(jax.vmap(lambda g, v, l: jhead.apply(
        {}, g, v, l, fh, fw, method=lambda m, *a: m._targets_single(*a))))(
            b["gt_bboxes"], b["gt_valid"], b["gt_labels"])
    head = CenterNetHead(num_classes=8, in_channels=8, feat_channels=8, stride=8)
    hm, ix, iy, size, off = head.targets(T(b["gt_bboxes"]), T(b["gt_valid"]),
                                         T(b["gt_labels"]), fh, fw)
    jhm, jix, jiy, jbw, jbh, jox, jo_y = (_np(t) for t in want)
    _assert_targets_match(hm.permute(0, 2, 3, 1).numpy(), jhm)
    np.testing.assert_array_equal(ix.numpy(), jix)
    np.testing.assert_array_equal(iy.numpy(), jiy)
    np.testing.assert_array_equal(size.numpy(), np.stack([jbw, jbh], -1))
    np.testing.assert_array_equal(off.numpy(), np.stack([jox, jo_y], -1))
    assert (jhm == 1).sum() == b["gt_valid"].sum() and (jhm > 0).mean() > 0.05


def _jax_corner_targets(gt, valid, labels, h, w):
    jhead = JCornerHead(num_classes=8, in_channels=8)
    return jax.jit(jax.vmap(lambda g, v, l: jhead.apply(
        {}, g, v, l, (h, w), 4.0, method=lambda m, *a: m._corner_targets(*a))))(
            gt, valid, labels)


def test_cornernet_targets_match_jax():
    """Both heatmaps within ``TARGET_ATOL`` and exactly 1 where JAX's are,
    the corners bit for bit; JAX's (H, W, G, C) product never formed."""
    tl, br, corners = (_np(t) if not isinstance(t, tuple) else tuple(map(_np, t))
                       for t in _jax_corner_targets(CORNER_GTS, CORNER_VALID, CORNER_LABELS,
                                                    16, 24))
    head = CornerHead(num_classes=8, in_channels=8)
    got_tl, got_br, got_c = head.corner_targets(T(CORNER_GTS), T(CORNER_VALID),
                                                T(CORNER_LABELS), 16, 24)
    _assert_targets_match(got_tl.permute(0, 2, 3, 1).numpy(), tl, zeros=False)
    _assert_targets_match(got_br.permute(0, 2, 3, 1).numpy(), br, zeros=False)
    for g, c in zip(got_c, corners):
        np.testing.assert_array_equal(g.numpy(), c)


def test_jax_cornernet_positives_only_on_the_grid():
    """The reference-side fact: a heatmap cell is exactly 1 (a
    ``GaussianFocalLoss`` positive) only where a corner falls on the
    stride-4 grid: of the 5 gts one top-left corner ((8, 8)) and one
    bottom-right corner ((92, 60)) are on it, so one positive cell in each
    heatmap; the port counts the same."""
    tl, br, _ = _jax_corner_targets(CORNER_GTS, CORNER_VALID, CORNER_LABELS, 16, 24)
    q = CORNER_GTS / 4
    on_tl = (q[..., 0] == np.floor(q[..., 0])) & (q[..., 1] == np.floor(q[..., 1])) & CORNER_VALID
    on_br = (q[..., 2] == np.floor(q[..., 2])) & (q[..., 3] == np.floor(q[..., 3])) & CORNER_VALID
    assert (_np(tl) == 1).sum() == on_tl.sum() == 1
    assert (_np(br) == 1).sum() == on_br.sum() == 1
    head = CornerHead(num_classes=8, in_channels=8)
    got_tl, got_br, _ = head.corner_targets(T(CORNER_GTS), T(CORNER_VALID), T(CORNER_LABELS),
                                            16, 24)
    assert (got_tl == 1).sum() == 1 and (got_br == 1).sum() == 1


def test_the_two_radii_differ_for_one_box():
    """The reference-side fact: for a 40 x 40 box at overlap 0.3 the corner
    head's radius is 12.83 cells, mmdet's (CenterNet's) 19.82; the port
    keeps each where JAX uses it."""
    h = w = np.float32(40)
    jc = float(jax.jit(jax_corner_radius)(h, w))
    jm = float(jax.jit(lambda a, b: jax_misc.gaussian_radius((a, b), 0.3))(h, w))
    assert abs(jc - 12.8254) < 1e-3 and abs(jm - 19.8178) < 1e-3
    assert abs(float(corner_radius(torch.tensor(40.0), torch.tensor(40.0))) - jc) < 2e-5 * jc
    assert abs(float(misc.gaussian_radius((torch.tensor(40.0), torch.tensor(40.0)), 0.3))
               - jm) < 2e-5 * jm


@pytest.mark.parametrize("method", ["moment", "minmax"])
def test_points2bbox_matches_jax(method):
    rng = np.random.RandomState(4)
    pts = rng.normal(0, 2, (3, 5, 18)).astype(np.float32)
    mt = np.array([0.3, -0.2], np.float32)
    coef = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
    jhead = jax_rp.RepPointsHead(num_classes=4, in_channels=8, feat_channels=8,
                                 point_feat_channels=8, stacked_convs=1, transform_method=method)

    def f(p, m):
        box = jhead.apply({"params": {"moment_transfer": m}}, p,
                          method=lambda mod, x: mod.points2bbox(x))
        return jnp.sum(box * coef), box

    (_, jbox), (jgp, jgm) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(pts, mt)
    head = RepPointsHead(num_classes=4, in_channels=8, feat_channels=8, point_feat_channels=8,
                         stacked_convs=1, transform_method=method)
    with torch.no_grad():
        head.moment_transfer.copy_(T(mt))
    p = T(pts).requires_grad_(True)
    box = head.points2bbox(p)
    (box * T(coef)).sum().backward()
    np.testing.assert_allclose(box.detach().numpy(), _np(jbox), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), _np(jgp), rtol=1e-5, atol=1e-6)
    if method == "moment":           # the parameter takes 0.01 of the exponent's gradient
        np.testing.assert_allclose(head.moment_transfer.grad.numpy(), _np(jgm), rtol=1e-5,
                                   atol=1e-7)
        assert np.abs(_np(jgm)).max() > 0
    else:                            # minmax never reads it
        assert head.moment_transfer.grad is None and not np.abs(_np(jgm)).any()


class _Recording:
    """``jax.numpy`` that records, through ``jax.debug.callback``, the
    indices of each ``take_along_axis`` and the operand of each ``sum``
    (RepPoints' ``gi_init``, ``gi_refine``, ``pos_init``, ``pos_refine``)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def _record(self, kind, v):
        jax.debug.callback(lambda a: self.seen.append((kind, np.asarray(a))), v)

    def take_along_axis(self, a, idx, axis, **kw):
        self._record("take", idx)
        return jnp.take_along_axis(a, idx, axis, **kw)

    def sum(self, a, *args, **kw):
        self._record("sum", a)
        return jnp.sum(a, *args, **kw)


def test_reppoints_init_assignment_matches_jax(monkeypatch):
    """Gts 0 and 1 of image 0 share a centre (and a level), so they pick
    one point: the later gt wins it; a padded gt picks none."""
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    gt = np.array([[[10, 10, 30, 30], [12, 12, 28, 28], [30, 2, 62, 40], [0, 0, 0, 0]],
                   [[40, 40, 60, 64], [3, 5, 13, 29], [20, 20, 50, 42], [0, 0, 0, 0]]],
                  np.float32)
    valid = gt[..., 2] > 0
    labels = np.array([[0, 1, 2, 0], [3, 1, 0, 0]], np.int32)
    rng = np.random.RandomState(6)
    outs = tuple([rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for h, w in sizes]
                 for c in (4, 18, 18))
    seen = []
    monkeypatch.setattr(jax_rp, "jnp", _Recording(seen))
    jhead = jax_rp.RepPointsHead(num_classes=4, in_channels=8, feat_channels=8,
                                 point_feat_channels=8, stacked_convs=1)
    jax.jit(lambda o, g, v, lb: jhead.apply(
        {"params": {"moment_transfer": jnp.zeros(2)}}, o, g, v, lb,
        method=lambda m, *a: m.loss(*a)))(outs, jnp.asarray(gt), jnp.asarray(valid),
                                          jnp.asarray(labels))
    jax.effects_barrier()
    takes = [v for k, v in seen if k == "take"]
    sums = [v for k, v in seen if k == "sum"]
    want_gi, want_pos = takes[0][..., 0], sums[0]

    head = RepPointsHead(num_classes=4, in_channels=8, feat_channels=8, point_feat_channels=8,
                         stacked_convs=1)
    points, lvl = level_points(sizes, head.point_strides)
    gi, pos = head.init_targets(points, lvl, T(gt), T(valid))
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(gi.numpy(), want_gi)
    assert pos[0].sum() == 2 and pos[1].sum() == 3                   # gts 0 and 1 share a point
    assert set(gi[0][pos[0]].tolist()) == {1, 2}


def test_gaussian_focal_and_embedding_losses_match_jax():
    rng = np.random.RandomState(8)
    pred = rng.uniform(0.01, 0.99, (2, 3, 6, 5)).astype(np.float32)
    tgt = rng.uniform(0, 1, pred.shape).astype(np.float32) ** 3
    tgt[0, 1, 2, 3] = tgt[1, 0, 0, 0] = 1.0
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JGaussianFocalLoss()(p, tgt, avg_factor=3.0)))(
        pred)
    p = T(pred).requires_grad_(True)
    loss = GaussianFocalLoss()(p, T(tgt), avg_factor=3.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), _np(jg), rtol=1e-5, atol=1e-7)

    tl, br = rng.normal(0, 1, (2, 6)).astype(np.float32)
    valid = np.array([True, True, False, True, True, False])
    (jpull, jpush), (jgt, jgb) = jax.jit(lambda a, b: (
        JAELoss()(a, b, valid), jax.grad(lambda x, y: sum(JAELoss()(x, y, valid)), (0, 1))(a, b)))(
            tl, br)
    a, b = T(tl).requires_grad_(True), T(br).requires_grad_(True)
    pull, push = AssociativeEmbeddingLoss()(a, b, T(valid))
    (pull + push).backward()
    pull, push = float(pull.detach()), float(push.detach())
    np.testing.assert_allclose([pull, push], [float(jpull), float(jpush)], rtol=1e-5)
    assert push > 0 and pull > 0
    np.testing.assert_allclose(a.grad.numpy(), _np(jgt), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.grad.numpy(), _np(jgb), rtol=1e-5, atol=1e-7)


def test_hourglass_matches_jax_in_train_mode():
    cfg = dict(cases.HOURGLASS, num_stacks=2)
    x = np.random.RandomState(9).normal(0, 1, (2, 32, 48, 3)).astype(np.float32)
    jnet = JHourglassNet(**cfg)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)
    variables = {"params": cases.randomize(shapes["params"], 5),
                 "batch_stats": cases.randomize(shapes["batch_stats"], 3)}
    coef = [np.random.RandomState(10 + i).normal(0, 1, (2, 8, 12, 8)).astype(np.float32)
            for i in range(2)]

    def run(params, x):
        outs, moved = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, coef)), (outs, moved)

    (_, (jouts, moved)), jgrads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        variables["params"], x)
    net = HourglassNet(**cfg)
    sd = jax_variables_to_state_dict({k: {"backbone_m": v} for k, v in variables.items()})
    net.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    net.train()
    outs = net(T(x.transpose(0, 3, 1, 2).copy()))
    sum((o * T(c.transpose(0, 3, 1, 2).copy())).sum() for o, c in zip(outs, coef)).backward()
    assert len(outs) == 2 and outs[0].shape == (2, 8, 8, 12)
    for o, j in zip(outs, jouts):
        j = _np(j)
        np.testing.assert_allclose(o.detach().numpy().transpose(0, 2, 3, 1), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())
    want = jax_variables_to_state_dict(
        {"params": {"backbone_m": jax.tree_util.tree_map(np.asarray, jgrads)},
         "batch_stats": {"backbone_m": jax.tree_util.tree_map(np.asarray,
                                                              moved["batch_stats"])}})
    state = net.state_dict()
    grads = dict(net.named_parameters())
    assert sum(".running_" in k for k in want) == 2 * 44
    for k, w in want.items():
        k = k[len("backbone."):]
        w = w.numpy()
        got = state[k].numpy() if ".running_" in k else grads[k].grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("name", cases.FOURTH)
def test_heads_start_their_classifiers_at_zero(name):
    """The reference-side fact: the JAX heads start their classifier (and
    heatmap) biases at 0 with LeCun-normal weights, where mmdet starts them
    at a prior (0.01 for RepPoints, 0.1 for CenterNet's and the corner
    heatmaps); the port starts as JAX does (``chip_smoke.py`` moves them to
    mmdet's prior before training, ``classifier_prior``)."""
    from oadg_tpu_torch.models import build_detector
    det = build_detector(cases.tiny_model(name), device="cpu")
    det.init_weights(torch.Generator().manual_seed(0))
    head = det.bbox_head
    biases = ([head.reppoints_cls_out.bias] if name == "reppoints" else
              [head.heatmap_head[2].bias] if name == "centernet" else
              [m[1].conv.bias for m in (*head.tl_heat, *head.br_heat)])
    assert all(torch.equal(b, torch.zeros_like(b)) for b in biases)
