"""Grid R-CNN, PointRend and TridentNet's backbone in the port against the
JAX package, on the CPU.

The modules: ``GroupNorm32`` (flax's ``GroupNorm``, epsilon 1e-6, its
variance ``E[x^2] - E[x]^2``; the port's ``F.group_norm`` within 1e-4 of the
largest magnitude), ``GridHead``, the grid targets (thresholded: exact),
``point_sample`` and the per-image ``bilinear_gather``, ``MaskPointHead``,
each with JAX's weights. The RoI heads of ``configs/grid_rcnn`` and
``configs/point_rend`` made tiny (``torch_twostage_cases.tiny_roi``; the
grid head 2 convs of 48 channels, GN lowered to 24 groups; PointRend's mask
RoI layer at 14x14, which its config lacks): losses and gradients on the
cases' seeded maps with the JAX sampler's draws, PointRend's points drawn
from JAX's fixed key. Then each detector made tiny (R18-FPN of 16
channels) through ``forward_train`` and ``simple_test``, and
``TridentResNet`` in both modes.

The reference-side faults (ROADMAP C): JAX's ``TridentFasterRCNN`` raises in
both modes and the port refuses it; JAX's PointRend folds the batch into y
for its fine features (a point near an image's top edge reads the image
before it; the port samples each image alone, so the parity cases keep
their boxes 4 px inside the images) and draws its points from a fixed key;
Grid R-CNN serves boxes from an ``fc_reg`` that no loss trains.

Tolerances: float32 outputs and gradients within 1e-4 of the largest
magnitude, losses within 1e-5 relative (``acc`` 1e-6), scores within 1e-5;
the sampled assignments and the grid targets exact.
"""
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_twostage_cases as cases
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict, load_mmdet_checkpoint
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(17)
C, NC = cases.C, cases.NUM_CLASSES
GRID_WIDTH = 48                 # GN(36) lowered to 24 groups of 2 channels
cases.CONFIGS.update(grid="configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py",
                     point_rend="configs/point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py")


def _tiny(name, package, detector=False):
    m = cases.load_model(name, package)
    (cases.tiny_model if detector else cases.tiny_roi)(m)
    rh = m["roi_head"]
    if name == "grid":
        rh["grid_head"].update(in_channels=C, conv_out_channels=GRID_WIDTH, num_convs=2)
    else:
        rh["mask_roi_extractor"] = dict(cases.MASK_ROI_14)
        rh["point_head"].update(in_channels=C, fc_channels=16, num_classes=NC)
    return m


def _close(got, want, rel=1e-4, err_msg=""):
    cases.close_grads(got, want, rel=rel, err_msg=err_msg)


def _point_draws(r, npts=196, over=3.0, imp=0.75):
    """The uniforms JAX's PointRend draws from its fixed ``PRNGKey(0)``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    nover, k_imp = int(npts * over), int(npts * imp)
    return {"rcnn.point.cand": torch.from_numpy(np.asarray(
                jax.random.uniform(k1, (r, nover, 2)))),
            "rcnn.point.rand": torch.from_numpy(np.asarray(
                jax.random.uniform(k2, (r, npts - k_imp, 2))))}


def _inside(case, margin=4.0):
    """``case`` with every box mapped into [margin, 64 - margin], so that no
    point of PointRend's lies within half a pixel of level 0's edges."""
    out = dict(case)
    s = (cases.H - 2 * margin) / cases.H
    for k in ("gt", "props"):
        out[k] = (margin + case[k] * s).astype(np.float32)
    out["gt"][1, -1] = 0
    return out


# ------------------------------------------------------------- the modules ----

@pytest.mark.parametrize("channels,groups", [(576, 36), (GRID_WIDTH, 36), (30, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm32_matches_flax(channels, groups, dtype):
    from oadg_tpu.models.layers import GroupNorm32 as JaxGN
    from oadg_tpu_torch.models.layers import GroupNorm32
    rng = np.random.RandomState(channels)
    x = (rng.normal(0.5, 2, (2, 5, 6, channels))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    m = JaxGN(num_groups=groups)
    params = {"GroupNorm_0": {"scale": jnp.asarray(rng.normal(1, 0.2, channels), jnp.float32),
                              "bias": jnp.asarray(rng.normal(0, 0.2, channels), jnp.float32)}}
    want = m.apply({"params": params}, jx)
    gn = GroupNorm32(channels, groups)
    gn.load_state_dict({k: torch.tensor(np.asarray(params["GroupNorm_0"][j]))
                        for k, j in (("weight", "scale"), ("bias", "bias"))})
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = gn(tx.permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert gn.num_groups == {576: 36, GRID_WIDTH: 24, 30: 30}[channels]
    _close(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want))


def test_grid_head_matches_jax():
    from oadg_tpu.models.roi_heads.more_roi_heads import GridHead as JaxGridHead
    from oadg_tpu_torch.models.roi_heads.more_roi_heads import GridHead
    x = np.random.RandomState(1).normal(0, 1, (3, 14, 14, C)).astype(np.float32)
    jhead = JaxGridHead(in_channels=C, conv_out_channels=GRID_WIDTH, num_convs=2)
    params = cases.randomize(jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), x))["params"])
    want = np.asarray(jax.jit(lambda p: jhead.apply({"params": p}, x))(params))
    head = GridHead(in_channels=C, conv_out_channels=GRID_WIDTH, num_convs=2)
    sd = jax_variables_to_state_dict({"params": {"roi": {"grid": jax.tree_util.tree_map(
        np.asarray, params)}}})
    head.load_state_dict({k[len("roi_head.grid_head."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (3, 9, 56, 56) and want.shape == (3, 56, 56, 9)
    _close(got.transpose(0, 2, 3, 1), want)


def _jax_grid_targets(pb, gb, hs):
    """``more_roi_heads.py:219-236`` as written there (jitted)."""
    gx = jnp.stack([gb[:, 0], (gb[:, 0] + gb[:, 2]) / 2, gb[:, 2]], -1)
    gy = jnp.stack([gb[:, 1], (gb[:, 1] + gb[:, 3]) / 2, gb[:, 3]], -1)
    w = jnp.maximum(pb[:, 2] - pb[:, 0], 1.0)
    h = jnp.maximum(pb[:, 3] - pb[:, 1], 1.0)
    px = (gx - pb[:, 0:1]) / w[:, None] * hs
    py = (gy - pb[:, 1:2]) / h[:, None] * hs
    ys = jnp.arange(hs, dtype=jnp.float32)
    tgt = []
    for gj in range(3):
        for gi in range(3):
            ty = jnp.exp(-0.5 * ((ys[None, :] - py[:, gj:gj + 1]) / (hs / 14.0 + 1e-6)) ** 2)
            tx = jnp.exp(-0.5 * ((ys[None, :] - px[:, gi:gi + 1]) / (hs / 14.0 + 1e-6)) ** 2)
            tgt.append(ty[:, :, None] * tx[:, None, :])
    return jnp.stack(tgt, -1)


def test_grid_targets_equal_jax():
    from oadg_tpu_torch.models.roi_heads.more_roi_heads import grid_targets
    rng = np.random.RandomState(2)
    gb = np.concatenate([rng.uniform(0, 40, (64, 2)), rng.uniform(50, 90, (64, 2))], -1)
    pb = gb + rng.uniform(-8, 8, (64, 4))
    pb[:3, 2:] = pb[:3, :2] + 0.5                          # widths floored at 1
    gb, pb = gb.astype(np.float32), pb.astype(np.float32)
    want = np.asarray(jax.jit(_jax_grid_targets, static_argnums=2)(pb, gb, 56))
    got = grid_targets(torch.from_numpy(pb), torch.from_numpy(gb), 56).numpy()
    want = want.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert 0 < (want > 0.5).mean() < 0.2


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_sample_matches_jax(align_corners):
    from oadg_tpu.ops.misc_ops import point_sample as jax_point_sample
    from oadg_tpu_torch.ops.misc_ops import point_sample
    rng = np.random.RandomState(3)
    f = rng.normal(0, 1, (2, 7, 9, 5)).astype(np.float32)
    pts = rng.uniform(-0.1, 1.1, (2, 40, 2)).astype(np.float32)    # some off the map
    want = np.asarray(jax_point_sample(jnp.asarray(f), jnp.asarray(pts), align_corners))
    got = point_sample(torch.from_numpy(f), torch.from_numpy(pts), align_corners).numpy()
    _close(got, want, 1e-6)


def test_point_rend_fine_gather_bleeds_across_images_in_jax_not_in_the_port():
    """JAX folds the batch into y (``htc_scnet_heads.py:342-346``): a point
    within half a pixel of image 1's top edge takes its floor tap from image
    0's last row. The port samples each image alone (zero outside it, as
    mmcv's ``point_sample`` on one image's map); away from the edges the two
    agree."""
    from oadg_tpu.ops.deform_conv import bilinear_gather as jax_gather
    from oadg_tpu_torch.ops.misc_ops import bilinear_gather
    rng = np.random.RandomState(4)
    f0 = rng.normal(0, 1, (2, 6, 8, 3)).astype(np.float32)
    fy = np.array([[2.3, 4.5, -0.25]], np.float32)              # the last near the top edge
    fx = np.array([[1.2, 3.7, 2.0]], np.float32)
    bidx = np.array([1], np.int32)
    want = np.asarray(jax_gather(jnp.asarray(f0.reshape(1, -1, 8, 3)),
                                 jnp.asarray(fy + bidx[:, None] * 6)[None],
                                 jnp.asarray(fx)[None]))[0]
    got = bilinear_gather(torch.from_numpy(f0), torch.from_numpy(fy), torch.from_numpy(fx),
                          image=torch.from_numpy(bidx)).numpy()
    _close(got[0, :2], want[0, :2], 1e-6)
    np.testing.assert_allclose(want[0, 2], 0.25 * f0[0, 5, 2] + 0.75 * f0[1, 0, 2], rtol=1e-6)
    np.testing.assert_allclose(got[0, 2], 0.75 * f0[1, 0, 2], rtol=1e-6)


def test_mask_point_head_matches_jax():
    from oadg_tpu.models.roi_heads.htc_scnet_heads import MaskPointHead as JaxPoint
    from oadg_tpu_torch.models.roi_heads.htc_scnet_heads import MaskPointHead
    rng = np.random.RandomState(5)
    fine = rng.normal(0, 1, (4, 30, C)).astype(np.float32)
    coarse = rng.normal(0, 2, (4, 30, NC)).astype(np.float32)
    jhead = JaxPoint(fc_channels=16, num_classes=NC)
    params = cases.randomize(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), fine, coarse))["params"])
    want = np.asarray(jhead.apply({"params": params}, fine, coarse))
    head = MaskPointHead(in_channels=C, fc_channels=16, num_classes=NC)
    sd = jax_variables_to_state_dict({"params": {"roi": {"point": jax.tree_util.tree_map(
        np.asarray, params)}}})
    sd = {k[len("roi_head.point_head."):]: v for k, v in sd.items()}
    assert sd["fcs.1.conv.weight"].shape == (16, 16 + NC, 1)          # mmdet's Conv1d
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(fine), torch.from_numpy(coarse)).numpy()
    _close(got, want)


# ------------------------------------------------------------ the RoI heads ----

KEYS = {"grid": ["loss_cls", "acc", "loss_grid"],
        "point_rend": ["loss_cls", "loss_bbox", "acc", "loss_mask"]}


def _head_run(name):
    case = cases.inputs(5)
    if name == "point_rend":
        case = _inside(case)
        lo = min(case["gt"][case["gt_valid"]].min(), case["props"].min())
        hi = max(case["gt"].max(), case["props"].max())
        assert lo >= 4.0 and hi <= 60.0
    jhead = cases.jax_head(_tiny(name, "jax"))
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]), KEY)
    kw = {"gt_masks": jnp.asarray(case["masks"])} if name == "point_rend" else {}
    params = cases.randomize(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss", **kw))["params"])

    def loss_fn(p, feats):
        losses = jhead.apply({"params": p}, feats, *args, method="loss", **kw)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        params, jf)
    head = cases.port_head(_tiny(name, "torch"))
    head.load_state_dict(cases.port_state(params), strict=True)
    feats, t = cases.to_torch(case)
    given = cases.standard_draws(KEY)
    if name == "point_rend":
        given.update(_point_draws(cases.N * cases.SAMPLES // 4))
    draws = UniformDraws(given=given)
    losses = head.loss(feats, t["props"], t["prop_valid"], t["gt"], t["gt_valid"], t["labels"],
                       draws, gt_masks=t["masks"] if name == "point_rend" else None)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(given)
    return dict(jlosses=jlosses, jgrads=jgrads, losses=losses, head=head, feats=feats,
                params=params, jhead=jhead, case=case, t=t)


RUNS = {}


def _cached(name):
    if name not in RUNS:
        RUNS[name] = _head_run(name)
    return RUNS[name]


@pytest.fixture(scope="module", params=["grid", "point_rend"])
def run(request):
    return request.param, _cached(request.param)


def test_head_losses_match_jax(run):
    """Grid R-CNN's ``loss_grid`` in place of ``loss_bbox``; PointRend's
    ``loss_mask`` with the point loss in it."""
    name, r = run
    assert set(r["losses"]) == set(r["jlosses"]) == set(KEYS[name])
    for key in KEYS[name]:
        want, got = float(r["jlosses"][key]), r["losses"][key].item()
        np.testing.assert_allclose(got, want, rtol=1e-6 if key == "acc" else 1e-5, err_msg=key)
        assert got > 0 or key == "acc", key


def test_head_gradients_match_jax(run):
    name, r = run
    want = cases.port_state(r["jgrads"][0])
    named = dict(r["head"].named_parameters())
    assert set(named) == set(want)
    for pname, p in named.items():
        w = want[pname].numpy()
        if name == "grid" and pname.startswith("bbox_head.fc_reg."):
            assert p.grad is None and not w.any()            # no loss trains it
            continue
        assert p.grad is not None and np.abs(w).max() > 0, pname
        _close(p.grad.numpy(), w, err_msg=f"{name} {pname}")
    for i, (f, jg) in enumerate(zip(r["feats"], r["jgrads"][1])):
        jg = np.asarray(jg).transpose(0, 3, 1, 2)
        if i == 4:
            assert f.grad is None and not jg.any()
            continue
        _close(f.grad.numpy(), jg, err_msg=f"{name} level {i}")
    extra = {"grid": "grid_head.convs.1.gn.weight", "point_rend": "point_head.fcs.2.conv.weight"}
    assert extra[name] in named


def test_grid_serves_boxes_from_an_fc_reg_no_loss_trains():
    """The test path is ``StandardRoIHead.simple_test`` in both packages:
    the grid head never runs there, the boxes come from ``fc_reg``, whose
    gradient is zero in JAX's loss (ROADMAP C). Both packages' detections
    agree, and move with ``fc_reg``."""
    r = _cached("grid")
    assert not np.asarray(r["jgrads"][0]["head"]["fc_reg"]["kernel"]).any()
    jf = [jnp.asarray(f) for f in r["case"]["feats"]]
    shapes = jnp.asarray([[cases.H, cases.W]] * cases.N, jnp.float32)
    test = jax.jit(lambda p: r["jhead"].apply(
        {"params": p}, jf, jnp.asarray(r["case"]["props"]), jnp.asarray(r["case"]["prop_valid"]),
        shapes, jnp.ones((cases.N, 4)), method="simple_test"))
    want = test(r["params"])
    feats = [f.detach() for f in r["feats"]]
    run = lambda: r["head"].simple_test(feats, r["t"]["props"], r["t"]["prop_valid"],  # noqa
                                        torch.from_numpy(np.asarray(shapes)).clone(),
                                        torch.ones(cases.N, 4))
    with torch.no_grad():
        got = run()
    jd, jl, jv = (np.asarray(x) for x in want)
    td, tl, tv = (x.numpy() for x in got)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl[tv], jl[jv])
    _close(td[tv][:, :4], jd[jv][:, :4])
    moved = jax.tree_util.tree_map(lambda x: x, r["params"])
    moved["head"] = dict(moved["head"], fc_reg=dict(
        kernel=moved["head"]["fc_reg"]["kernel"] * 3.0, bias=moved["head"]["fc_reg"]["bias"]))
    assert not np.allclose(np.asarray(test(moved)[0])[jv], jd[jv])


def test_point_rend_points_come_from_a_fixed_key_in_jax():
    """JAX's ``_mask_loss`` hands ``_point_loss`` ``jax.random.PRNGKey(0)``
    on every step (``htc_scnet_heads.py:392``); the port draws the points
    from the step's draws, so two generators give two point losses."""
    from oadg_tpu.models.roi_heads.htc_scnet_heads import PointRendRoIHead as JaxPR
    assert "jax.random.PRNGKey(0)" in inspect.getsource(JaxPR._mask_loss)
    r = _cached("point_rend")
    t, feats = r["t"], [f.detach() for f in r["feats"]]
    out = []
    for seed in (0, 1):
        given = cases.standard_draws(KEY)
        draws = UniformDraws(torch.Generator().manual_seed(seed), given=given)
        with torch.no_grad():
            out.append(r["head"].loss(feats, t["props"], t["prop_valid"], t["gt"],
                                      t["gt_valid"], t["labels"], draws,
                                      gt_masks=t["masks"])["loss_mask"].item())
        assert draws.drawn["rcnn.point.cand"].shape == (cases.N * cases.SAMPLES // 4, 588, 2)
    assert out[0] != out[1]


def test_point_rend_config_as_given_raises_in_both_packages():
    """``configs/point_rend`` names no ``mask_roi_extractor``: the mask RoIs
    take the box layer's 7x7, the head's 14x14 logits meet 28x28 targets.
    JAX raises on the product (ROADMAP C), the port a ``ValueError`` that
    names the fix."""
    case = cases.inputs(6)
    jm = cases.tiny_roi(cases.load_model("point_rend", "jax"))
    jm["roi_head"]["point_head"].update(fc_channels=16, num_classes=NC)
    jhead = cases.jax_head(jm)
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]), KEY)
    with pytest.raises(TypeError, match=r"\(128, 14, 14\)|incompatible shapes|14, 14"):
        jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss",
                                          gt_masks=jnp.asarray(case["masks"])))
    tm = cases.tiny_roi(cases.load_model("point_rend", "torch"))
    tm["roi_head"]["point_head"].update(in_channels=C, fc_channels=16, num_classes=NC)
    head = cases.port_head(tm)
    feats, t = cases.to_torch(case)
    with pytest.raises(ValueError, match="mask_roi_extractor"):
        head.loss(feats, t["props"], t["prop_valid"], t["gt"], t["gt_valid"], t["labels"],
                  UniformDraws(torch.Generator().manual_seed(0)), gt_masks=t["masks"])


# ------------------------------------------------------------- the detectors ----

DET_KEYS = [jax.random.PRNGKey(41), jax.random.PRNGKey(42)]


def _det_variables(jdet, batch, seed=0):
    """Seeded variables of the JAX detector from its training shapes (the
    grid head and the point head exist only there)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jdet.init({"params": jax.random.PRNGKey(0),
                                               "sampling": jax.random.PRNGKey(1)}, batch, "train"))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return (rng.normal(0, 0.05, s.shape) if name == "bias"
                else np.zeros(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _det_draws(n, num_anchors, num_cand):
    def pair(key, size):
        kp, kn = jax.random.split(key)
        return np.asarray(jax.random.uniform(kp, (size,))), np.asarray(
            jax.random.uniform(kn, (size,)))

    rpn = [pair(k, num_anchors) for k in jax.random.split(DET_KEYS[0], n)]
    roi = [pair(k, num_cand) for k in jax.random.split(DET_KEYS[1], n)]
    t = lambda x: torch.from_numpy(np.stack(x))          # noqa: E731
    return {"rpn.pos": t([p for p, _ in rpn]), "rpn.neg": t([q for _, q in rpn]),
            "rcnn.pos": t([p for p, _ in roi]), "rcnn.neg": t([q for _, q in roi])}


@pytest.fixture(scope="module", params=["grid", "point_rend"])
def det_run(request):
    """PointRend on one image: with one image JAX's folded gather cannot
    read another image, so the two packages sample the same fine
    features wherever the RPN's boxes fall."""
    name = request.param
    n = 2 if name == "grid" else 1
    rng = np.random.RandomState(11)
    case = cases.inputs(7)
    img = rng.normal(0, 1, (n, cases.H, 96, 3)).astype(np.float32)
    batch = {"img": img, "img_shape": np.array([[64, 96], [60, 90]][:n], np.float32),
             "scale_factor": np.ones((n, 4), np.float32), "gt_bboxes": case["gt"][:n],
             "gt_labels": case["labels"][:n], "gt_valid": case["gt_valid"][:n]}
    if name == "point_rend":
        batch["gt_masks"] = case["masks"][:n]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    test_keys = ("img", "img_shape", "scale_factor")
    jdet = jax_build_detector(_tiny(name, "jax", detector=True), num_views=1)
    variables = _det_variables(jdet, jb)
    calls = []

    def fixed_rng(self, kind):
        calls.append(kind)
        return DET_KEYS[(len(calls) - 1) % 2]

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:                                    # one trace of both paths
        jlosses, jtest = jax.jit(lambda v, b: (jdet.apply(v, b, "train"), jdet.apply(
            v, {k: b[k] for k in test_keys}, "test")))(variables, jb)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 2
    tmodel = _tiny(name, "torch", detector=True)
    det = build_detector(tmodel, device="cpu")
    sd = jax_variables_to_state_dict(variables, roi_channels=C)
    det.load_state_dict(sd, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    tb["gt_labels"] = tb["gt_labels"].long()
    with torch.no_grad():
        feats = det.extract_feat(tb["img"])
        anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
        given = _det_draws(n, anchors, cases.G + tmodel["train_cfg"]["rpn_proposal"]["max_per_img"])
        if name == "point_rend":
            given.update(_point_draws(n * cases.SAMPLES // 4))
        draws = UniformDraws(given=given)
        losses = det.forward_train(tb, draws)
        det.eval()
        got = det.simple_test({k: tb[k] for k in test_keys})
    assert set(draws.drawn) == set(given)
    return dict(name=name, jlosses=jlosses, losses=losses, jtest=jtest, got=got, det=det, sd=sd)


def test_detector_forward_train_matches_jax(det_run):
    jl, losses = det_run["jlosses"], det_run["losses"]
    assert set(losses) == set(jl)
    assert ("loss_grid" in jl) == (det_run["name"] == "grid") and "loss_rpn_cls" in jl
    for k, v in jl.items():
        np.testing.assert_allclose(losses[k].item(), float(v),
                                   rtol=1e-6 if k == "acc" else 1e-5, err_msg=k)


def test_detector_simple_test_matches_jax(det_run):
    """Boxes (and PointRend's coarse 28x28 masks: Mask R-CNN's test path, no
    subdivision)."""
    want = [np.asarray(x) for x in det_run["jtest"]]
    got = [x.numpy() for x in det_run["got"]]
    assert len(got) == len(want) == (4 if det_run["name"] == "point_rend" else 3)
    (jd, jl, jv), (td, tl, tv) = want[:3], got[:3]
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl[tv], jl[jv])
    _close(td[tv][:, :4], jd[jv][:, :4])
    np.testing.assert_allclose(td[tv][:, 4], jd[jv][:, 4], rtol=0, atol=1e-5)
    if det_run["name"] == "point_rend":
        _close(got[3][tv], want[3][jv])


def test_detector_mmdet_checkpoint(det_run):
    """The model's tensors under mmdet's names load whole; an mmdet Grid
    R-CNN checkpoint (its ``forder_trans`` beside, its convs without a
    bias) is refused, naming the tensors."""
    det = det_run["det"]
    sd = {k: v.clone() for k, v in det_run["sd"].items()}
    report = load_mmdet_checkpoint(det, dict(sd))
    assert not report["missing"] and len(report["loaded"]) == len(sd)
    if det_run["name"] == "grid":
        mm = {k: v for k, v in sd.items() if not k.endswith("conv.bias") or "grid" not in k}
        with pytest.raises(KeyError, match=r"grid_head\.convs\.0\.conv\.bias"):
            load_mmdet_checkpoint(det, dict(mm))
        mm["roi_head.grid_head.forder_trans.0.conv1.weight"] = torch.zeros(1)
        with pytest.raises(KeyError, match="forder_trans"):
            load_mmdet_checkpoint(det, mm)
    else:
        assert "roi_head.point_head.fc_logits.weight" in report["loaded"]


# --------------------------------------------------------------- TridentNet ----

def test_trident_resnet_matches_jax_in_both_modes():
    """The shared 3x3 at dilations 1, 2, 3 on three branches folded onto the
    batch (``mode="train"``), or the branch ``test_branch_idx``
    (``"test"``); the blocks of depth 18 (the Bottleneck either way), the
    published widths (2048 channels at stride 32)."""
    from oadg_tpu.models.backbones.trident_resnet import TridentResNet as JaxTrident
    from oadg_tpu_torch.models.backbones.trident_resnet import TridentResNet
    rng = np.random.RandomState(8)
    x = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    modes = {m: JaxTrident(depth=18, mode=m) for m in ("train", "test")}
    shapes = jax.eval_shape(lambda: modes["train"].init(jax.random.PRNGKey(0), x))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("kernel", "conv2_kernel"):
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return rng.normal(0, 0.05, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    want = jax.jit(lambda v: {m: mod.apply(v, x)[0] for m, mod in modes.items()})(variables)
    sd = jax_variables_to_state_dict({"params": {"backbone_m": variables["params"]},
                                      "batch_stats": {"backbone_m": variables["batch_stats"]}})
    sd = {k[len("backbone."):]: v for k, v in sd.items()}
    assert sd["layer4.0.conv2.weight"].shape == (512, 512, 3, 3)
    assert "layer4.0.downsample.1.running_var" in sd
    net = TridentResNet(depth=18)
    net.load_state_dict(sd, strict=True)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for mode in ("train", "test"):
        net.mode = mode
        with torch.no_grad():
            (got,) = net(tx)
        w = np.asarray(want[mode]).transpose(0, 3, 1, 2)
        assert got.shape == w.shape == ((3 if mode == "train" else 1), 2048, 2, 2)
        _close(got.numpy(), w, err_msg=mode)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_jax_trident_detector_raises_and_the_port_refuses_it(mode):
    """JAX's ``TridentFasterRCNN`` is a bare ``TwoStageDetector``: its
    backbone folds the three branches onto the batch and nothing tiles the
    gts or picks the test branch, so both modes raise (ROADMAP C). The port
    refuses the type, saying why."""
    from oadg_tpu.config import Config
    from oadg_tpu_torch.config import load_config
    path = f"{cases.ROOT}/configs/tridentnet/tridentnet_r50_caffe_1x_coco.py"
    model = Config.fromfile(path, import_custom_modules=False)["model"]
    model["backbone"]["depth"] = 18
    jdet = jax_build_detector(model, num_views=1)
    batch = {"img": jnp.zeros((2, 64, 64, 3)), "img_shape": jnp.full((2, 2), 64.0),
             "scale_factor": jnp.ones((2, 4)),
             "gt_bboxes": jnp.asarray(np.tile([[4.0, 4.0, 40.0, 40.0]], (2, 2, 1))),
             "gt_labels": jnp.zeros((2, 2), jnp.int32), "gt_valid": jnp.ones((2, 2), bool)}
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jax.eval_shape(lambda: jdet.init({"params": jax.random.PRNGKey(0),
                                          "sampling": jax.random.PRNGKey(1)}, batch, mode))
    with pytest.raises(ValueError, match="the port builds only the ported slices' types.*"
                                         "never tiles the gts.*stride 32"):
        build_detector(dict(load_config(path)["model"]), device="meta")
