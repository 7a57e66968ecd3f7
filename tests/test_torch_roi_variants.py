"""Four ``StandardRoIHead`` variants in the port against the JAX package, on
the CPU: Dynamic R-CNN, Double-Head, Mask Scoring and PISA.

Each config's RoI head made tiny (``torch_twostage_cases.tiny_roi``) on
seeded FPN maps, gts and proposals, the JAX head's seeded variables carried
by ``jax_variables_to_state_dict``, the port handed the uniforms that the
JAX sampler draws from a fixed key. Dynamic R-CNN runs with ``ktop_iou``
set (in both packages) to the smallest rank whose threshold falls inside
its (0.4, 0.6) clip on these proposals, so that the adaptive threshold,
not a clip bound, decides the sample. Mask Scoring runs with mmdet's 14x14
mask RoI layer: the repo's config gives none, so its mask head's 14x14
logits meet 28x28 targets, which JAX raises on (the last test).

Tolerances: each loss rtol 1e-5 (``acc`` to 1e-6); every parameter's and
FPN map's gradient within 1e-4 of its largest magnitude; the Double-Head's
``simple_test``: the same valid detections and labels, boxes within 1e-4 of
the largest coordinate, scores within 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_twostage_cases as cases
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(13)


def _dynamic_ktop(case):
    """The smallest ``ktop_iou`` whose batch-mean threshold on ``case``'s
    proposals lies strictly inside (0.4, 0.6)."""
    from oadg_tpu_torch.models.roi_heads.more_roi_heads import DynamicRoIHead
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "feats"}
    for k in range(1, cases.P + 1):
        probe = DynamicRoIHead.__new__(DynamicRoIHead)
        probe.ktop_iou = k
        thr = float(probe.iou_threshold(t["props"], t["prop_valid"], t["gt"], t["gt_valid"]))
        if 0.401 < thr < 0.599:            # inside the clip, float32 bounds aside
            return k, thr
    raise AssertionError("no rank gives a threshold inside the clip")


def _run(name):
    case = cases.inputs(3)
    jmodel = cases.tiny_roi(cases.load_model(name, "jax"))
    tmodel = cases.tiny_roi(cases.load_model(name, "torch"))
    extra = {}
    if name == "dynamic":
        extra["ktop"], extra["thr"] = _dynamic_ktop(case)
        for m in (jmodel, tmodel):
            m["roi_head"]["ktop_iou"] = extra["ktop"]
    if name == "ms_rcnn":
        for m in (jmodel, tmodel):
            m["roi_head"]["mask_roi_extractor"] = dict(cases.MASK_ROI_14)
    jhead = cases.jax_head(jmodel)
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]), KEY)
    kw = {"gt_masks": jnp.asarray(case["masks"])} if name == "ms_rcnn" else {}
    params = cases.randomize(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss", **kw))["params"])

    def loss_fn(p, feats):
        losses = jhead.apply({"params": p}, feats, *args, method="loss", **kw)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        params, jf)
    head = cases.port_head(tmodel)
    head.load_state_dict(cases.port_state(params), strict=True)
    feats, t = cases.to_torch(case)
    draws = UniformDraws(given=cases.standard_draws(KEY))
    losses = head.loss(feats, t["props"], t["prop_valid"], t["gt"], t["gt_valid"], t["labels"],
                       draws, gt_masks=t["masks"] if name == "ms_rcnn" else None)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    return dict(jlosses=jlosses, jgrads=jgrads, losses=losses, head=head, feats=feats,
                params=params, jhead=jhead, case=case, **extra)


RUNS = {}          # each head's run, kept for the tests after the parametrised ones


def _cached(name):
    if name not in RUNS:
        RUNS[name] = _run(name)
    return RUNS[name]


@pytest.fixture(scope="module", params=["dynamic", "double_head", "ms_rcnn", "pisa"])
def run(request):
    return request.param, _cached(request.param)


KEYS = {"dynamic": ["loss_cls", "loss_bbox", "acc"],
        "double_head": ["loss_cls", "loss_bbox", "acc"],
        "ms_rcnn": ["loss_cls", "loss_bbox", "acc", "loss_mask"],
        "pisa": ["loss_cls", "loss_bbox", "acc", "loss_carl"]}


def test_losses_match_jax(run):
    name, r = run
    assert set(r["losses"]) == set(r["jlosses"]) == set(KEYS[name])
    for key in KEYS[name]:
        want, got = float(r["jlosses"][key]), r["losses"][key].item()
        if key == "acc":
            assert got == pytest.approx(want, rel=1e-6), key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{name} {key}")
            assert got > 0, key


def test_gradients_match_jax(run):
    name, r = run
    want = cases.port_state(r["jgrads"][0])
    named = dict(r["head"].named_parameters())
    assert set(named) == set(want)
    for pname, p in named.items():
        w = want[pname].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, pname
        cases.close_grads(p.grad.numpy(), w, err_msg=f"{name} {pname}")
    for i, (f, jg) in enumerate(zip(r["feats"], r["jgrads"][1])):
        jg = np.asarray(jg).transpose(0, 3, 1, 2)
        if i == 4:
            assert f.grad is None and not jg.any()
            continue
        cases.close_grads(f.grad.numpy(), jg, err_msg=f"{name} level {i}")
    extra = {"double_head": "bbox_head.conv_branch.3.conv3.weight",
             "ms_rcnn": "mask_iou_head.fcs.0.weight", "pisa": "bbox_head.fc_cls.weight",
             "dynamic": "bbox_head.shared_fcs.0.weight"}[name]
    assert extra in named


def test_dynamic_threshold_is_the_batch_mean_of_each_images_kth_iou():
    """The threshold is a tensor of the step, handed to the assigner for the
    call: the shared assigner keeps its configured 0.5."""
    r = _cached("dynamic")
    t = {k: torch.from_numpy(v) for k, v in r["case"].items() if k != "feats"}
    thr = r["head"].iou_threshold(t["props"], t["prop_valid"], t["gt"], t["gt_valid"])
    from oadg_tpu_torch.core.bbox.geometry import bbox_overlaps
    ious = bbox_overlaps(t["props"], t["gt"]) * (t["prop_valid"][..., None]
                                                  & t["gt_valid"][:, None, :])
    kth = ious.max(-1).values.sort(-1, descending=True).values[:, r["ktop"] - 1]
    assert float(thr) == pytest.approx(float(kth.mean()), rel=1e-6)
    assert 0.4 < float(thr) < 0.6 and r["thr"] == pytest.approx(float(thr))
    a = r["head"].assigner
    assert (a.pos_iou_thr, a.neg_iou_thr, a.min_pos_iou) == (0.5, 0.5, 0.5)


def test_double_head_simple_test_matches_jax():
    """The test path through the double head's two branches."""
    r = _cached("double_head")
    jf = [jnp.asarray(f) for f in r["case"]["feats"]]
    shapes = jnp.asarray([[cases.H, cases.W]] * cases.N, jnp.float32)
    want = jax.jit(lambda p: r["jhead"].apply(
        {"params": p}, jf, jnp.asarray(r["case"]["props"]), jnp.asarray(r["case"]["prop_valid"]),
        shapes, jnp.ones((cases.N, 4)), method="simple_test"))(r["params"])
    with torch.no_grad():
        got = r["head"].simple_test([f.detach() for f in r["feats"]],
                                    torch.from_numpy(r["case"]["props"]),
                                    torch.from_numpy(r["case"]["prop_valid"]),
                                    torch.from_numpy(np.asarray(shapes)).clone(),
                                    torch.ones(cases.N, 4))
    jd, jl, jv = (np.asarray(x) for x in want)
    td, tl, tv = (x.numpy() for x in got)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl[tv], jl[jv])
    np.testing.assert_allclose(td[tv][:, :4], jd[jv][:, :4], rtol=0,
                               atol=1e-4 * np.abs(jd[jv][:, :4]).max())
    np.testing.assert_allclose(td[tv][:, 4], jd[jv][:, 4], rtol=0, atol=1e-5)


def test_pisa_rank_is_stable_over_tied_negatives():
    """ISR-P's rank comes from a stable argsort of -IoU: the padded and
    negative rows all tie at -1 and keep their order, as ``jnp.argsort``
    keeps it."""
    ious = np.array([-1, 0.7, -1, 0.9, -1, 0.7, -1], np.float32)
    want = np.asarray(jnp.argsort(-jnp.asarray(ious)))
    got = torch.argsort(-torch.from_numpy(ious), stable=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 1, 5, 0, 2, 4, 6])


def test_ms_rcnn_config_as_given_raises_in_both_packages():
    """The repo's MS R-CNN config gives no ``mask_roi_extractor``: the mask
    RoIs take the box layer's 7x7, the head gives 14x14 logits against
    ``mask_size=28`` targets. JAX raises on the product (ROADMAP C), the
    port with a ``ValueError`` that says so."""
    case = cases.inputs(4)
    jhead = cases.jax_head(cases.tiny_roi(cases.load_model("ms_rcnn", "jax")))
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]), KEY)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss",
                                          gt_masks=jnp.asarray(case["masks"])))
    head = cases.port_head(cases.tiny_roi(cases.load_model("ms_rcnn", "torch")))
    feats, t = cases.to_torch(case)
    with pytest.raises(ValueError, match="mask_size=28"):
        head.loss(feats, t["props"], t["prop_valid"], t["gt"], t["gt_valid"], t["labels"],
                  UniformDraws(torch.Generator().manual_seed(0)), gt_masks=t["masks"])


def test_double_head_config_names_no_schedule_in_either_package():
    """``configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py`` lists no
    schedule among its bases (mmdet's inherits ``schedule_1x``), so both
    runners, which read ``cfg.optimizer``, cannot train it as published
    (ROADMAP C); ``configs/_base_/schedules/schedule_1x.py`` supplies the
    three keys (``chip_smoke.twostage_cfg`` merges them)."""
    import os
    from oadg_tpu.config import Config
    from oadg_tpu_torch.config import load_config
    path = os.path.join(cases.ROOT, cases.CONFIGS["double_head"])
    sched = load_config(os.path.join(cases.ROOT, "configs/_base_/schedules/schedule_1x.py"))
    for cfg in (Config.fromfile(path, import_custom_modules=False), load_config(path)):
        assert not {"optimizer", "lr_config", "optimizer_config"} & set(cfg.keys())
    assert sched.optimizer.lr == 0.02 and sched.lr_config.step == [8, 11]
