"""The configs of A.2.9a whole: the FPG Faster R-CNN and YOLOv3-MobileNetV2
of the port against the JAX package on the CPU, tiny
(``torch_backbone_cases.tiny_model``), on 2 seeded images with 4 gts each
(one padded) and seeded numpy weights for the whole JAX detector
(``jax.eval_shape`` and ``torch_onestage_cases.randomize``) loaded into the
port strictly; then all six configs as published, at full width, with no
compile: JAX's backbone and neck variables from ``jax.eval_shape`` map onto
the port's parameters and buffers leaf for leaf, and the port's frozen
parameters are those of JAX's ``frozen_mask``.

The FPG model runs in float32. YOLOv3-MobileNetV2 runs in float64 on both
sides (JAX under ``jax.enable_x64``, the float32 casts of its live BN, YOLO
head, box coder and losses widened to float64 for the trace, ``_Wide``): in
float32 a ReLU6 or leaky-ReLU input within rounding of its kink lands on
the other side in one package, and with the gradient held at a few positive
anchors one such element moves whole tensors' gradients by up to 37% of
their largest (measured on 64x96 and on 128x192 images, in both packages'
float32 runs against the port's float64 run; a larger canvas only adds
elements near a kink); in float64 they agree within 5e-7 of each tensor's
largest. Its float32 path is held by
``test_torch_backbones_parts.py`` (MobileNetV2's outputs, gradients and
statistics) and the earlier YOLOv3 neck and head tests.

JAX runs, in one jit a model, the training forward in train mode (the live
BNs' new statistics returned; the FPG model's RPN and RoI samplers fixed
to ``torch_detr_cases.KEYS``, whose uniforms the port is handed as
``UniformDraws``), the gradients of its losses w.r.t. every parameter, and
the test call on the variables before the step; the port serves first (in
eval mode), then trains. Tolerances (``TOLS``), float32 (FPG) / float64
(YOLOv3-MobileNetV2): losses rtol 1e-4 / 1e-6; every trainable gradient
rtol 1e-3 / 1e-5 with a floor of 3e-4 / 1e-6 of its largest (the FPG
model's P6 output conv and its stack's P6 conv get a gradient of exactly 0
in both packages: no sampled anchor or RoI reads P6 at 64x128;
YOLOv3-MobileNetV2's project BNs' biases have an exact gradient of 0, both
packages' within ``ZERO_GRAD`` of the model's largest); the live BNs'
stored statistics rtol 1e-4 / 1e-6 with a floor of 1e-5 / 1e-7 of the
largest; detections: labels and valid rows equal, boxes within 1e-4 of the
largest coordinate, scores within 1e-5.
"""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_backbone_cases as cases
import torch_detr_cases as dcases
from oadg_tpu.config import Config
from oadg_tpu.engine.optim import frozen_mask
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
TEST_KEYS = ("img", "img_shape", "scale_factor")
# a live BN's bias whose shift the next live BN removes (MobileNetV2's project
# BNs) has an exact gradient of 0: both packages read below 1e-6 (float32) /
# 1e-12 (float64) of the model's largest gradient there
ZERO_GRAD = {"fpg": 1e-6, "mobilenet_v2": 1e-12}
# (losses rtol, gradients rtol and floor, statistics rtol and floor)
TOLS = {"fpg": (1e-4, 1e-3, 3e-4, 1e-4, 1e-5),
        "mobilenet_v2": (1e-6, 1e-5, 1e-6, 1e-6, 1e-7)}
F64 = ("mobilenet_v2",)
WIDENED = ("oadg_tpu.models.layers", "oadg_tpu.models.dense_heads.yolo_head",
           "oadg_tpu.core.bbox.coder", "oadg_tpu.models.losses.common")


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``: set as ``jnp`` of
    the ``WIDENED`` modules while a float64 model is traced."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)
LOSSES = {"fpg": ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc"),
          "mobilenet_v2": ("loss_cls", "loss_conf", "loss_xy", "loss_wh")}


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(LOSSES))
def run(request):
    """JAX's training forward, gradients and new statistics and its test
    call in one jit; the port's test call, then its training forward."""
    from oadg_tpu.models.detectors.single_stage import SingleStageDetector as JaxSingleStage
    from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
    name = request.param
    f64 = name in F64
    b = cases.batch(name)
    if f64:
        b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
    jdet = jax_build_detector(cases.jax_model(name))
    calls = []

    def fixed_rng(self, kind):
        calls.append(kind)
        return jax.random.PRNGKey(dcases.KEYS[(len(calls) - 1) % 2])

    def jax_run(variables, b):
        def loss_fn(params):
            losses, new = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     b, "train", mutable=["batch_stats"])
            return sum(v for k, v in losses.items() if "loss" in k), (losses, new)

        (_, (losses, new)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return losses, grads, new["batch_stats"], jdet.apply(
            variables, {k: b[k] for k in TEST_KEYS}, "test")

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage if name == "fpg" else JaxSingleStage, "make_rng", fixed_rng)
    for module in WIDENED if f64 else ():
        mp.setattr(f"{module}.jnp", _Wide())
    try:
        with jax.enable_x64(f64):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            shapes = jax.eval_shape(lambda r, x: jdet.init(r, x, "test"),
                                    {"params": jax.random.PRNGKey(0),
                                     "sampling": jax.random.PRNGKey(1)},
                                    {k: jb[k] for k in TEST_KEYS})
            variables = {"params": cases.oc.randomize(shapes["params"]),
                         "batch_stats": cases.oc.randomize(shapes["batch_stats"], 3)}
            if f64:
                variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), variables)
            calls.clear()
            jlosses, jgrads, jstats, jtest = _as_np(jax.jit(jax_run)(variables, jb))
    finally:
        mp.undo()
    det = init_detector({"model": cases.torch_model(name)}, device="cpu", seed=0).model
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tb = dcases.torch_batch(b)
    if f64:
        det.double()
    det.eval()
    with torch.no_grad():
        test = det.simple_test({k: tb[k] for k in TEST_KEYS})
        feats = det.extract_feat(tb["img"])
    det.train()
    if name == "fpg":
        assert calls == ["sampling"] * 2
        num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
        rp = det.train_cfg["rpn_proposal"]["max_per_img"]
        draws = UniformDraws(given=dcases.jax_draws(num_anchors, 4 + rp))
    else:
        draws = UniformDraws()
    losses = det.forward_train(tb, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    out = dict(name=name, det=det, variables=variables, jlosses=jlosses, losses=losses,
               want_grads=jax_variables_to_state_dict({"params": jgrads}),
               want_stats=jax_variables_to_state_dict({"batch_stats": jstats}),
               jtest=jtest, test=test)
    return out


def _held(run, got, want, key, floor):
    """``got`` (the port's) against ``want`` (JAX's): a gradient at the
    model's ``TOLS`` rtol with a floor of ``floor``, a statistic (``floor``
    0) at its statistics' rtol and floor of its largest."""
    _, g_rtol, _, s_rtol, s_floor = TOLS[run["name"]]
    want = want.numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=g_rtol if floor else s_rtol,
                               atol=floor or s_floor * np.abs(want).max(), err_msg=key)


def test_losses_match_jax(run):
    want = LOSSES[run["name"]]
    assert set(run["losses"]) == set(run["jlosses"]) == set(want)
    for key in want:
        got, jw = float(run["losses"][key].detach()), float(run["jlosses"][key])
        np.testing.assert_allclose(got, jw, rtol=TOLS[run["name"]][0], err_msg=key)
        assert np.isfinite(got) and got > 0, key


def test_every_trainable_gradient_matches_jax(run):
    """Every trainable parameter (the FPG model's backbone stages 2-4, its
    neck, RPN and RoI head; all of YOLOv3-MobileNetV2's); the frozen stem
    and ``layer1`` of the R18 get none in either package."""
    det, want = run["det"], run["want_grads"]
    params = dict(det.named_parameters())
    assert set(want) == set(params)
    frozen = {k for k, p in params.items() if not p.requires_grad}
    if run["name"] == "fpg":
        assert frozen and all(k.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1."))
                              for k in frozen)
        assert not any(want[k].numpy().any() for k in frozen)
    else:
        assert not frozen
    largest = max(float(np.abs(w.numpy()).max()) for w in want.values())
    zero = []
    for k, p in params.items():
        if k in frozen:
            continue
        w = want[k].numpy()
        assert p.grad is not None, k
        if not w.any():
            assert not p.grad.any(), k
            zero.append(k)
            continue
        floor = TOLS[run["name"]][2]
        _held(run, p.grad, want[k], k,
              max(floor * np.abs(w).max(), ZERO_GRAD[run["name"]] * largest))
    assert zero == ([] if run["name"] == "mobilenet_v2" else
                    [f"neck.{conv}.{leaf}" for conv in ("down_convs.0.3", "out_convs.4")
                     for leaf in ("conv.weight", "bn.weight", "bn.bias")]), zero


def test_live_bn_statistics_match_jax(run):
    """After the training forward every live BN's stored statistics moved
    as JAX's: YOLOv3-MobileNetV2's backbone, neck and head, the FPG
    model's 13 neck BNs (a stack of 4 downs and 4 ups, 5 outputs); the R18's
    frozen BNs did not move."""
    det, want = run["det"], run["want_stats"]
    before = jax_variables_to_state_dict({"batch_stats": run["variables"]["batch_stats"]})
    sd = det.state_dict()
    live = {k for k in want if not torch.equal(sd[k], before[k])}
    if run["name"] == "fpg":
        assert live == {k for k in want if k.startswith("neck.")} and len(live) == 2 * 13
    else:
        assert live == set(want)
    for k in live:
        _held(run, sd[k], want[k], k, 0)


def test_simple_test_matches_jax(run):
    """``(dets, labels, valid)`` of the test call, on the weights before the
    step."""
    (jd, jl, jv), (td, tl, tv) = run["jtest"][:3], run["test"][:3]
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl.numpy()[tv.numpy()], jl[jv])
    dets, jdets = td[tv].numpy(), jd[jv]
    np.testing.assert_allclose(dets[:, :4], jdets[:, :4], rtol=0,
                               atol=1e-4 * np.abs(jdets[:, :4]).max())
    np.testing.assert_allclose(dets[:, 4], jdets[:, 4], rtol=0, atol=1e-5)


# ------------------------------------------------- full width, no compile ----

def _full_width(name):
    """JAX's variables of the published config's backbone and neck (shapes,
    from ``jax.eval_shape`` of ``extract_feat`` on a 128x256 canvas; the
    heads are the earlier slices') and the port's model on
    ``device='meta'``."""
    path = f"{cases.ROOT}/{cases.CONFIGS[name]}"
    jmodel = Config.fromfile(path, import_custom_modules=False)["model"]
    jdet = jax_build_detector(jmodel)
    shapes = jax.eval_shape(lambda r, x: jdet.init(r, x, method=lambda m, x: m.extract_feat(x)),
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 128, 256, 3), jnp.float32))
    det = build_detector(dict(load_config(path).model), device="meta")
    return jmodel, shapes, det


@pytest.mark.parametrize("name", sorted(cases.CONFIGS))
def test_full_width_variables_map_and_freeze_sets_equal_jax(name):
    """Every JAX leaf of the backbone and neck maps onto a port parameter or
    buffer of its shape and every port tensor of theirs is mapped
    (RegNetX-3.2GF's schedule, Res2Net-101's
    chunks, ResNeSt's ``planes / 16`` widths, CARAFE's encoders, FPG's 9
    stacks); the port's ``requires_grad=False`` parameters are exactly
    those that JAX's ``frozen_mask`` masks: RegNet's ``layer1`` (its stem
    trains), the deep stems' three convs and first BN with ``layer1`` (their
    second and third BNs train), the R50's stem and ``layer1``;
    MobileNetV2 none (ROADMAP C)."""
    jmodel, shapes, det = _full_width(name)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = jax_variables_to_state_dict(zeros)
    own = {k: v for k, v in det.state_dict().items() if k.startswith(("backbone.", "neck."))}
    assert set(sd) == set(own)
    bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)]
    assert not bad, bad[:4]
    mask = frozen_mask(shapes["params"], jmodel)
    masked = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m, s: np.full(s.shape, float(m), np.float32), mask, shapes["params"])})
    jax_frozen = {k for k, v in masked.items() if v.any()}
    port_frozen = {k for k, p in det.named_parameters() if not p.requires_grad}
    assert jax_frozen == port_frozen
    stem_bns = {k for k in dict(det.named_parameters())
                if re.fullmatch(r"backbone\.(stem\.[147]|bn1|conv1)\.\w+", k)}
    trainable_stem = sorted(stem_bns - port_frozen)
    assert trainable_stem == {
        "regnet": ["backbone.bn1.bias", "backbone.bn1.weight", "backbone.conv1.weight"],
        "res2net": [f"backbone.stem.{i}.{leaf}" for i in (4, 7) for leaf in ("bias", "weight")],
        "resnest": [f"backbone.stem.{i}.{leaf}" for i in (4, 7) for leaf in ("bias", "weight")],
    }.get(name, []), trainable_stem
    if name == "mobilenet_v2":
        assert not port_frozen
    else:
        assert any(k.startswith("backbone.layer1.") for k in port_frozen)
        assert not any(k.startswith("backbone.layer2.") for k in port_frozen)
