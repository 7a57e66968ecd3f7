"""The IoU-loss family, the focal loss and ``bbox_overlaps(mode='giou')`` of
the port against the JAX package, on the CPU; then the GIoU Faster R-CNN
training step (``configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py``).

- ``bbox_overlaps`` in ``iou``, ``iof`` and ``giou`` modes, pairwise and
  aligned, and every loss (``IoULoss`` log / linear / square,
  ``BoundedIoULoss``, ``GIoULoss``, ``DIoULoss``, ``CIoULoss``,
  ``FocalLoss``) on seeded boxes, some disjoint from their targets, with
  ``(R, 4)`` box weights (cut to their first column, as in the JAX package)
  and an ``avg_factor``: values and gradients (autograd against
  ``jax.grad``) rtol 1e-5, with a floor of 1e-6 of the largest gradient
  (entries near 0 carry the float32 noise of the larger terms; 1e-5 for
  the pairwise overlaps, whose gradients sum 40 columns each);
- the step: the config made tiny as ``tests/test_torch_baseline.py`` makes
  the baseline (R18-FPN at 16 channels, 32 sampled anchors and 16 rois an
  image, its 80 classes), one batch of 2 images of 64x96, the JAX
  ``forward_train`` with two fixed sampling keys and the port handed JAX's
  uniforms. ``reg_decoded_bbox``: the box head's targets are the matched gt
  boxes and its loss decodes the chosen deltas against the sampled rois.
  Losses rtol 1e-5; every trainable gradient within 1e-4 of its largest
  magnitude; the GIoU loss bounded by ``loss_weight x 2``
  (``tests/test_forward.py:186-216``).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.config import Config
from oadg_tpu.core.bbox.geometry import bbox_overlaps as jax_bbox_overlaps
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.utils.registry import LOSSES as JAX_LOSSES
from oadg_tpu.utils.registry import build_from_cfg as jax_build_from_cfg
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.core.bbox.geometry import bbox_overlaps
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from oadg_tpu_torch.utils.registry import LOSSES, build_from_cfg
from test_torch_baseline import KEYS, _jax_draws, _tiny_baseline
from test_torch_train_step import _batch, _randomize

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIOU = "configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py"
B, G = 2, 5


def _boxes(rng, n, extent=100.0):
    x1 = rng.uniform(0, extent, n)
    y1 = rng.uniform(0, extent, n)
    return np.stack([x1, y1, x1 + rng.uniform(2, 40, n),
                     y1 + rng.uniform(2, 40, n)], -1).astype(np.float32)


def _pairs():
    """64 predictions near their targets (jittered), 8 disjoint ones."""
    rng = np.random.RandomState(3)
    target = _boxes(rng, 72)
    pred = target + rng.normal(0, 4, target.shape).astype(np.float32)
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    pred[64:] = target[64:] + 150.0
    weight = np.ones((72, 4), np.float32)
    weight[::5] = 0
    return pred, target, weight


def _grad_close(got, want, msg="", floor=1e-6):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=floor * max(np.abs(want).max(), 1e-12), err_msg=msg)


@pytest.mark.parametrize("mode,aligned", [("iou", False), ("iof", False), ("giou", False),
                                          ("iou", True), ("giou", True)])
def test_bbox_overlaps_and_gradient_match_jax(mode, aligned):
    pred, target, _ = _pairs()
    b2 = target if aligned else target[:40]

    def jfun(p):
        return jnp.sum(jax_bbox_overlaps(p, jnp.asarray(b2), mode=mode,
                                         is_aligned=aligned) ** 2), \
            jax_bbox_overlaps(p, jnp.asarray(b2), mode=mode, is_aligned=aligned)

    (_, jval), jgrad = jax.value_and_grad(jfun, has_aux=True)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    val = bbox_overlaps(tp, torch.from_numpy(b2), mode=mode, is_aligned=aligned)
    (val ** 2).sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), rtol=1e-5, atol=1e-7)
    _grad_close(tp.grad.numpy(), np.asarray(jgrad), floor=1e-6 if aligned else 1e-5)
    if mode == "giou":
        assert float(val.detach().min()) < 0   # disjoint pairs: GIoU below 0


BOX_LOSSES = [dict(type="IoULoss", mode="log", loss_weight=10.0),
              dict(type="IoULoss", mode="linear", loss_weight=10.0),
              dict(type="IoULoss", mode="square"),
              dict(type="IoULoss", linear=True),
              dict(type="BoundedIoULoss", loss_weight=10.0),
              dict(type="GIoULoss", loss_weight=10.0),
              dict(type="DIoULoss", loss_weight=2.0),
              dict(type="CIoULoss", loss_weight=12.0)]


@pytest.mark.parametrize("cfg", BOX_LOSSES,
                         ids=[f"{c['type']}-{c.get('mode', 'linear' if c.get('linear') else '')}"
                              for c in BOX_LOSSES])
@pytest.mark.parametrize("avg_factor", [None, 37.0])
def test_box_losses_and_gradients_match_jax(cfg, avg_factor):
    pred, target, weight = _pairs()
    jloss = jax_build_from_cfg(dict(cfg), JAX_LOSSES)
    loss = build_from_cfg(dict(cfg), LOSSES)
    jval, jgrad = jax.value_and_grad(lambda p: jloss(
        p, jnp.asarray(target), jnp.asarray(weight), avg_factor=avg_factor))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    val = loss(tp, torch.from_numpy(target), torch.from_numpy(weight), avg_factor=avg_factor)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    _grad_close(tp.grad.numpy(), np.asarray(jgrad), msg=cfg["type"])
    assert np.abs(tp.grad.numpy()[::5]).max() == 0          # weight 0 rows


def test_ciou_alpha_is_detached():
    """The CIoU gradient is that of ``1 - iou + rho^2 / c^2 + alpha v`` with
    ``alpha`` a constant: the DIoU gradient plus ``alpha dv``."""
    pred, target, _ = _pairs()
    tp = torch.from_numpy(pred).requires_grad_(True)
    build_from_cfg(dict(type="CIoULoss"), LOSSES)(tp, torch.from_numpy(target)).backward()
    ciou = tp.grad.clone()
    tp.grad = None
    build_from_cfg(dict(type="DIoULoss"), LOSSES)(tp, torch.from_numpy(target)).backward()
    assert not torch.equal(ciou, tp.grad)


@pytest.mark.parametrize("reduction,avg", [("mean", 11.0), ("mean", None), ("sum", None)])
def test_focal_loss_matches_jax(reduction, avg):
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 2, (300, 8)).astype(np.float32)
    labels = rng.randint(0, 9, 300).astype(np.int32)        # 8: background
    weight = (rng.uniform(0, 1, 300) < 0.8).astype(np.float32)
    cfg = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
               reduction=reduction, loss_weight=1.5)
    jloss = jax_build_from_cfg(dict(cfg), JAX_LOSSES)
    jval, jgrad = jax.value_and_grad(lambda x: jloss(
        x, jnp.asarray(labels), jnp.asarray(weight), avg_factor=avg))(jnp.asarray(logits))
    tx = torch.from_numpy(logits).requires_grad_(True)
    val = build_from_cfg(dict(cfg), LOSSES)(tx, torch.from_numpy(labels).long(),
                                           torch.from_numpy(weight), avg_factor=avg)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    _grad_close(tx.grad.numpy(), np.asarray(jgrad))


# --------------------------------------------------------- the GIoU step ----

@pytest.fixture(scope="module")
def giou_step():
    model = _tiny_baseline(Config.fromfile(os.path.join(ROOT, GIOU),
                                           import_custom_modules=False))["model"]
    head = model["roi_head"]["bbox_head"]
    assert head["reg_decoded_bbox"] and head["loss_bbox"]["type"] == "GIoULoss"
    batch = {k: v[:B] for k, v in _batch().items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=1)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jbatch["img"], "img_shape": jbatch["img_shape"]}))
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
            variables["params"], variables["batch_stats"], jbatch)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 2
    det = init_detector({"model": model}, device="cpu", num_views=1).model
    det.train()
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = det.extract_feat(tb["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    losses = det.forward_train(tb, UniformDraws(given=_jax_draws(num_anchors, G + rp)))
    sum(v for k, v in losses.items() if "loss" in k).backward()
    return dict(det=det, losses=losses, jlosses=jlosses, want=jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16))


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc",
                                 "loss_bbox"])
def test_giou_step_losses_match_jax(giou_step, key):
    got = float(giou_step["losses"][key].detach())
    np.testing.assert_allclose(got, float(giou_step["jlosses"][key]), rtol=1e-5)
    if key == "loss_bbox":
        assert 0 < got <= 20.0


def test_giou_step_gradients_match_jax(giou_step):
    det, want = giou_step["det"], giou_step["want"]
    n = 0
    for name, p in det.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=name)
        n += 1
    assert n == 75
    # the box regressor learns through the decoded boxes' GIoU
    assert float(det.roi_head.bbox_head.fc_reg.weight.grad.abs().max()) > 0
