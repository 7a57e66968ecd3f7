"""Parts of the one-stage family's next five configs against the JAX
package, on the CPU, on seeded numpy inputs:

- ``KnowledgeDistillationKLDivLoss`` (LD's ``loss_ld``; T = 10, with and
  without a weight and an ``avg_factor``): the value and the student
  logits' gradient rtol 1e-5 (the weighted sum of 40 rows in another order
  reads 1.1e-6), the gradient with a floor of 1e-6 of its largest;
- FreeAnchor's ``box_prob``: the port scatters each gt's saturated IoUs
  into its class's column (``scatter_reduce(amax)`` into an (N, K, C) map)
  where JAX takes the maximum over a (G, K, C) product with the gts'
  one-hot classes (``free_anchor_heads.py:59``); exactly equal, on gts
  that share classes, an invalid gt and a gt whose best IoU is below
  ``bbox_thr``;
- FSAF's online feature selection: the level each gt selects
  (``FSAFHead.targets``) against the one JAX's ``FSAFHead.loss`` takes
  (``fovea_fsaf_heads.py:299``, read through ``jax.debug.callback`` from a
  stand-in for the module's ``jnp`` that records the per-gt ``argmin``)
  exactly, and the losses rtol 1e-5, on gts large enough to hold effective
  points at several levels;
- LD's teacher: the port's is bit-identical after two SGD steps of the
  tiny LD detector (weight decay and momentum on) and none of its
  parameters is in the optimizer, while every student leaf's is; JAX's
  teacher sits in the optimized tree outside ``frozen_mask``, so one step of
  JAX's SGD with a zero gradient for it (its loss reads it under
  ``stop_gradient``) moves every nonzero teacher leaf by its weight decay
  (ROADMAP C);
- FoveaBox's and FSAF's classifier bias starts at 0 in both packages
  (mmdet: the 0.01 prior; ROADMAP C).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_onestage_cases as cases
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.dense_heads import fovea_fsaf_heads as jax_fovea_fsaf
from oadg_tpu.models.losses.extra import KnowledgeDistillationKLDivLoss as JKD
from oadg_tpu_torch.core.bbox.geometry import bbox_overlaps
from oadg_tpu_torch.core.bbox.transforms import distance2bbox
from oadg_tpu_torch.engine import build_optimizer, make_train_step
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.dense_heads.fcos_head import level_points
from oadg_tpu_torch.models.dense_heads.free_anchor_heads import box_prob
from oadg_tpu_torch.models.losses import KnowledgeDistillationKLDivLoss
from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg

torch.set_num_threads(2)
T = torch.from_numpy


@pytest.mark.parametrize("weighted", [False, True])
def test_kd_loss_and_gradient_match_jax(weighted):
    rng = np.random.RandomState(0)
    pred = rng.normal(0, 3, (40, 17)).astype(np.float32)
    soft = rng.normal(0, 3, (40, 17)).astype(np.float32)
    kw = dict(weight=rng.uniform(0, 1, 40).astype(np.float32), avg_factor=13.0) if weighted \
        else {}
    jloss = JKD(loss_weight=0.25, T=10)
    jval, jgrad = jax.value_and_grad(lambda p: jloss(
        p, jnp.asarray(soft), **{k: jnp.asarray(v) for k, v in kw.items()}))(jnp.asarray(pred))
    p = T(pred).requires_grad_(True)
    val = KnowledgeDistillationKLDivLoss(loss_weight=0.25, T=10)(
        p, T(soft), **{k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    val.backward()
    assert float(val.detach()) > 0
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5, atol=1e-6 * np.abs(g).max())


def _jax_box_prob(ious, gtv, gtl, num_classes, t1):
    """``free_anchor_heads.py:51-60`` for one image: (G, K) IoUs -> (K, C)."""
    t2 = jnp.clip(jnp.max(ious, -1, keepdims=True), t1 + 1e-12)
    obj = jnp.clip((ious - t1) / (t2 - t1), 0.0, 1.0)
    obj = jnp.where(gtv[:, None], obj, 0.0)
    onehot = jax.nn.one_hot(gtl, num_classes)
    return jnp.max(obj[:, :, None] * onehot[:, None, :], axis=0)


def test_free_anchor_box_prob_equals_jax_dense_form():
    rng = np.random.RandomState(1)
    n, g, k, c = 2, 6, 300, 5
    ious = rng.uniform(0, 0.95, (n, g, k)).astype(np.float32)
    ious[0, 3] *= 0.5                                # best IoU below bbox_thr: all 0
    ious[1, 2, 7] = ious[1, 2].max()                 # a tie at the gt's best
    labels = np.array([[0, 2, 2, 4, 1, 0], [3, 3, 1, 0, 4, 2]])
    valid = np.ones((n, g), bool)
    valid[1, 5] = False
    got = box_prob(T(ious), T(valid), T(labels), c, 0.6).numpy()
    want = np.stack([np.asarray(_jax_box_prob(jnp.asarray(ious[i]), jnp.asarray(valid[i]),
                                              jnp.asarray(labels[i]), c, 0.6))
                     for i in range(n)])
    assert got.shape == (n, k, c) and (want > 0).sum() > 100
    np.testing.assert_array_equal(got, want)


class _RecordingJnp:
    """``jax.numpy`` that records, through ``jax.debug.callback``, each
    ``argmin`` taken over axis 0 (FSAF's per-gt level choice)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmin(self, a, axis=None, **kw):
        out = jnp.argmin(a, axis, **kw)
        if axis == 0:
            jax.debug.callback(lambda v: self.seen.append(np.asarray(v)), out)
        return out


def _fsaf_inputs():
    """Two 128x192 images' FSAF maps (16 channels, 4 classes; positive
    distances) and gts of 40-120 pixels (one padded)."""
    rng = np.random.RandomState(3)
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    cls = [rng.normal(0, 2, (2, h, w, 4)).astype(np.float32) for h, w in sizes]
    reg = [rng.uniform(0.2, 1.5, (2, h, w, 4)).astype(np.float32) for h, w in sizes]
    x1, y1 = rng.uniform(0, 80, (2, 5)), rng.uniform(0, 20, (2, 5))
    gt = np.stack([x1, y1, x1 + rng.uniform(40, 110, (2, 5)),
                   y1 + rng.uniform(40, 105, (2, 5))], -1).astype(np.float32)
    valid = np.ones((2, 5), bool)
    valid[1, 4] = False
    labels = rng.randint(0, 4, (2, 5)).astype(np.int32)
    return cls, reg, gt, valid, labels


def test_fsaf_selects_the_levels_jax_selects(monkeypatch):
    cls, reg, gt, valid, labels = _fsaf_inputs()
    jhead = jax_fovea_fsaf.FSAFHead(num_classes=4, in_channels=16, feat_channels=16,
                                    stacked_convs=1)
    seen = []
    monkeypatch.setattr(jax_fovea_fsaf, "jnp", _RecordingJnp(seen))
    jlosses = jax.jit(lambda *a: jhead.apply({}, *a, method=lambda m, *a: m.loss(*a)))(
        (cls, reg), jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(labels))
    jax.effects_barrier()
    want = np.concatenate([np.atleast_2d(s) for s in seen]).reshape(2, 5)

    head = build_from_cfg(dict(type="FSAFHead", num_classes=4, in_channels=16,
                               feat_channels=16, stacked_convs=1), HEADS, dict(device="cpu"))
    points, lvl = level_points([m.shape[1:3] for m in cls], head.strides)
    flat = lambda maps, a: torch.cat([T(m).reshape(2, -1, a) for m in maps], 1)  # noqa: E731
    strides = torch.tensor(head.strides, dtype=torch.float32)[lvl]
    ious = bbox_overlaps(distance2bbox(points, flat(reg, 4) * strides[:, None] * 4.0), T(gt))
    _, pos, ignored, _, sel = head.targets(points, lvl, flat(cls, 4), ious, T(gt),
                                           T(valid), T(labels))
    np.testing.assert_array_equal(sel.numpy(), want)
    assert len(set(sel[T(valid)].tolist())) >= 2          # gts select different levels
    assert pos.sum() > 0 and ignored.sum() > 0
    losses = head.loss(([T(m).permute(0, 3, 1, 2) for m in cls],
                        [T(m).permute(0, 3, 1, 2) for m in reg]), T(gt), T(valid), T(labels))
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(jlosses[k]), rtol=1e-5, err_msg=k)


def test_port_teacher_stays_while_jax_teacher_decays():
    model = cases.tiny_model("ld")
    det = build_detector(model, device="cpu")
    det.init_weights(torch.Generator().manual_seed(0))
    teacher = {k: v.clone() for k, v in det.teacher_model.state_dict().items()}
    student = {k: v.clone() for k, v in det.named_parameters() if not k.startswith("teacher")}
    opt = build_optimizer(det, dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4))
    in_opt = {id(p) for group in opt.param_groups for p in group["params"]}
    assert not in_opt & {id(p) for p in det.teacher_model.parameters()}
    assert in_opt == {id(p) for k, p in det.named_parameters() if not k.startswith("teacher")}
    b = cases.batch()
    batch = {k: T(v) for k, v in b.items()}
    batch["img"] = batch["img"].permute(0, 3, 1, 2).contiguous()
    step = make_train_step(det, opt, lambda t: 0.01)
    for _ in range(2):
        log = step(batch, torch.Generator())
        assert float(log["loss_ld"]) > 0
    for k, v in det.teacher_model.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    assert not det.teacher_model.training
    moved = [k for k, p in det.named_parameters() if k in student
             and not torch.equal(p.detach(), student[k])]
    assert len(moved) == len(student)

    jdet = jax_build_detector(model)
    shapes = jax.eval_shape(lambda r, x: jdet.init(
        r, x, method=lambda m, x: (m.head(m.extract_feat(x)),
                                   m.teacher.head(m.teacher.extract_feat(x)))),
        jax.random.PRNGKey(0), jnp.asarray(b["img"]))
    params = cases.randomize(shapes["params"], 6)
    tx = jax_build_optimizer(params, dict(type="SGD", lr=0.01, momentum=0.9,
                                          weight_decay=1e-4), lambda t: 0.01, model_cfg=model)
    after = jax.jit(lambda p: optax.apply_updates(p, tx.update(
        jax.tree_util.tree_map(jnp.zeros_like, p), tx.init(p), p)[0]))(params)
    leaves = jax.tree_util.tree_leaves_with_path(params["teacher"])
    new = dict(jax.tree_util.tree_leaves_with_path(after["teacher"]))
    assert len(leaves) > 50
    for path, v in leaves:
        moved = np.asarray(new[path]) != v
        assert moved[v != 0].all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(new[path]), v * (1 - 0.01 * 1e-4), rtol=1e-6)


@pytest.mark.parametrize("name", ["fovea", "fsaf"])
def test_fovea_and_fsaf_classifier_bias_starts_at_zero_as_in_jax(name):
    """JAX's FoveaBox and FSAF heads start ``conv_cls``'s bias at flax's 0,
    where mmdet starts it at the 0.01 prior (ROADMAP C); the port's seeded
    init keeps JAX's."""
    cls = {"fovea": jax_fovea_fsaf.FoveaHead, "fsaf": jax_fovea_fsaf.FSAFHead}[name]
    jhead = cls(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1)
    feats = [jnp.ones((1, s, s, 8)) for s in (8, 4, 2, 1, 1)]
    conv_cls = jhead.init(jax.random.PRNGKey(0), feats)["params"]["conv_cls"]
    jbias = np.asarray(next(v for k, v in jax.tree_util.tree_leaves_with_path(conv_cls)
                            if "bias" in jax.tree_util.keystr(k)))
    model = cases.tiny_model(name)
    det = build_detector(model, device="cpu")
    det.init_weights(torch.Generator().manual_seed(0))
    assert jbias.shape == (4,) and not jbias.any()
    assert not det.bbox_head.conv_cls.bias.detach().any()
