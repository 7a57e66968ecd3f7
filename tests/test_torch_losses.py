"""The port's OA-Loss (oadg_tpu_torch/models/losses) against the JAX package.

Each loss gets the same seeded numpy inputs on both sides; its value and its
gradient with respect to the predictions (``torch.autograd`` against
``jax.grad``) agree to rtol=1e-5 (float32 elementwise math and sums in
another order). Inputs are views-major with 2 views, as the flagship
config's losses take them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.models.losses import oadg as jax_oadg
from oadg_tpu_torch.models.losses import oadg as port_oadg

RTOL = 1e-5


def _compare(jax_fn, port_fn, x, *args):
    """Value and d/dx of ``fn(x, *args)`` on both sides."""
    jval, jgrad = jax.value_and_grad(lambda v: jax_fn(v, *[jnp.asarray(a) for a in args]))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = port_fn(tx, *[torch.from_numpy(np.asarray(a)) for a in args])
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jgrad)).max())
    return float(tval.detach())


def _labels_weights(rng, rows, num_classes):
    labels = rng.randint(0, num_classes + 1, rows).astype(np.int32)
    weights = (rng.rand(rows) > 0.2).astype(np.float32)
    return labels, weights


@pytest.mark.parametrize("sigmoid", [True, False], ids=["sigmoid", "softmax"])
def test_cross_entropy_plus_with_jsd(sigmoid):
    rng = np.random.RandomState(0)
    nc = 1 if sigmoid else 9
    rows = 2 * 40
    logits = rng.normal(0, 2, (rows, nc)).astype(np.float32)
    labels, weights = _labels_weights(rng, rows, 1 if sigmoid else 8)
    cfg = dict(use_sigmoid=sigmoid, num_views=2, additional_loss="jsdv1_3_2aug",
               lambda_weight=0.1 if sigmoid else 10.0)
    jl, tl = jax_oadg.CrossEntropyLossPlus(**cfg), port_oadg.CrossEntropyLossPlus(**cfg)
    af = float(weights.sum())
    val = _compare(lambda x, l, w: jl(x, l, w, avg_factor=af),
                   lambda x, l, w: tl(x, l.long(), w, avg_factor=af),
                   logits, labels, weights)
    assert val > 0


def test_jsd_consistency_alone():
    rng = np.random.RandomState(1)
    x = rng.normal(0, 3, (2 * 30, 9)).astype(np.float32)
    _compare(lambda v: jax_oadg.jsd_consistency(v, 2, 17.0),
             lambda v: port_oadg.jsd_consistency(v, 2, 17.0), x)


@pytest.mark.parametrize("name", ["SmoothL1LossPlus", "L1LossPlus"])
def test_regression_plus(name):
    rng = np.random.RandomState(2)
    pred = rng.normal(0, 1.5, (2 * 50, 4)).astype(np.float32)
    target = rng.normal(0, 1.5, (2 * 50, 4)).astype(np.float32)
    weight = np.repeat((rng.rand(2 * 50, 1) > 0.5), 4, 1).astype(np.float32)
    jl = getattr(jax_oadg, name)(num_views=2, loss_weight=1.0)
    tl = getattr(port_oadg, name)(num_views=2, loss_weight=1.0)
    assert _compare(lambda p, t, w: jl(p, t, w, avg_factor=100.0),
                    lambda p, t, w: tl(p, t, w, avg_factor=100.0),
                    pred, target, weight) > 0


def _cont_inputs(rng, r, p, num_fg, num_valid_rand=None):
    n = 2 * r + 2 * p
    feats = rng.normal(0, 1, (n, 16)).astype(np.float32)
    labels = np.full(n, 8, np.int32)                       # background
    fg = rng.choice(r, num_fg, replace=False)
    labels[fg] = rng.randint(0, 8, num_fg)
    labels[r:2 * r] = labels[:r]                           # same sample, view 2
    valid = np.ones(n, bool)
    valid[r - 2:r] = valid[2 * r - 2:2 * r] = False        # padded roi rows
    if num_valid_rand is not None:
        valid[2 * r + num_valid_rand:2 * r + p] = False
    return feats, labels, valid


@pytest.mark.parametrize("case", ["with_random_rows", "without_random_rows",
                                  "below_min_samples"])
def test_supcontrast(case):
    rng = np.random.RandomState(3)
    r, p = 24, (6 if case == "with_random_rows" else 0)
    num_fg = 4 if case == "below_min_samples" else 9      # x 2 views
    feats, labels, valid = _cont_inputs(rng, r, p, num_fg,
                                        num_valid_rand=4 if p else None)
    layout = (r, 2, p)
    val = _compare(lambda f, l, v: jax_oadg.supcontrast(f, l, v, layout, 0.06, 10),
                   lambda f, l, v: port_oadg.supcontrast(f, l, v, layout, 0.06, 10),
                   feats, labels, valid)
    if case == "below_min_samples":
        assert val == 0.0
    else:
        assert val > 0


def test_contrastive_loss_plus_weight():
    rng = np.random.RandomState(4)
    feats, labels, valid = _cont_inputs(rng, 20, 5, 8)
    cfg = dict(loss_weight=0.01, temperature=0.06, num_views=2)
    jl, tl = jax_oadg.ContrastiveLossPlus(**cfg), port_oadg.ContrastiveLossPlus(**cfg)
    _compare(lambda f, l, v: jl(f, l, v, (20, 2, 5)),
             lambda f, l, v: tl(f, l, v, (20, 2, 5)), feats, labels, valid)


# The plain Faster R-CNN's losses (oadg_tpu_torch/models/losses/common.py).

def _plain(name, **cfg):
    from oadg_tpu.models.losses import common as jax_common
    from oadg_tpu_torch.models.losses import common as port_common
    return getattr(jax_common, name)(**cfg), getattr(port_common, name)(**cfg)


_REDUCTIONS = [dict(), dict(reduction_override="sum"), dict(avg_factor=37.0),
               dict(reduction_override="none")]
_RED_IDS = ["mean", "sum", "avg_factor", "none"]


def _compare_any(jax_fn, port_fn, x, *args):
    """``_compare`` for losses that may return an unreduced tensor (summed
    for the gradient, compared elementwise)."""
    jx = jnp.asarray(x)
    jout = jax_fn(jx, *[jnp.asarray(a) for a in args])
    jgrad = jax.grad(lambda v: jnp.sum(jax_fn(v, *[jnp.asarray(a) for a in args])))(jx)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = port_fn(tx, *[torch.from_numpy(np.asarray(a)) for a in args])
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=RTOL,
                               atol=RTOL * max(np.abs(np.asarray(jout)).max(), 1e-30))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jgrad)).max())


@pytest.mark.parametrize("red", _REDUCTIONS, ids=_RED_IDS)
@pytest.mark.parametrize("mode", ["softmax", "softmax_ignore", "sigmoid_onehot",
                                  "sigmoid_onehot_ignore", "sigmoid_elementwise"])
def test_cross_entropy_loss_equals_jax(mode, red):
    """Softmax CE with and without ``ignore_index``; sigmoid BCE on one-hot
    targets (labels one past the classes give an all-zero row, ignored and
    negative labels a weight of 0) and elementwise; weights, ``avg_factor``
    and ``reduction_override``."""
    rng = np.random.RandomState(5)
    rows, nc = 60, 8
    weights = ((rng.rand(rows) > 0.2) * rng.uniform(0.5, 2, rows)).astype(np.float32)
    cfg = dict(loss_weight=1.7)
    if mode.startswith("softmax"):
        logits = rng.normal(0, 2, (rows, nc + 1)).astype(np.float32)
        labels = rng.randint(0, nc + 1, rows).astype(np.int32)
    elif mode.startswith("sigmoid_onehot"):
        cfg["use_sigmoid"] = True
        logits = rng.normal(0, 2, (rows, nc)).astype(np.float32)
        labels = rng.randint(-1, nc + 1, rows).astype(np.int32)
    else:
        cfg["use_sigmoid"] = True
        logits = rng.normal(0, 2, (rows, nc)).astype(np.float32)
        labels = (rng.rand(rows, nc) > 0.7).astype(np.float32)
        weights = np.repeat(weights[:, None], nc, 1)
    if mode.endswith("ignore"):
        cfg["ignore_index"] = 3
        labels[::7] = 3
    jl, tl = _plain("CrossEntropyLoss", **cfg)
    _compare_any(lambda x, l, w: jl(x, l, w, **red),
                 lambda x, l, w: tl(x, l if mode == "sigmoid_elementwise" else l.long(), w, **red),
                 logits, labels, weights)


@pytest.mark.parametrize("red", _REDUCTIONS, ids=_RED_IDS)
@pytest.mark.parametrize("name", ["SmoothL1Loss", "L1Loss"])
def test_regression_losses_equal_jax(name, red):
    rng = np.random.RandomState(6)
    pred = rng.normal(0, 1.5, (50, 4)).astype(np.float32)
    target = rng.normal(0, 1.5, (50, 4)).astype(np.float32)
    weight = np.repeat((rng.rand(50, 1) > 0.5), 4, 1).astype(np.float32)
    cfg = dict(loss_weight=2.0, **(dict(beta=0.7) if name == "SmoothL1Loss" else {}))
    jl, tl = _plain(name, **cfg)
    _compare_any(lambda p, t, w: jl(p, t, w, **red), lambda p, t, w: tl(p, t, w, **red),
                 pred, target, weight)


def test_rpn_shaped_cross_entropy_unweighted_mean():
    """The RPN's call: one sigmoid logit a row, foreground label 0 and
    background 1; without a weight the mean runs over every element."""
    rng = np.random.RandomState(7)
    logits = rng.normal(0, 2, (40, 1)).astype(np.float32)
    labels = rng.randint(0, 2, 40).astype(np.int32)
    jl, tl = _plain("CrossEntropyLoss", use_sigmoid=True)
    _compare(lambda x, l: jl(x, l), lambda x, l: tl(x, l.long()), logits, labels)
