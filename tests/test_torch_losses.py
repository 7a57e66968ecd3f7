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
