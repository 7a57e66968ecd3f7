"""Parity of the port's components with the JAX package, on the CPU.

Inputs are made with numpy from a seed and given to both sides in float32.
Anchors are compared exactly; the coder, overlaps and NMS outputs within
1e-6 (NMS keep sets, labels and validity exactly); ResNet and FPN within
rtol=1e-4, atol=1e-5, since the two frameworks sum a convolution in
different orders. Weights go from the JAX modules to the port through
``jax_variables_to_state_dict``, with frozen-BN statistics randomized so
that BN is exercised.
"""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from oadg_tpu.core.anchor.anchor_generator import AnchorGenerator as JAnchors
from oadg_tpu.core.bbox.coder import DeltaXYWHBBoxCoder as JCoder
from oadg_tpu.core.bbox.geometry import bbox_overlaps as j_overlaps
from oadg_tpu.core.post_processing.nms import (multiclass_nms as j_multiclass_nms,
                                               nms_numpy, nms_padded as j_nms)
from oadg_tpu.models.backbones.resnet import (Bottleneck as JBottleneck,
                                              ResNet as JResNet, conv_norm)
from oadg_tpu.models.layers import build_norm, max_pool_3x3_s2, norm_eval_cfg
from oadg_tpu.models.necks.fpn import FPN as JFPN
from oadg_tpu_torch.core.anchor import AnchorGenerator
from oadg_tpu_torch.core.bbox import DeltaXYWHBBoxCoder, bbox_overlaps
from oadg_tpu_torch.core.post_processing import multiclass_nms, nms_padded
from oadg_tpu_torch.models.backbones import ResNet
from oadg_tpu_torch.models.necks import FPN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)
T = torch.from_numpy


def _boxes(rng, n, size=200.0, min_wh=4.0, max_wh=80.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_anchor_generator_exact():
    kw = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0], scales=[8])
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    want = JAnchors(**kw).grid_priors(sizes)
    got = AnchorGenerator(**kw).grid_priors(sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_coder_decode_and_encode():
    rng = np.random.RandomState(0)
    anchors = _boxes(rng, 500, size=300)
    deltas = rng.normal(0, 1.5, (500, 4)).astype(np.float32)   # some clip
    for means, stds in (((0., 0., 0., 0.), (1., 1., 1., 1.)),
                        ((0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2))):
        jc, tc = JCoder(means, stds), DeltaXYWHBBoxCoder(means, stds)
        want = jc.decode(jnp.asarray(anchors), jnp.asarray(deltas),
                         max_shape=(240.0, 320.0))
        got = tc.decode(T(anchors), T(deltas), max_shape=(240.0, 320.0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * 320)
        gt = _boxes(rng, 500, size=300)
        np.testing.assert_allclose(tc.encode(T(anchors), T(gt)).numpy(),
                                   np.asarray(jc.encode(jnp.asarray(anchors),
                                                        jnp.asarray(gt))),
                                   rtol=1e-6, atol=1e-6)


def test_bbox_overlaps():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 60), _boxes(rng, 70)
    a[3] = [5, 5, 5, 5]                                        # empty box
    want = j_overlaps(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(bbox_overlaps(T(a), T(b)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,thr", [(40, 0.5), (300, 0.7), (600, 0.3)])
def test_nms_padded_keep_set(n, thr):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, n, size=150)                # dense, long chains
    scores = rng.permutation(n).astype(np.float32) / n
    valid = rng.rand(n) > 0.1
    want = np.asarray(j_nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                            jnp.asarray(valid)))
    got = nms_padded(T(boxes), T(scores), thr, T(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    idx = np.flatnonzero(valid)                      # the sequential greedy
    ref = idx[nms_numpy(boxes[idx], scores[idx], thr)]
    assert set(np.flatnonzero(got)) == set(ref)


def test_nms_padded_batched_over_leading_dims():
    rng = np.random.RandomState(3)
    boxes = np.stack([_boxes(rng, 80, size=120) for _ in range(6)]).reshape(2, 3, 80, 4)
    scores = rng.rand(2, 3, 80).astype(np.float32)
    valid = rng.rand(2, 3, 80) > 0.2
    got = nms_padded(T(boxes), T(scores), 0.6, T(valid)).numpy()
    for i in range(2):
        for j in range(3):
            want = j_nms(jnp.asarray(boxes[i, j]), jnp.asarray(scores[i, j]),
                         0.6, jnp.asarray(valid[i, j]))
            np.testing.assert_array_equal(got[i, j], np.asarray(want))


def test_multiclass_nms():
    rng = np.random.RandomState(4)
    n, c = 50, 8
    boxes = np.stack([_boxes(rng, n, size=100) for _ in range(c)], 1).reshape(n, c * 4)
    logits = rng.normal(0, 2, (n, c + 1)).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    scores[rng.rand(n) > 0.8] = 0.0                  # padded proposals
    jd, jl, jv = j_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.05, 0.5, 150, c)
    td, tl, tv = multiclass_nms(T(boxes)[None], T(scores)[None], 0.05, 0.5, 150, c)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    np.testing.assert_allclose(td[0].numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert 30 < int(tv.sum()) < 150


def _randomize_bn(variables, seed):
    """Random frozen-BN scale/bias/mean/var in a JAX variable tree."""
    rng = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k in params:
            if k.startswith("FrozenBN") or k == "downsample_bn":
                c = params[k]["scale"].shape
                params[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                params[k]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(params[k], dict):
                walk(params[k], stats.get(k, {}))

    walk(out["params"], out.get("batch_stats", {}))
    return out


def _load_port(module, jax_vars, scope, prefix):
    sd = jax_variables_to_state_dict(
        {c: {scope: jax_vars[c]} for c in ("params", "batch_stats") if c in jax_vars})
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _compare_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w), rtol=1e-4, atol=1e-5)


def test_fpn_parity():
    rng = np.random.RandomState(5)
    chans = [16, 32, 64, 128]
    # odd sizes exercise the repeat-and-crop upsampling
    sizes = [(33, 47), (17, 24), (9, 12), (5, 6)]      # stride-2 conv sizes
    xs = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
          for (h, w), c in zip(sizes, chans)]
    jfpn = JFPN(in_channels=chans, out_channels=16, num_outs=5)
    jv = jax.jit(jfpn.init)(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])
    want = jax.jit(jfpn.apply)(jv, [jnp.asarray(x) for x in xs])
    port = _load_port(FPN(in_channels=chans, out_channels=16, num_outs=5),
                      jv, "neck_m", "neck.")
    with torch.no_grad():
        got = port([T(x).permute(0, 3, 1, 2) for x in xs])
    _compare_outputs(got, want)


def test_resnet18_basic_block_parity():
    rng = np.random.RandomState(6)
    x = rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    kw = dict(depth=18, base_channels=16, stem_channels=16)
    jnet = JResNet(**kw)
    jv = _randomize_bn(jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 7)
    want = jax.jit(jnet.apply)(jv, jnp.asarray(x))
    port = _load_port(ResNet(**kw), jv, "backbone_m", "backbone.")
    with torch.no_grad():
        got = port(T(x).permute(0, 3, 1, 2))
    _compare_outputs(got, want)


class _OneBlockBottleneckResNet(fnn.Module):
    """The JAX ResNet's stem and stages (resnet.py:147-193) with one
    Bottleneck per stage."""
    base: int = 16

    @fnn.compact
    def __call__(self, x):
        norm = build_norm(norm_eval_cfg(None, True))
        x = max_pool_3x3_s2(fnn.relu(conv_norm(x, self.base, 7, 2, 3, norm,
                                               None, "conv1")))
        outs = []
        for i, stride in enumerate((1, 2, 2, 2)):
            x = JBottleneck(self.base * 2 ** i, stride, 1, True, "pytorch",
                            norm_eval_cfg(None, True), name=f"layer{i + 1}_0")(x)
            outs.append(x)
        return tuple(outs)


def test_resnet_bottleneck_parity():
    rng = np.random.RandomState(8)
    x = rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    jnet = _OneBlockBottleneckResNet()
    jv = _randomize_bn(jax.jit(jnet.init)(jax.random.PRNGKey(2), jnp.asarray(x)), 9)
    want = jax.jit(jnet.apply)(jv, jnp.asarray(x))
    port = ResNet(depth=50, base_channels=16, stem_channels=16)
    for name in port.res_layers:               # keep block 0 of each stage
        setattr(port, name, torch.nn.Sequential(getattr(port, name)[0]))
    port = _load_port(port, jv, "backbone_m", "backbone.")
    with torch.no_grad():
        got = port(T(x).permute(0, 3, 1, 2))
    _compare_outputs(got, want)
