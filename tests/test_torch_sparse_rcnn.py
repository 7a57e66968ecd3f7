"""Sparse R-CNN and QueryInst in the port against the JAX package, on the CPU.

The Hungarian matcher (``core/bbox/hungarian.py``): the port's scipy path
gives JAX's ``_lsa_host`` assignment on seeded costs (exactly), its cost
matrix is JAX's (1e-5 of the largest finite cost), and the port's
``auction_assign`` gives JAX's assignment (exactly) within ``n_valid * eps``
of scipy's total. ``DIIHead`` and ``_apply_deltas`` with JAX's weights; a
2-stage ``SparseRoIHead`` of the config made narrow (16 channels, 4 heads,
P = 20, 8 classes) on seeded FPN maps of two 64x96 images: its losses and
gradients, with the port's matcher replaying JAX's assignments (the
costs held to JAX's, and the port's own scipy assignment equal to JAX's);
``simple_test``'s top-k; then the whole tiny detector (R18-FPN of 16
channels) through ``forward_train`` and ``simple_test``, and QueryInst
beside it.

Tolerances: float32 outputs and gradients within 1e-4 of the largest
magnitude, losses within 1e-5 relative, scores within 1e-5; assignments
exact.
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oadg_tpu.core.bbox.hungarian as jhung
from oadg_tpu.config import Config
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.roi_heads.sparse_roi_head import DIIHead as JaxDII
from oadg_tpu.models.roi_heads.sparse_roi_head import _apply_deltas as jax_apply_deltas
import oadg_tpu_torch.core.bbox.hungarian as thung
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.roi_heads.sparse_roi_head import DIIHead, apply_deltas
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict, load_mmdet_checkpoint
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/sparse_rcnn/sparse_rcnn_r50_fpn_1x_coco.py"
C, P, N, G, NC = 16, 20, 2, 4, 8
H, W = 64, 96
SHAPES = np.array([[64, 96], [60, 90]], np.float32)     # image 1 smaller than its canvas
KEY = jax.random.PRNGKey(5)


def _model(package):
    path = os.path.join(ROOT, CONFIG)
    m = (Config.fromfile(path, import_custom_modules=False)["model"] if package == "jax"
         else load_config(path)["model"])
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=C)
    m["rpn_head"].update(num_proposals=P, proposal_feature_channel=C)
    rh = m["roi_head"]
    rh.update(num_stages=2, stage_loss_weights=[1.0, 0.5], proposal_feature_channel=C)
    rh["bbox_head"].update(num_classes=NC, feat_channels=C, dim_feedforward=32, num_heads=4,
                           dynamic_dim=8)
    m["test_cfg"] = dict(max_per_img=10)
    return m


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (N, H >> (2 + i), W >> (2 + i), C)).astype(np.float32)
             for i in range(4)]
    xy = rng.uniform(0, 50, (N, G, 2))
    gt = np.concatenate([xy, np.minimum(xy + rng.uniform(10, 36, (N, G, 2)), [88, 58])], -1)
    gt = gt.astype(np.float32)
    gt_valid = np.ones((N, G), bool)
    gt_valid[1, -1] = False
    gt[1, -1] = 0
    labels = rng.randint(0, NC, (N, G)).astype(np.int32)
    cxcy = rng.uniform(0.25, 0.75, (P, 2))
    wh = rng.uniform(0.15, 0.6, (P, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    pf = rng.normal(0, 1, (P, C)).astype(np.float32)
    return dict(feats=feats, gt=gt, gt_valid=gt_valid, labels=labels, boxes=boxes, pf=pf)


def _proposals(case):
    """The embedding head's output for ``case``'s parameters: absolute xyxy
    boxes at each image's ``img_shape`` and the tiled features."""
    b = case["boxes"]
    xyxy = np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], -1)
    whwh = np.stack([SHAPES[:, 1], SHAPES[:, 0], SHAPES[:, 1], SHAPES[:, 0]], -1)
    props = (xyxy[None] * whwh[:, None]).astype(np.float32)
    return props, np.tile(case["pf"][None], (N, 1, 1))


def _randomize(tree, seed=1):
    """Seeded values for every JAX leaf: LeCun-normal kernels by fan-in,
    LayerNorm / GroupNorm scales near 1, small biases."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            parent = str(getattr(path[-2], "key", path[-2]))
            # the attention's q, k, v kernels are (E, heads, D): fan-in E
            fan_in = x.shape[0] if parent in ("query", "key", "value") else int(
                np.prod(x.shape[:-1]))
            return jnp.asarray(rng.normal(0, 1 / np.sqrt(fan_in), x.shape).astype(np.float32))
        if name == "scale":
            return jnp.asarray((1 + rng.normal(0, 0.1, x.shape)).astype(np.float32))
        if name == "init_proposal_bboxes":
            return jnp.asarray(np.concatenate([rng.uniform(0.25, 0.75, (x.shape[0], 2)),
                                               rng.uniform(0.15, 0.6, (x.shape[0], 2))], -1)
                               .astype(np.float32))
        if name == "init_proposal_features":
            return jnp.asarray(rng.normal(0, 1, x.shape).astype(np.float32))
        if name in ("mean",):
            return jnp.zeros(x.shape, jnp.float32)
        if name in ("var",):
            return jnp.ones(x.shape, jnp.float32)
        return jnp.asarray(rng.normal(0, 0.05, x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _port_state(params, prefix="roi_head."):
    sd = jax_variables_to_state_dict({"params": {"roi": jax.tree_util.tree_map(
        np.asarray, params)}})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _close(got, want, rel=1e-4, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=err_msg)


# ------------------------------------------------------------ the matcher ----

@pytest.mark.parametrize("q,g,n_valid", [(20, 4, 4), (20, 6, 3), (100, 12, 12), (30, 5, 0)])
def test_lsa_host_equals_jax(q, g, n_valid):
    """The host matcher on seeded costs (padded gts at 1e6, cut by the
    count): the same assignment as JAX's ``_lsa_host``."""
    rng = np.random.RandomState(q + g + n_valid)
    cost = (rng.randn(q, g) * 3).astype(np.float32)
    cost[:, n_valid:] = 1e6
    want = jhung._lsa_host(cost, np.int32(n_valid))
    got = thung.lsa_host(cost, n_valid)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() == n_valid


@pytest.mark.parametrize("q,g,n_valid,seed", [(10, 8, 5, 0), (30, 16, 16, 1), (50, 12, 7, 2),
                                              (20, 6, 6, 3)])
def test_auction_assign_equals_jax(q, g, n_valid, seed):
    """``auction_assign`` in plain tensor ops: JAX's assignment on seeded
    DETR-like costs, and a total within ``n_valid * eps`` of scipy's."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.RandomState(seed)
    cost = (-rng.rand(q, g) + 5 * rng.rand(q, g) + 2 * (2 * rng.rand(q, g) - 1)).astype(np.float32)
    valid = np.zeros(g, bool)
    valid[:n_valid] = True
    want = np.asarray(jhung.auction_assign(jnp.asarray(cost), jnp.asarray(valid)))
    got = thung.auction_assign(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    rows = np.nonzero(got)[0]
    assert len(rows) == n_valid and len(set(got[rows])) == n_valid
    r, c = linear_sum_assignment(cost[:, :n_valid].astype(np.float64))
    eps = 2e-4 * max(np.abs(cost[:, :n_valid]).max(), 1e-3)
    assert cost[rows, got[rows] - 1].sum() <= cost[r, c].sum() + n_valid * eps + 1e-5


def test_auction_assign_no_valid_gts():
    cost = torch.from_numpy(np.random.RandomState(0).randn(12, 5).astype(np.float32))
    assert not thung.auction_assign(cost, torch.zeros(5, dtype=torch.bool)).any()


def test_hungarian_cost_matches_jax():
    """The (B, Q, G) cost of seeded probabilities and boxes: JAX's
    ``assign`` cost per image (its padded gts at 1e6)."""
    case = _inputs(2)
    rng = np.random.RandomState(3)
    prob = rng.uniform(0, 1, (N, P, NC + 1)).astype(np.float32)
    bnorm = np.concatenate([rng.uniform(0.2, 0.8, (N, P, 2)), rng.uniform(0.1, 0.5, (N, P, 2))],
                           -1).astype(np.float32)
    factor = np.stack([SHAPES[:, 1], SHAPES[:, 0], SHAPES[:, 1], SHAPES[:, 0]], -1)
    seen = []
    real = jhung._lsa_host

    def record(cost, nv):
        seen.append(np.array(cost))
        return real(cost, nv)

    mp = pytest.MonkeyPatch()
    mp.setattr(jhung, "_lsa_host", record)
    try:
        jm = jhung.HungarianAssigner(cls_cost=dict(weight=2.0), reg_cost=dict(weight=5.0),
                                     iou_cost=dict(weight=2.0))
        want = [np.asarray(jm.assign(jnp.asarray(prob[i]), jnp.asarray(bnorm[i]),
                                     jnp.asarray(case["gt"][i]), jnp.asarray(case["gt_valid"][i]),
                                     jnp.asarray(case["labels"][i]), tuple(SHAPES[i])))
                for i in range(N)]
    finally:
        mp.undo()
    tm = thung.HungarianAssigner(cls_cost=dict(weight=2.0), reg_cost=dict(weight=5.0),
                                 iou_cost=dict(weight=2.0))
    args = (torch.from_numpy(prob), torch.from_numpy(bnorm), torch.from_numpy(case["gt"]),
            torch.from_numpy(case["gt_valid"]), torch.from_numpy(case["labels"]),
            torch.from_numpy(factor))
    cost = tm.cost(*args).numpy()
    for i in range(N):
        finite = cost[i] < 1e5
        np.testing.assert_array_equal(finite, seen[i] < 1e5)
        _close(cost[i][finite], seen[i][finite], 1e-5)
    np.testing.assert_array_equal(tm.assign(*args).numpy(), np.stack(want))


# ------------------------------------------------------ DII and the deltas ----

def test_dii_head_matches_jax():
    rng = np.random.RandomState(4)
    rf = rng.normal(0, 1, (N, P, 7, 7, C)).astype(np.float32)
    pf = rng.normal(0, 1, (N, P, C)).astype(np.float32)
    jhead = JaxDII(num_classes=NC, feat_channels=C, dim_feedforward=32, num_heads=4,
                   dynamic_dim=8)
    params = _randomize(jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), rf, pf))["params"])
    want = jax.jit(lambda p: jhead.apply({"params": p}, rf, pf))(params)
    head = DIIHead(num_classes=NC, feat_channels=C, dim_feedforward=32, num_heads=4,
                   dynamic_dim=8, device="cpu")
    sd = _port_state({"dii0": params}, "roi_head.bbox_head.0.")
    head.load_state_dict(sd, strict=True)
    assert sd["attention.attn.in_proj_weight"].shape == (3 * C, C)
    with torch.no_grad():
        got = head(torch.from_numpy(rf).reshape(N * P, 7, 7, C).permute(0, 3, 1, 2),
                   torch.from_numpy(pf))
    for g, w, name in zip(got, want, ("cls", "delta", "features")):
        _close(g.numpy(), w, err_msg=name)


def test_apply_deltas_matches_jax():
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 50, (N, P, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (N, P, 2))], -1).astype(np.float32)
    deltas = rng.normal(0, 3, (N, P, 4)).astype(np.float32)     # some beyond the +-4 clip
    assert (np.abs(deltas[..., 2:]) > 4).any()
    want = np.asarray(jax_apply_deltas(jnp.asarray(boxes), jnp.asarray(deltas)))
    got = apply_deltas(torch.from_numpy(boxes), torch.from_numpy(deltas)).numpy()
    _close(got, want, 1e-6)


# ---------------------------------------------------- the 2-stage RoI head ----

def _jax_head(model):
    from oadg_tpu.utils.registry import HEADS, build_from_cfg
    import oadg_tpu.models  # noqa: F401
    return build_from_cfg(dict(dict(model["roi_head"]), train_cfg=None, test_cfg=model["test_cfg"],
                               num_views=1), HEADS)


def _port_head(model):
    from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg
    return build_from_cfg(dict(model["roi_head"], train_cfg=None, test_cfg=model["test_cfg"],
                               num_views=1), HEADS, dict(device="cpu"))


@pytest.fixture(scope="module")
def head_run():
    case = _inputs(0)
    props, pf = _proposals(case)
    jhead = _jax_head(_model("jax"))
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(props), None, jnp.asarray(case["gt"]), jnp.asarray(case["gt_valid"]),
            jnp.asarray(case["labels"]), KEY)
    kw = dict(prop_feats=jnp.asarray(pf), img_shapes=jnp.asarray(SHAPES))
    seen = []
    real = jhung._lsa_host

    def record(cost, nv):
        out = np.asarray(real(cost, nv))
        seen.append((np.array(cost), int(nv), out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jhung, "_lsa_host", record)
    try:
        params = _randomize(jax.eval_shape(
            lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss", **kw))["params"])
        seen.clear()

        def loss_fn(p, feats):
            losses = jhead.apply({"params": p}, feats, *args, method="loss", **kw)
            return sum(losses.values()), losses

        def both(p, feats):                     # one trace of the loss and the test path
            return (jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(p, feats),
                    jhead.apply({"params": p}, feats, jnp.asarray(props), None,
                                jnp.asarray(SHAPES), jnp.ones((N, 4)),
                                prop_feats=jnp.asarray(pf), method="simple_test"))

        ((_, jlosses), jgrads), jtest = jax.jit(both)(params, jf)
        jax.block_until_ready(jgrads)
    finally:
        mp.undo()

    head = _port_head(_model("torch"))
    head.load_state_dict(_port_state(params), strict=True)
    feats = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
             for f in case["feats"]]
    calls = []
    own_lsa = thung.lsa_host

    def replay(cost, nv):
        """JAX's assignment of the recorded cost nearest to the port's; the
        port's own assignment of its cost kept beside it."""
        dist = [np.abs(c - cost).max() if c.shape == cost.shape and n == nv else np.inf
                for c, n, _ in seen]
        i = int(np.argmin(dist))
        calls.append((dist[i], np.abs(cost[cost < 1e5]).max(), own_lsa(cost, nv), seen[i][2]))
        return seen[i][2]

    mp = pytest.MonkeyPatch()
    mp.setattr(thung, "lsa_host", replay)
    try:
        tprops = torch.from_numpy(props)
        losses = head.loss(feats, tprops, None, torch.from_numpy(case["gt"]),
                           torch.from_numpy(case["gt_valid"]), torch.from_numpy(case["labels"]),
                           UniformDraws(), prop_feats=torch.from_numpy(pf),
                           img_shapes=torch.from_numpy(SHAPES))
    finally:
        mp.undo()
    sum(losses.values()).backward()
    with torch.no_grad():
        ttest = head.simple_test([f.detach() for f in feats], tprops, None,
                                 torch.from_numpy(SHAPES), torch.ones(N, 4),
                                 prop_feats=torch.from_numpy(pf))
    return dict(jlosses=jlosses, jgrads=jgrads, losses=losses, head=head, feats=feats,
                calls=calls, seen=seen, jtest=jtest, ttest=ttest, params=params)


def test_sparse_head_assignments_equal_jax(head_run):
    """Each stage and image: the port's cost within 1e-5 of the largest of
    JAX's, and the port's own scipy assignment of it equal to JAX's."""
    calls = head_run["calls"]
    assert len(calls) == len(head_run["seen"]) == 2 * N
    for dist, scale, own, want in calls:
        assert dist <= 1e-5 * scale
        np.testing.assert_array_equal(own, want)
        assert (want > 0).sum() in (G, G - 1)


@pytest.mark.parametrize("key", [f"s{k}.loss_{n}" for k in range(2) for n in ("cls", "bbox", "iou")])
def test_sparse_head_losses_match_jax(head_run, key):
    assert set(head_run["losses"]) == set(head_run["jlosses"])
    want, got = float(head_run["jlosses"][key]), head_run["losses"][key].item()
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    assert got > 0


def test_sparse_head_gradients_match_jax(head_run):
    want = _port_state(head_run["jgrads"][0])
    named = dict(head_run["head"].named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, name
        _close(p.grad.numpy(), w, err_msg=name)
    for i, (f, jg) in enumerate(zip(head_run["feats"], head_run["jgrads"][1])):
        _close(f.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2), err_msg=f"level {i}")


def test_sparse_head_simple_test_matches_jax(head_run):
    """The flat top-k of P x C sigmoid scores: the same queries' boxes, the
    same classes, the scores within 1e-5; no NMS."""
    jd, jl, jv = (np.asarray(x) for x in head_run["jtest"])
    td, tl, tv = (x.numpy() for x in head_run["ttest"])
    assert td.shape == (N, 10, 5) and tv.all() and jv.all()
    np.testing.assert_array_equal(tl, jl)
    _close(td[..., :4], jd[..., :4])
    np.testing.assert_allclose(td[..., 4], jd[..., 4], rtol=0, atol=1e-5)
    assert (np.diff(td[..., 4], axis=1) <= 0).all()


def test_simple_test_ties_go_to_the_lower_index():
    """``jax.lax.top_k``'s order on tied scores, which the port's flat top-k
    keeps (a stable descending sort)."""
    from oadg_tpu_torch.core.post_processing.nms import sort_desc
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 4)[1])
    np.testing.assert_array_equal(sort_desc(torch.from_numpy(x), 4)[1].numpy(), want)


def test_sparse_weight_map_uses_mmdet_names(head_run):
    """The JAX leaves map to mmdet's ``DIIHead`` keys: the query, key and
    value kernels stacked into ``in_proj_weight`` (rows q, k, v; head h on
    rows h * D ..), LayerNorm scales as weights."""
    sd = _port_state(head_run["params"])
    p = head_run["params"]["dii1"]["self_attn"]
    q = np.asarray(p["query"]["kernel"])                 # (E, heads, D)
    v = np.asarray(p["value"]["kernel"])
    ip = sd["bbox_head.1.attention.attn.in_proj_weight"].numpy()
    np.testing.assert_array_equal(ip[:C], q.reshape(C, C).T)
    np.testing.assert_array_equal(ip[2 * C:], v.reshape(C, C).T)
    np.testing.assert_array_equal(sd["bbox_head.1.reg_fcs.4.weight"].numpy(),
                                  np.asarray(head_run["params"]["dii1"]["reg_ln1"]["scale"]))
    for key in ("bbox_head.0.instance_interactive_conv.fc_layer.weight",
                "bbox_head.0.ffn.layers.0.0.bias", "bbox_head.0.cls_fcs.0.weight",
                "bbox_head.0.attention.attn.out_proj.weight"):
        assert key in sd


# ------------------------------------------------------------ the detector ----

def _det_variables(jdet, batch):
    shapes = jax.eval_shape(lambda: jdet.init({"params": jax.random.PRNGKey(0),
                                               "sampling": jax.random.PRNGKey(1)}, batch, "test"))
    return jax.tree_util.tree_map(np.asarray, _randomize(shapes, seed=7))


@pytest.fixture(scope="module")
def det_run():
    rng = np.random.RandomState(9)
    case = _inputs(1)
    img = rng.normal(0, 1, (N, H, W, 3)).astype(np.float32)
    batch = {"img": img, "img_shape": SHAPES, "scale_factor": np.full((N, 4), 2.0, np.float32),
             "gt_bboxes": case["gt"], "gt_labels": case["labels"], "gt_valid": case["gt_valid"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(_model("jax"), num_views=1)
    variables = _det_variables(jdet, {k: jb[k] for k in ("img", "img_shape", "scale_factor")})
    rngs = {"sampling": jax.random.PRNGKey(2)}
    jlosses, jtest = jax.jit(lambda v, b: (jdet.apply(v, b, "train", rngs=rngs), jdet.apply(
        v, {k: b[k] for k in ("img", "img_shape", "scale_factor")}, "test")))(variables, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    sd = jax_variables_to_state_dict(variables)
    out = {}
    for kind in ("SparseRCNN", "QueryInst"):
        det = build_detector(dict(_model("torch"), type=kind), device="cpu")
        det.load_state_dict(sd, strict=True)
        with torch.no_grad():
            losses = det.forward_train(tb, UniformDraws())
            dets = det.simple_test({k: tb[k] for k in ("img", "img_shape", "scale_factor")})
        out[kind] = (losses, dets)
    return dict(jlosses=jlosses, jtest=jtest, out=out, sd=sd)


def test_sparse_rcnn_forward_train_matches_jax(det_run):
    jl = det_run["jlosses"]
    losses = det_run["out"]["SparseRCNN"][0]
    assert set(losses) == set(jl) and len(jl) == 6
    for k, v in jl.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5, err_msg=k)


def test_sparse_rcnn_simple_test_matches_jax(det_run):
    """Boxes from the learned proposals at each image's ``img_shape``,
    divided by ``scale_factor``."""
    jd, jl, jv = (np.asarray(x) for x in det_run["jtest"])
    td, tl, tv = (x.numpy() for x in det_run["out"]["SparseRCNN"][1])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)
    _close(td[..., :4], jd[..., :4])
    np.testing.assert_allclose(td[..., 4], jd[..., 4], rtol=0, atol=1e-5)


def test_query_inst_is_sparse_rcnn_with_boxes_only(det_run):
    """JAX's ``QueryInst`` subclasses ``SparseRCNN`` with no method of its
    own; the port's gives Sparse R-CNN's losses and detections bit for bit."""
    from oadg_tpu.models.roi_heads.sparse_roi_head import QueryInst, SparseRCNN
    assert QueryInst.__mro__[1] is SparseRCNN
    assert not {"forward_train", "simple_test"} & set(vars(QueryInst))
    (sl, sd), (ql, qd) = det_run["out"]["SparseRCNN"], det_run["out"]["QueryInst"]
    assert all(torch.equal(sl[k], ql[k]) for k in sl)
    assert all(torch.equal(a, b) for a, b in zip(sd, qd))


def test_embedding_proposals_scale_by_img_shape():
    from oadg_tpu_torch.models.roi_heads.sparse_roi_head import EmbeddingRPNHead
    head = EmbeddingRPNHead(num_proposals=3, proposal_feature_channel=4, device="cpu")
    head.init_weights(torch.Generator().manual_seed(0))
    boxes, feats = head(torch.tensor([[64.0, 96.0], [60.0, 90.0]]))
    np.testing.assert_array_equal(boxes[1, 0].detach().numpy(), [0, 0, 90, 60])
    assert feats.shape == (2, 3, 4)


def test_mmdet_checkpoint_with_fc_norm_is_refused(det_run):
    """A Sparse R-CNN checkpoint under mmdet's names loads whole; mmdet's own
    holds ``instance_interactive_conv.fc_norm``, which the JAX head lacks:
    loading it raises, naming the tensors."""
    det = build_detector(_model("torch"), device="cpu")
    sd = {k: v.clone() for k, v in det_run["sd"].items()}
    report = load_mmdet_checkpoint(det, dict(sd))
    assert not report["missing"] and len(report["loaded"]) == len(sd)
    sd["roi_head.bbox_head.0.instance_interactive_conv.fc_norm.weight"] = torch.ones(C)
    with pytest.raises(KeyError, match="fc_norm"):
        load_mmdet_checkpoint(det, copy.deepcopy(sd))


def test_sparse_rcnn_trains_and_tests_through_the_tools(tmp_path):
    """``tools/torch_train.py`` (one epoch of 2 steps, 2 images a step, and
    its evaluation) then ``tools/torch_test.py`` on the saved checkpoint,
    the config narrowed as ``_model`` and the 4-PNG set of
    ``torch_data_cases`` at 96x64: the runner hands ``forward_train`` each
    image's ``img_shape`` and the test loop takes the (B, 100, 5) outputs."""
    import json
    import torch_data_cases as data_cases
    from test_torch_config_sweep import _tool
    ann, prefix = data_cases.write_dataset(str(tmp_path / "ds"), sizes=data_cases.TRAIN_SIZES)
    cfg = load_config(os.path.join(ROOT, CONFIG))
    cfg.model = _model("torch")
    cfg.model["test_cfg"] = dict(max_per_img=100)
    pipeline = cfg.data.train.dataset.pipeline
    resize = [i for i, op in enumerate(pipeline) if op["type"] == "Resize"][0]
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1, "data.train.times": 1,
            "data.train.dataset.ann_file": ann, "data.train.dataset.img_prefix": prefix,
            f"data.train.dataset.pipeline.{resize}.img_scale": (96, 64),
            "runner.max_epochs": 1, "log_config.interval": 1}
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann, f"data.{split}.img_prefix": prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 64)})
    cfg.merge_from_dict(opts)
    config = str(tmp_path / "tiny_sparse.py")
    cfg.dump(config)
    work = tmp_path / "work"
    _tool("torch_train").main([config, "--device", "cpu", "--work-dir", str(work), "--seed", "0"])
    with open(work / "log.json") as f:
        lines = [json.loads(line) for line in f]
    assert [ln["mode"] for ln in lines] == ["train", "train", "val"]
    assert all(np.isfinite(ln["loss"]) and "s1.loss_iou" in ln for ln in lines[:2])
    metrics = _tool("torch_test").main([config, str(work / "epoch_1.pth"), "--device", "cpu",
                                        "--eval", "bbox"])
    assert metrics == {k: v for k, v in lines[-1].items() if k not in ("mode", "epoch")}
