"""DETR and Deformable DETR of the port against the JAX package, on the
CPU, whole, on the tiny models of their published configs
(``torch_detr_cases.tiny_model``: ResNet-18 at base width 8, one encoder
and two decoder layers of 16 channels and 2 heads, 10 queries, 8 classes;
Deformable DETR ``lean``: one head on ChannelMapper's 2 levels, as the
JAX side compiles in time proportional to heads x levels, and
``test_torch_detr_parts.py`` holds the attention at 2 heads on 3 levels),
2 images of 64x96 with 4
seeded gts each (one padded), seeded numpy weights for the whole JAX
detector loaded into the port (``jax_variables_to_state_dict``, strict).

JAX runs, in one jit a model, the backbone, then one forward of the
neck and head: the head's outputs, its losses (``DETR.__call__``'s train
mode) with their gradients w.r.t. the neck's and head's parameters, and
``get_bboxes`` (its test mode); the backbone's gradients are the ported
ResNet's, held by the earlier slices' tests. The Hungarian matcher's scipy calls are
recorded on both sides (JAX's host callback, the port's ``lsa_host``).
Tolerances:

- every decoder layer's class logits and boxes: within 1e-5 of each one's
  largest magnitude;
- every assignment equal, each of the port's costs within 1e-5 of the
  largest of its JAX twin;
- the per-layer losses (``d0.loss_*`` and ``loss_*``): rtol 1e-5;
- every neck and head gradient within 1e-4 of its largest JAX magnitude,
  floored at 1e-5 of the largest of them (DETR's first
  decoder layer starts from zeros, so its self-attention's query and key
  take gradients of ~1e-8: noise on both sides);
- detections: labels and valid rows exact, boxes within 1e-4 of the
  largest coordinate, scores rtol 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_detr_cases as cases
from oadg_tpu.core.bbox import hungarian as jax_hungarian
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.core.bbox import hungarian
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)
NAMES = ("detr", "deformable_detr")
LOSSES = [f"{p}loss_{k}" for p in ("d0.", "") for k in ("cls", "bbox", "iou")]


def _recording(fn, calls):
    def rec(cost, num_valid):
        out = fn(cost, num_valid)
        calls.append((np.array(cost, np.float32), int(num_valid), np.array(out)))
        return out
    return rec


def _jax_run(jdet, variables, jb):
    """The backbone's maps, then one forward of the neck and head: the
    head's outputs, its losses (as ``DETR.__call__`` in train mode), their
    gradients w.r.t. the neck's and head's parameters, ``get_bboxes`` (as
    in test mode)."""
    def neck_head(m, f):
        return m.head(m.neck_m(f) if m.neck_m is not None else f)

    def loss_fn(trained, feats, b):
        v = {"params": dict(variables["params"], **trained),
             "batch_stats": variables["batch_stats"]}
        outs = jdet.apply(v, feats, method=neck_head)
        losses = jdet.apply(v, outs, b["gt_bboxes"], b["gt_valid"], b["gt_labels"],
                            b["img_shape"], method=lambda m, o, g, gv, gl, s: m.head.loss(
                                o, g, gv, gl, img_shapes=s))
        return sum(losses.values()), (losses, outs)

    def run(variables, b):
        feats = jdet.apply(variables, b["img"], method=lambda m, x: m.backbone_m(x))
        trained = {k: v for k, v in variables["params"].items() if k != "backbone_m"}
        (_, (losses, outs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trained, feats, b)
        dets = jdet.apply(variables, outs, b["img_shape"], b["scale_factor"],
                          method=lambda m, o, s, f: m.head.get_bboxes(o, s, f))
        return losses, grads, outs, dets

    return jax.jit(run)(variables, jb)


@pytest.fixture(scope="module", params=NAMES)
def run(request):
    name = request.param
    b = cases.batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jdet = jax_build_detector(cases.jax_model(name, lean=True))
    shapes = jax.eval_shape(lambda r, x: jdet.init(r, x, "test"),
                            {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
                            jb)
    variables = {"params": cases.randomize(shapes["params"]),
                 "batch_stats": cases.randomize(shapes["batch_stats"], 3)}
    jcalls, tcalls = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_hungarian, "_lsa_host", _recording(jax_hungarian._lsa_host, jcalls))
    try:
        jlosses, jgrads, jouts, jtest = _jax_run(jdet, variables, jb)
    finally:
        mp.undo()

    det = init_detector({"model": cases.torch_model(name, lean=True)}, device="cpu",
                        seed=0).model
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    det.train()
    tb = cases.torch_batch(b)
    mp.setattr(hungarian, "lsa_host", _recording(hungarian.lsa_host, tcalls))
    try:
        with torch.no_grad():
            outs = det.bbox_head(det.extract_feat(tb["img"]))
        losses = det.forward_train(tb, None)
    finally:
        mp.undo()
    sum(losses.values()).backward()
    det.eval()
    with torch.no_grad():
        test = det.simple_test({k: tb[k] for k in ("img", "img_shape", "scale_factor")})
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    return dict(name=name, det=det, jlosses=jlosses, losses=losses, want_grads=want_grads,
                jouts=jouts, outs=outs, jtest=jtest, test=test, jcalls=jcalls,
                tcalls=tcalls)


def test_forward_outputs_match_jax(run):
    """(L, N, Q, C + 1) or (L, N, Q, C) logits and (L, N, Q, 4) boxes."""
    for got, want in zip(run["outs"], run["jouts"]):
        want = np.asarray(want)
        assert got.shape == want.shape and got.shape[0] == 2 and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_hungarian_assignments_equal_jax(run):
    """One scipy call an image a decoder layer on both sides (the port's in
    one host round trip a layer), the same optimal assignments of the same
    costs (JAX's callbacks may run in any order: each port call is paired
    with the JAX call of the nearest cost)."""
    jcalls, tcalls = run["jcalls"], run["tcalls"]
    assert len(tcalls) == len(jcalls) == 2 * 2
    for cost, n, out in tcalls:
        dist = [np.abs(cost - c).max() if c.shape == cost.shape else np.inf
                for c, _, _ in jcalls]
        c, jn, jout = jcalls[int(np.argmin(dist))]
        assert min(dist) <= 1e-5 * np.abs(c[:, :n]).max()
        assert n == jn and (n == 4 or n == 3)
        np.testing.assert_array_equal(out, jout)
        assert (out > 0).sum() == n


@pytest.mark.parametrize("key", LOSSES)
def test_per_layer_losses_match_jax(run, key):
    assert set(run["losses"]) == set(run["jlosses"]) == set(LOSSES)
    got, want = float(run["losses"][key].detach()), float(run["jlosses"][key])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


def test_every_neck_and_head_gradient_matches_jax(run):
    det, want = run["det"], run["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters()
                 if p.requires_grad and not k.startswith("backbone.")]
    assert set(want) == {k for k, _ in trainable}
    top = max(np.abs(w.numpy()).max() for k, w in want.items()
              if k in dict(trainable))
    assert any(k.startswith("bbox_head.transformer.") for k, _ in trainable)
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=max(1e-4 * np.abs(w).max(), 1e-5 * top), err_msg=name)
    frozen = [k for k, p in det.named_parameters() if not p.requires_grad]
    assert "backbone.conv1.weight" in frozen and not any(k.startswith("bbox_head.")
                                                          for k in frozen)


def test_get_bboxes_matches_jax(run):
    """``simple_test``: DETR's top queries by their largest class
    probability (all 10), Deformable DETR's top 20 (query, class) pairs;
    the same indices (labels), boxes and scores."""
    (jd, jl, jv), (td, tl, tv) = [tuple(np.asarray(x) for x in t) for t in
                                  (run["jtest"], run["test"])]
    k = 10 if run["name"] == "detr" else 20       # DETR: at most its 10 queries
    assert td.shape == jd.shape == (2, k, 5)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td[..., :4], jd[..., :4], rtol=0,
                               atol=1e-4 * np.abs(jd[..., :4]).max())
    np.testing.assert_allclose(td[..., 4], jd[..., 4], rtol=1e-5)
    assert tv.all()


def test_deformable_attention_takes_the_necks_three_levels():
    """The config's ChannelMapper ``num_outs=4`` is dropped by both packages:
    the head as given samples 3 levels (its offsets 8 heads x 3 levels x 4
    points x 2 = 192 rows, its weights 96, against mmdet's 256 and 128),
    per-level value projections."""
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.models import build_detector
    model = load_config(f"{cases.ROOT}/{cases.CONFIGS['deformable_detr']}")["model"]
    model["backbone"]["init_cfg"] = None
    det = build_detector(cases.oc._plain(model), device="meta")
    assert len(det.neck.convs) == 3 and det.bbox_head.num_levels == 3
    att = det.bbox_head.transformer.encoder.layers[0].attentions[0]
    assert att.sampling_offsets.weight.shape == (8 * 3 * 4 * 2, 256)
    assert att.attention_weights.weight.shape == (8 * 3 * 4, 256)
    assert len(att.value_proj) == 3
