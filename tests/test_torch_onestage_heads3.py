"""GA-RetinaNet's, SABL-RetinaNet's, NAS-FPN's (``RetinaSepBNHead``) and
NAS-FCOS's heads of the port against the JAX package, on the CPU, each on
the tiny R18 model of its published config
(``torch_onestage_cases.tiny_model``: ResNet-18, neck and head at 16
channels, one conv a tower, 8 classes; NAS-FPN at two stacks, NAS-FCOS's
neck at ``start_level=1``), two images with seeded gts (one padded; 64x96,
the NAS models' 128x192), seeded numpy weights for the whole JAX detector
(``jax.eval_shape`` plus ``randomize``) loaded into the port
(``jax_variables_to_state_dict``, strict).

JAX runs, in one jit a config, what its train step runs with
``mutable=['batch_stats']``: the features (the NAS necks' live BNs on the
batch's statistics), the head's forward (RetinaSepBNHead's per-level BNs
likewise), loss and gradient w.r.t. the head's parameters, and the eval
path: the stored statistics' features, head and ``get_bboxes``. The port
runs the whole model: ``simple_test`` in eval mode, then
``forward_train`` in train mode. Tolerances, as
``tests/test_torch_onestage_heads.py``'s:

- head outputs (eval mode and train mode): within 1e-4 of the output's
  largest magnitude over the levels;
- losses: rtol 1e-5, each positive;
- the head's gradients, each leaf against JAX's within 1e-4 of its largest
  JAX magnitude (floored at 1e-3 of the head's largest JAX gradient), and
  within 1e-4 of its largest magnitude of a float64 evaluation of the
  port's head on the same features; a conv bias before a GroupNorm
  (NAS-FCOS's towers) or a train-mode BN (RetinaSepBNHead's) has a true
  gradient of 0 and both packages' are within 1e-5 of the head's largest
  JAX gradient;
- the live BNs' running statistics after the training forward (the
  necks' and RetinaSepBNHead's): within 1e-5 of each tensor's largest;
- ``simple_test``: valid rows and labels exact, boxes within 1e-3 px,
  scores rtol 1e-5.
"""
import copy
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_onestage_cases as cases
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.dense_heads.free_anchor_heads import ConvBN
from oadg_tpu_torch.models.layers import ConvGN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
LOSSES = {"ga_retina": ("loss_bbox", "loss_cls", "loss_ga_loc", "loss_ga_shape"),
          "sabl_retina": ("loss_bbox_cls", "loss_bbox_reg", "loss_cls"),
          "nas_fpn": ("loss_bbox", "loss_cls"),
          "nas_fcos": ("loss_bbox", "loss_centerness", "loss_cls")}
OUTPUTS = {"ga_retina": 4, "sabl_retina": 3, "nas_fpn": 2, "nas_fcos": 3}
GRAD_TOL = 1e-4
# SABL on the gts of seed 6: on the default seed's (4) approx anchors tie in
# float32 at a gt's largest IoU, where float64 tells them apart (two rows
# assigned otherwise), so the float64 reference would hold another
# assignment (JAX's float32 ties as the port's do).
BATCH_SEED = {"sabl_retina": 6}
# GA's loc and shape positives are the points of a gt's level inside its
# central fifth, about one point a gt: the seeded gts give none. These are
# centred on points of levels 0, 1 and 2 (the third beyond the image).
GA_GTS = np.array([[[26, 18, 46, 38], [20, 4, 60, 44], [8, -24, 88, 56], [0, 0, 0, 0]],
                   [[50, 34, 70, 54], [10, 30, 40, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                  np.float32)


def _jax_run(jdet, variables, jb):
    """The training path (features, head, loss and the head's gradients,
    every live BN on the batch's statistics) and the eval path (features,
    head, ``get_bboxes`` on the stored statistics), in one jit."""
    extract = lambda m, x: m.extract_feat(x)                          # noqa: E731
    head = lambda m, f: m.head(f)                                      # noqa: E731

    def run(variables, b):
        params, stats = variables["params"], variables["batch_stats"]
        feats, moved = jdet.apply(variables, b["img"], method=extract, mutable=["batch_stats"])

        def loss_fn(hp):
            v = {"params": dict(params, head=hp), "batch_stats": stats}
            outs, head_moved = jdet.apply(v, feats, method=head, mutable=["batch_stats"])
            losses = jdet.apply(v, outs, b["gt_bboxes"], b["gt_valid"], b["gt_labels"],
                                method=lambda m, o, g, gv, gl: m.head.loss(o, g, gv, gl, None))
            return sum(losses.values()), (losses, outs, head_moved)

        (_, (losses, outs, head_moved)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params["head"])
        eouts = jdet.apply(variables, jdet.apply(variables, b["img"], method=extract),
                           method=head)
        dets = jdet.apply(variables, eouts, b["img_shape"], b["scale_factor"],
                          method=lambda m, o, s, f: m.head.get_bboxes(o, s, f))
        stats_after = dict(moved["batch_stats"])
        if "head" in head_moved.get("batch_stats", {}):
            stats_after["head"] = head_moved["batch_stats"]["head"]
        return losses, grads, outs, eouts, dets, stats_after

    return jax.jit(run)(variables, jb)


@pytest.fixture(scope="module", params=cases.THIRD)
def head(request):
    name = request.param
    model = cases.tiny_model(name)
    batch = cases.batch(seed=BATCH_SEED.get(name, 4),
                        hw=cases.NAS_HW if name.startswith("nas") else cases.HW)
    if name == "ga_retina":
        batch["gt_bboxes"] = GA_GTS
        batch["gt_valid"] = (GA_GTS[..., 2] > 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model)
    shapes = jax.eval_shape(lambda r, x: jdet.init(
        r, x, method=lambda m, x: m.head(m.extract_feat(x))), jax.random.PRNGKey(0), jb["img"])
    variables = {"params": cases.randomize(shapes["params"], 5),
                 "batch_stats": cases.randomize(shapes["batch_stats"], 3)}
    jlosses, jgrads, jouts, jeouts, jdets, jstats = _jax_run(jdet, variables, jb)

    det = build_detector(model, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    det.eval()
    with torch.no_grad():
        eouts = det.bbox_head(det.extract_feat(tb["img"]))
        dets = det.simple_test(tb)
    det.train()
    losses = det.forward_train(tb, UniformDraws())
    sum(losses.values()).backward()
    stats = {k: v.clone() for k, v in det.state_dict().items() if ".running_" in k
             and not k.startswith("backbone.")}
    with torch.no_grad():
        outs = det.bbox_head(det.extract_feat(tb["img"]))
    # the float64 reference: the port's head on the same (float32) features
    head64 = copy.deepcopy(det.bbox_head).double()
    head64.zero_grad()
    with torch.no_grad():
        feats = [f.double() for f in det.extract_feat(tb["img"])]
    l64 = head64.loss(head64(feats), tb["gt_bboxes"].double(), tb["gt_valid"], tb["gt_labels"])
    sum(l64.values()).backward()
    return dict(name=name, det=det, losses=losses, outs=outs, eouts=eouts, dets=dets,
                jlosses=jlosses, jouts=jouts, jeouts=jeouts, jdets=jdets, head64=head64,
                stats=stats,
                jstats=jax_variables_to_state_dict(
                    {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}),
                jgrads=jax_variables_to_state_dict(
                    {"params": {"head": jax.tree_util.tree_map(np.asarray, jgrads)}}))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_head_outputs_match_jax(head, mode):
    """The eval outputs on the stored statistics; the train-mode outputs
    (the live BNs on the batch's statistics; the port's second train-mode
    forward, whose batch statistics are the first's)."""
    outs, jouts = (head["eouts"], head["jeouts"]) if mode == "eval" else \
        (head["outs"], head["jouts"])
    assert len(outs) == len(jouts) == OUTPUTS[head["name"]]
    for i, (levels, jlevels) in enumerate(zip(outs, jouts)):
        assert len(levels) == len(jlevels) == 5
        scale = max(float(np.abs(np.asarray(j)).max()) for j in jlevels)
        for li, (got, want) in enumerate(zip(levels, jlevels)):
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{head['name']} {mode} output {i} level {li}")


def test_losses_match_jax(head):
    losses, jlosses = head["losses"], head["jlosses"]
    assert tuple(sorted(losses)) == tuple(sorted(jlosses)) == LOSSES[head["name"]]
    for k, v in losses.items():
        assert v.dtype == torch.float32 and torch.isfinite(v)
        np.testing.assert_allclose(float(v.detach()), float(jlosses[k]), rtol=1e-5,
                                   err_msg=f"{head['name']} {k}")
        assert float(v.detach()) > 0, k


def test_head_gradients_match_jax(head):
    det, want, name = head["det"], head["jgrads"], head["name"]
    ref = dict(head["head64"].named_parameters())
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    # a conv bias before a GroupNorm or a train-mode BN: its true gradient is 0
    before_norm = {f"{n}.conv.bias" for n, m in det.bbox_head.named_modules()
                   if isinstance(m, (ConvGN, ConvBN))}
    mine = {f"bbox_head.{k}" for k, _ in det.bbox_head.named_parameters()}
    # RetinaSepBNHead's shared tower convs appear under every level in JAX's
    # map and once (level 0) among the parameters
    assert mine <= set(want)
    assert all(re.fullmatch(r"bbox_head\.(cls|reg)_convs\.[1-9]\.\d+\.conv\.\w+", k)
               for k in set(want) - mine)
    for k, p in det.bbox_head.named_parameters():
        r = ref[k].grad.numpy()
        w = want[f"bbox_head.{k}"].numpy()
        g = p.grad.numpy()
        msg = f"{name} {k}"
        if k in before_norm:
            assert max(np.abs(g).max(), np.abs(w).max(), np.abs(r).max()) <= 1e-5 * top, msg
            continue
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale, err_msg=msg + " vs JAX")
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(float(np.abs(r).max()),
                                                                 1e-3 * top),
                                   err_msg=msg + " vs float64")


def test_live_bn_statistics_match_jax(head):
    """The running statistics every live BN (the NAS necks', the
    per-level BNs of RetinaSepBNHead) holds after the training forward."""
    stats, want = head["stats"], head["jstats"]
    live = {"ga_retina": 0, "sabl_retina": 0, "nas_fcos": 2 * 5, "nas_fpn": 2 * (3 + 16 + 10)}
    assert len(stats) == live[head["name"]]
    for k, v in stats.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_simple_test_matches_jax(head):
    dets, labels, valid = (t.numpy() for t in head["dets"])
    jd, jl, jv = (np.asarray(t) for t in head["jdets"])
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    assert valid.sum() >= 10
    np.testing.assert_allclose(dets[..., :4], jd[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets[..., 4], jd[..., 4], rtol=1e-5, atol=1e-7)
