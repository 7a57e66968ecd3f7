"""RepPoints', CenterNet's, CornerNet's and CentripetalNet's heads of the
port against the JAX package, on the CPU, each on the tiny model of its
published config (``torch_onestage_cases.tiny_model``: RepPoints on
ResNet-18 with its FPN and head at 16 channels and one conv a tower,
CenterNet on the config's ResNet-18 with its head at 16 channels, the
corner heads on the narrowed Hourglass; 8 classes), two images of 64x96
with seeded gts (one padded), seeded numpy weights for the whole JAX
detector (``jax.eval_shape`` plus ``randomize``) loaded into the port
(``jax_variables_to_state_dict``, strict).

JAX runs, in one jit a config, what its train step runs with
``mutable=['batch_stats']`` (the Hourglass's and the corner pools' live
BNs on the batch's statistics): the features, the head's forward, loss and
gradient w.r.t. the head's parameters, and the eval path (the stored
statistics' features, head and ``get_bboxes``). The port runs the whole
model: ``simple_test`` in eval mode, then ``forward_train`` in train mode.
Tolerances, as ``tests/test_torch_onestage_heads3.py``'s:

- head outputs (eval mode and train mode): within 1e-4 of each output's
  largest magnitude;
- losses: rtol 1e-5;
- the head's gradients, each leaf against JAX's within 1e-4 of its largest
  JAX magnitude (floored at 1e-3 of the head's largest JAX gradient), and
  within 1e-4 of its largest magnitude of a float64 evaluation of the
  port's head on the same features; a conv bias before a GroupNorm
  (RepPoints' towers) has a true gradient of 0 and both packages' are
  within 1e-5 of the head's largest JAX gradient;
- the live BNs' running statistics after the training forward (the
  Hourglass's and the corner pools'): within 1e-5 of each tensor's
  largest;
- ``simple_test``: valid rows and labels exact, boxes within 1e-3 px,
  scores rtol 1e-5.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_onestage_cases as cases
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.layers import ConvGN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
CORNER = ("loss_heatmap", "loss_offset", "loss_pull", "loss_push")
LOSSES = {"reppoints": ("loss_cls", "loss_pts_init", "loss_pts_refine"),
          "centernet": ("loss_center_heatmap", "loss_offset", "loss_wh"),
          "cornernet": tuple(sorted(f"l{i}.{k}" for i in range(2) for k in CORNER)),
          "centripetalnet": tuple(sorted(f"l{i}.{k}" for i in range(2) for k in
                                         ("loss_centripetal", "loss_heatmap", "loss_offset")))}
# the narrowed Hourglass's live BNs (the stem's conv and block 1 + 3; a
# stack's 7 blocks, 3 of them with a downsample, 17; the out convs 2, the
# fusion's 1x1s 2 and block 2) and each corner head's pools (2 sides x 2
# stacks x 4)
HOURGLASS_BNS = 4 + 2 * 17 + 2 + 2 + 2
LIVE = {"reppoints": 0, "centernet": 0, "cornernet": HOURGLASS_BNS + 16,
        "centripetalnet": HOURGLASS_BNS + 16}
GRAD_TOL = 1e-4
# RepPoints on 64x64: at 64x96 its stride-64 level is 1x2, where each
# GroupNorm group (one channel of 16) holds 2 values and flax's
# E[x^2] - E[x]^2 variance loses ~1e-4 of the outputs to cancellation (the
# float64 reference agrees with the port); at 64x64 every level is square
HW = {"reppoints": (64, 64)}


def _leaves(outs):
    """The port's outputs in the order of ``jax.tree_util.tree_leaves`` of
    JAX's (a dict's values by key), channels last."""
    if torch.is_tensor(outs):
        return [outs.permute(0, 2, 3, 1)]
    if isinstance(outs, dict):
        return [t for k in sorted(outs) for t in _leaves(outs[k])]
    return [t for o in outs for t in _leaves(o)]


def _jax_run(jdet, variables, jb):
    """The training path and the eval path, in one jit (as
    ``tests/test_torch_onestage_heads3.py``)."""
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
        stats_after = dict(moved.get("batch_stats", {}))
        if "head" in head_moved.get("batch_stats", {}):
            stats_after["head"] = head_moved["batch_stats"]["head"]
        return losses, grads, outs, eouts, dets, stats_after

    return jax.jit(run)(variables, jb)


@pytest.fixture(scope="module", params=cases.FOURTH)
def head(request):
    name = request.param
    model = cases.tiny_model(name)
    batch = cases.batch(hw=HW.get(name, cases.HW))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model)
    shapes = jax.eval_shape(lambda r, x: jdet.init(
        r, x, method=lambda m, x: m.head(m.extract_feat(x))), jax.random.PRNGKey(0), jb["img"])
    variables = {"params": cases.randomize(shapes["params"], 5),
                 "batch_stats": cases.randomize(shapes.get("batch_stats", {}), 3)}
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
             and not (k.startswith("backbone.") and name in ("reppoints", "centernet"))}
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
                    {"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}),
                jgrads=jax_variables_to_state_dict(
                    {"params": {"head": jax.tree_util.tree_map(np.asarray, jgrads)}}))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_head_outputs_match_jax(head, mode):
    """The eval outputs on the stored statistics; the train-mode outputs
    (the live BNs on the batch's statistics; the port's second train-mode
    forward, whose batch statistics are the first's)."""
    outs, jouts = (head["eouts"], head["jeouts"]) if mode == "eval" else \
        (head["outs"], head["jouts"])
    got, want = _leaves(outs), jax.tree_util.tree_leaves(jouts)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{head['name']} {mode} output {i}")


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
    # a conv bias before a GroupNorm: its true gradient is 0
    before_norm = {f"{n}.conv.bias" for n, m in det.bbox_head.named_modules()
                   if isinstance(m, ConvGN)}
    assert {f"bbox_head.{k}" for k, _ in det.bbox_head.named_parameters()} == set(want)
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
    """The running statistics every live BN (the Hourglass's, the corner
    pools') holds after the training forward."""
    stats, want = head["stats"], head["jstats"]
    assert len(stats) == 2 * LIVE[head["name"]]
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
