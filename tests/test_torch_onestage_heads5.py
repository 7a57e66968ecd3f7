"""YOLOF's, YOLOX-S's, SSD300's, SOLO's and YOLACT's heads of the port
against the JAX package, on the CPU, each on the tiny model of its
published config (``torch_onestage_cases.tiny_model``, ``FIFTH``: YOLOF on
R18's C5 with its DilatedEncoder at 16 channels, YOLOX-S's CSPDarknet at
``widen_factor`` 0.125 and its PAFPN and head at 16, SSD300 whole at
300x300, SOLO and YOLACT on R18-FPN-16, SOLO at the grids ``(12, 9, 8, 6,
4)``, all below P2's 16x24; 8 classes), seeded gts (one padded; SOLO and
YOLACT with seeded box-cropped masks), seeded numpy weights for the whole
JAX detector loaded into the port (``jax_variables_to_state_dict``,
strict).

JAX runs, in one jit a config, the training path with
``mutable=['batch_stats']`` (the live BNs of YOLOF's neck and head and of
YOLOX's backbone, neck and head on the batch's statistics: the features,
the head's forward, loss and gradient w.r.t. the head's parameters) and
the eval path (the stored statistics, the head, its test call). The port
runs the whole model: ``simple_test`` in eval mode, ``forward_train`` in
train mode. Tolerances:

- head outputs (eval and train mode): within 1e-4 of each output's largest
  magnitude;
- losses: rtol 1e-5 (the assignments behind them are held exactly by
  ``tests/test_torch_onestage_parts5.py``);
- the head's gradients, each leaf within 1e-4 of its largest JAX
  magnitude (floored at 1e-3 of the head's largest JAX gradient) and of its
  float64 evaluation (the port's head on the same features); a conv bias
  before a GroupNorm (SOLO's towers) or a live BN (YOLOF's towers) within
  1e-5 of the head's largest; YOLOX's leaves within 3e-4 of JAX's and 1e-5
  of the float64 evaluation (``WIDER``);
  YOLACT's ``segm_conv`` takes no gradient (the port's is None, JAX's 0);
- the live BNs' running statistics after the training forward: within
  1e-4 of each tensor's largest;
- detections: valid rows and labels exact, boxes within 1e-3 px, scores
  rtol 1e-5; SOLO's masks equal but at pixels within 1e-5 of ``mask_thr``.
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
from oadg_tpu_torch.models.layers import BatchNorm, ConvGN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
HW = {"yolof": cases.YOLOF_HW, "ssd": cases.SSD_HW}
MASKS = ("solo", "yolact")
LOSSES = {"yolof": ("loss_bbox", "loss_cls"), "ssd": ("loss_bbox", "loss_cls"),
          "yolox": ("loss_bbox", "loss_cls", "loss_obj"), "solo": ("loss_cls", "loss_mask"),
          "yolact": ("loss_bbox", "loss_cls", "loss_mask")}
# the live BNs: YOLOF's neck (2 + 4 x 3) and head (2 + 4); YOLOX's
# CSPDarknet (the stem, 6 + 10 + 10 in stages 1-3, 8 in stage 4 with its
# SPP), PAFPN (2 reduce, 2 x 5 top-down, 2 down, 2 x 5 bottom-up, 3 out) and
# head (3 stems, 3 x 2 x 2 tower convs)
LIVE = {"yolof": 20, "yolox": 35 + 27 + 15, "ssd": 0, "solo": 0, "yolact": 0}
GRAD_TOL = 1e-4
# SSD's background logit bias: at the seeded weights' ~0 every class's
# softmax is ~1/9, all 8732 x 8 candidates pass ``score_thr`` 0.02 and the
# CPU's NMS takes ~30 s; at +4 few do, as in a trained SSD
SSD_BG = 4.0
# YOLOX's head gradients of the jitted JAX step sit up to 2.0e-4 of each
# leaf's largest from the float64 evaluation (the stems and towers of all
# three levels, through their live BNs), where the port's sit within
# 1.6e-6 of it: JAX is held at 3e-4 there, the float64 evaluation at 1e-5
WIDER = {"yolox": (3e-4, 1e-5)}


def _leaves(outs):
    """The port's outputs in ``jax.tree_util.tree_leaves`` order of JAX's,
    channels last."""
    if torch.is_tensor(outs):
        return [outs.permute(0, 2, 3, 1) if outs.dim() == 4 else outs]
    return [t for o in outs for t in _leaves(o)]


def _test_call(name):
    if name == "solo":
        return lambda m, o, s, f: m.head.get_results(o, s, f)
    return lambda m, o, s, f: m.head.get_bboxes(o, s, f)


def _jax_run(name, jdet, variables, jb):
    extract = lambda m, x: m.extract_feat(x)                          # noqa: E731
    head = lambda m, f: m.head(f)                                      # noqa: E731
    extra = {"gt_masks": jb["gt_masks"]} if name in MASKS else {}

    def run(variables, b):
        params, stats = variables["params"], variables["batch_stats"]
        feats, moved = jdet.apply(variables, b["img"], method=extract, mutable=["batch_stats"])

        def loss_fn(hp):
            v = {"params": dict(params, head=hp), "batch_stats": stats}
            outs, head_moved = jdet.apply(v, feats, method=head, mutable=["batch_stats"])
            losses = jdet.apply(v, outs, b["gt_bboxes"], b["gt_valid"], b["gt_labels"],
                                method=lambda m, o, g, gv, gl: m.head.loss(o, g, gv, gl, None,
                                                                           **extra))
            return sum(losses.values()), (losses, outs, head_moved)

        (_, (losses, outs, head_moved)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params["head"])
        eouts = jdet.apply(variables, jdet.apply(variables, b["img"], method=extract),
                           method=head)
        dets = jdet.apply(variables, eouts, b["img_shape"], b["scale_factor"],
                          method=_test_call(name))
        stats_after = dict(moved.get("batch_stats", {}))
        if "head" in head_moved.get("batch_stats", {}):
            stats_after["head"] = head_moved["batch_stats"]["head"]
        return losses, grads, outs, eouts, dets, stats_after

    return jax.jit(run)(variables, jb)


@pytest.fixture(scope="module", params=cases.FIFTH)
def head(request):
    name = request.param
    model = cases.tiny_model(name)
    batch = cases.batch(hw=HW.get(name, cases.HW), n=1 if name == "ssd" else 2)
    if name in MASKS:
        batch = cases.with_masks(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model)
    shapes = jax.eval_shape(lambda r, x: jdet.init(
        r, x, method=lambda m, x: m.head(m.extract_feat(x))), jax.random.PRNGKey(0), jb["img"])
    variables = {"params": cases.randomize(shapes["params"], 5),
                 "batch_stats": cases.randomize(shapes.get("batch_stats", {}), 3)}
    if name == "ssd":           # most anchors background, as in a trained SSD
        for k, conv in variables["params"]["head"].items():
            if k.startswith("cls_conv"):
                conv["Conv_0"]["bias"][cases.NUM_CLASSES::cases.NUM_CLASSES + 1] += SSD_BG
    jlosses, jgrads, jouts, jeouts, jdets, jstats = _jax_run(name, jdet, variables, jb)

    det = build_detector(model, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    det.eval()
    with torch.no_grad():
        eouts = det.bbox_head(det.extract_feat(tb["img"]))
        dets = det.simple_test(tb)
    det.train()
    det.backbone.requires_grad_(False)          # the head's gradients are compared
    losses = det.forward_train(tb, UniformDraws())
    sum(losses.values()).backward()
    stats = {k: v.clone() for k, v in det.state_dict().items() if ".running_" in k
             and not k.startswith("backbone.layer") and not k.startswith("backbone.bn1")}
    with torch.no_grad():
        feats = det.extract_feat(tb["img"])
        outs = det.bbox_head(feats)
    head64 = copy.deepcopy(det.bbox_head).double()
    head64.zero_grad()
    feats = [f.double() for f in feats]
    kw = {"gt_masks": tb["gt_masks"].double()} if name in MASKS else {}
    l64 = head64.loss(head64(feats), tb["gt_bboxes"].double(), tb["gt_valid"], tb["gt_labels"],
                      **kw)
    sum(l64.values()).backward()
    return dict(name=name, det=det, losses=losses, outs=outs, eouts=eouts, dets=dets, tb=tb,
                jlosses=jlosses, jouts=jouts, jeouts=jeouts, jdets=jdets, head64=head64,
                stats=stats, jdet=jdet, variables=variables, jb=jb,
                jstats=jax_variables_to_state_dict(
                    {"batch_stats": jax.tree_util.tree_map(np.asarray, jstats)}),
                jgrads=jax_variables_to_state_dict(
                    {"params": {"head": jax.tree_util.tree_map(np.asarray, jgrads)}}))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_head_outputs_match_jax(head, mode):
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
    # a conv bias before a GroupNorm or a live BN: its true gradient is 0
    before_norm = {f"{n}.conv.bias" for n, m in det.bbox_head.named_modules()
                   if isinstance(m, ConvGN) or (isinstance(getattr(m, "bn", None), BatchNorm)
                                                and getattr(m.conv, "bias", None) is not None)}
    tol, tol64 = WIDER.get(name, (GRAD_TOL, 1e-4))
    assert {f"bbox_head.{k}" for k, _ in det.bbox_head.named_parameters()} == set(want)
    for k, p in det.bbox_head.named_parameters():
        w = want[f"bbox_head.{k}"].numpy()
        msg = f"{name} {k}"
        if k.startswith("segm_conv."):          # built, never in a loss
            assert p.grad is None and ref[k].grad is None and not np.abs(w).any(), msg
            continue
        g, r = p.grad.numpy(), ref[k].grad.numpy()
        if k in before_norm:
            assert max(np.abs(g).max(), np.abs(w).max(), np.abs(r).max()) <= 1e-5 * top, msg
            continue
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=msg + " vs JAX")
        np.testing.assert_allclose(g, r, rtol=0, atol=tol64 * max(float(np.abs(r).max()),
                                                                  1e-3 * top),
                                   err_msg=msg + " vs float64")


def test_live_bn_statistics_match_jax(head):
    stats, want = head["stats"], head["jstats"]
    assert len(stats) == 2 * LIVE[head["name"]]
    for k, v in stats.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_detections_match_jax(head):
    name = head["name"]
    got, want = head["dets"], [np.asarray(t) for t in head["jdets"]]
    if name == "solo":
        masks, labels, scores = (t.numpy() for t in got)
        jm, jl, js = want
        valid = scores > 0
        np.testing.assert_array_equal(valid, js > 0)
        assert valid.sum() >= 3
        np.testing.assert_array_equal(labels[valid], jl[valid])
        np.testing.assert_allclose(scores, js, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(masks[valid], jm[valid])
        return
    dets, labels, valid = (t.numpy() for t in got[:3])
    jd, jl, jv = want[:3]
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels[valid], jl[valid])
    assert valid.sum() >= 3
    np.testing.assert_allclose(dets[..., :4], jd[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets[..., 4], jd[..., 4], rtol=1e-5, atol=1e-7)
    if name == "yolact":
        np.testing.assert_allclose(got[3].numpy()[valid], want[3][valid], rtol=0, atol=1e-5)
