"""The one-stage family's seven heads of the port against the JAX package, on
the CPU: FCOS, ATSS, GFL, VFNet, TOOD, PAA and AutoAssign, each on the tiny
R18-FPN-16 model of its published config (``torch_onestage_cases.tiny_model``:
ResNet-18, FPN and head at 16 channels, one conv a tower, 8 classes), two
64x96 images with seeded gts (one padded), seeded numpy weights loaded into
both packages (``jax_variables_to_state_dict``, strict).

The JAX side runs its R18-FPN once for each of the three backbone and neck
variants of the seven (``extract_feat``; FCOS's caffe ResNet with ReLU before
the extra convs, PAA's extra convs on the input, the rest's on the output),
shared by the configs of that variant, and its head's forward, loss,
gradient (w.r.t. the head's parameters) and ``get_bboxes`` in one jitted
function; the port runs the whole model (``forward_train``,
``simple_test``). Tolerances:

- head outputs: within 1e-4 of the output's largest magnitude over the
  levels (the top levels are 1x1 and 1x2 maps, where GroupNorm of one
  channel a group divides by a near-zero deviation);
- losses: rtol 1e-5;
- the head's gradients, each leaf against JAX's within ``GRAD_TOL`` (1e-4)
  of its largest JAX magnitude (floored at 1e-3 of the head's largest JAX
  gradient), a bound that reads nothing of the port's output; ``WIDER``
  lists the leaves held to more, each with its reading: flax's GroupNorm
  forms ``E[x^2] - E[x]^2`` in float32, which puts JAX's gradient of
  ATSS's first class conv 7.6e-4 of its largest from a float64 evaluation
  of JAX's head (``jax.enable_x64``), where the port's is within 4e-5 of
  it. Besides, each leaf within 1e-4 of its largest magnitude of a float64
  evaluation of the port's head on the same features. A conv bias before
  a GroupNorm has a true gradient of 0: both packages' are within 1e-5 of
  the head's largest JAX gradient (float32 noise);
- ``simple_test``: valid rows and labels exact, boxes within 1e-5 of the
  largest coordinate, scores rtol 1e-5.
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
OUTPUTS = {"fcos": 3, "atss": 3, "gfl": 2, "vfnet": 3, "tood": 2, "paa": 3, "autoassign": 3}
GRAD_TOL = 1e-4
WIDER = {"atss": (("cls_convs.0.conv.weight",), 1.5e-3)}          # read: 7.2e-4


def _jax_side(model, jb):
    """The variables, JAX's head's losses, parameter gradients, outputs and
    ``get_bboxes`` on the variant's features."""
    jdet = jax_build_detector(model)
    backbone, feats = cases.jax_backbone(model, jb)
    shapes = jax.eval_shape(lambda r, f: jdet.init(r, f, method=lambda m, f: m.head(f)),
                            jax.random.PRNGKey(0), feats)
    variables = {"params": dict(backbone["params"], **cases.randomize(shapes["params"], 5)),
                 "batch_stats": backbone["batch_stats"]}
    return variables, cases.jax_head_run(jdet, variables, feats, jb)


@pytest.fixture(scope="module", params=cases.FIRST)
def head(request):
    name = request.param
    model = cases.tiny_model(name)
    batch = cases.batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables, (jlosses, jgrads, jouts, jdets) = _jax_side(model, jb)

    det = build_detector(model, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    det.train()
    losses = det.forward_train(tb, UniformDraws())
    sum(losses.values()).backward()
    # the float64 reference: the port's head on the same (float32) features
    head64 = copy.deepcopy(det.bbox_head).double()
    head64.zero_grad()
    with torch.no_grad():
        feats = [f.double() for f in det.extract_feat(tb["img"])]
    l64 = head64.loss(head64(feats), tb["gt_bboxes"].double(), tb["gt_valid"], tb["gt_labels"])
    sum(l64.values()).backward()
    det.eval()
    with torch.no_grad():
        outs = det.bbox_head(det.extract_feat(tb["img"]))
        dets = det.simple_test(tb)
    return dict(name=name, det=det, losses=losses, outs=outs, dets=dets, jlosses=jlosses,
                jouts=jouts, jdets=jdets, head64=head64,
                jgrads=jax_variables_to_state_dict(
                    {"params": {"head": jax.tree_util.tree_map(np.asarray, jgrads)}}))


def test_head_outputs_match_jax(head):
    outs, jouts = head["outs"], head["jouts"]
    assert len(outs) == len(jouts) == OUTPUTS[head["name"]]
    for i, (levels, jlevels) in enumerate(zip(outs, jouts)):
        assert len(levels) == len(jlevels) == 5
        scale = max(float(np.abs(np.asarray(j)).max()) for j in jlevels)
        for li, (got, want) in enumerate(zip(levels, jlevels)):
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{head['name']} output {i} level {li}")


def test_losses_match_jax(head):
    losses, jlosses = head["losses"], head["jlosses"]
    assert sorted(losses) == sorted(jlosses)
    for k, v in losses.items():
        assert v.dtype == torch.float32 and torch.isfinite(v)
        np.testing.assert_allclose(float(v.detach()), float(jlosses[k]), rtol=1e-5,
                                   err_msg=f"{head['name']} {k}")
        assert float(v.detach()) > 0


def test_head_gradients_match_jax(head):
    det, want, name = head["det"], head["jgrads"], head["name"]
    ref = dict(head["head64"].named_parameters())
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    before_gn = {f"{n}.conv.bias" for n, m in det.bbox_head.named_modules()
                 if isinstance(m, ConvGN)}                  # none in PAA's RetinaHead towers
    wider, wide_tol = WIDER.get(name, ((), GRAD_TOL))
    for k, p in det.bbox_head.named_parameters():
        r = ref[k].grad.numpy()
        w = want[f"bbox_head.{k}"].numpy()
        g = p.grad.numpy()
        msg = f"{name} {k}"
        if k in before_gn:
            assert max(np.abs(g).max(), np.abs(w).max(), np.abs(r).max()) <= 1e-5 * top, msg
            continue
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        tol = wide_tol if k.startswith(wider) else GRAD_TOL
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=msg + " vs JAX")
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(float(np.abs(r).max()),
                                                                 1e-3 * top),
                                   err_msg=msg + " vs float64")


def test_simple_test_matches_jax(head):
    dets, labels, valid = (t.numpy() for t in head["dets"])
    jd, jl, jv = (np.asarray(t) for t in head["jdets"])
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(labels, jl)
    assert valid.sum() >= 10
    np.testing.assert_allclose(dets[..., :4], jd[..., :4], rtol=0,
                               atol=1e-5 * np.abs(jd[..., :4]).max())
    np.testing.assert_allclose(dets[..., 4], jd[..., 4], rtol=1e-5, atol=1e-7)
