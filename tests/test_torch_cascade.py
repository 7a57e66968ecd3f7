"""Cascade R-CNN's RoI head in the port against the JAX package, on the CPU.

``configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py``'s RoI head made
tiny (``torch_twostage_cases.tiny_roi``: 16 channels, FCs of 32, 8 classes,
samplers of 32) on seeded FPN maps, gts and proposals. The JAX head's
seeded variables go to the port through ``jax_variables_to_state_dict``;
the JAX loss runs with a fixed key and the port is handed the uniforms
that each stage's sampler draws from it, so both sample the same boxes.

Tolerances: each stage's losses rtol 1e-5 (``acc`` exactly: the same
predictions); every parameter's and every FPN map's gradient within 1e-4
of its largest magnitude; the refined boxes each stage hands the next
within 1e-5 of the largest coordinate; ``simple_test``'s valid detections
the same, labels exact, boxes within 1e-4 of the largest coordinate and
scores within 1e-5 (the convolutions and sums run in other orders).

Then the whole tiny detector's ``simple_test`` (JAX's variables made with
``jax.eval_shape`` and numpy), the detector's route of a cascade with a
mask head to the HTC head, the weight map and mmdet's checkpoint keys, the
reference-side faults (ROADMAP C: JAX's ``forward_train`` passes
``gt_masks`` to a cascade that takes none; JAX's ``aug_test`` reads
``roi.head``), and the list-indexed ``--cfg-options`` that give the three
box heads 8 classes.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_twostage_cases as cases
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict, load_mmdet_checkpoint
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def run():
    model = cases.tiny_roi(cases.load_model("cascade", "jax"))
    jhead = cases.jax_head(model)
    case = cases.inputs(0)
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]))
    shapes = jnp.asarray([[cases.H, cases.W]] * cases.N, jnp.float32)
    sf = jnp.ones((cases.N, 4), jnp.float32)
    params = cases.randomize(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, KEY, method="loss"))["params"])

    def loss_fn(p, feats):
        losses, chain = jhead.apply({"params": p}, feats, *args, KEY,
                                    method=lambda m, *a: m._cascade_stages(*a))
        return sum(v for k, v in losses.items() if "loss" in k), (losses, chain)

    (_, (jlosses, jchain)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, jf)
    jtest = jax.jit(lambda p: jhead.apply({"params": p}, jf, args[0], args[1], shapes, sf,
                                          method="simple_test"))(params)

    head = cases.port_head(cases.tiny_roi(cases.load_model("cascade", "torch")))
    head.load_state_dict(cases.port_state(params), strict=True)
    feats, t = cases.to_torch(case)
    draws = UniformDraws(given=cases.cascade_draws(KEY))
    losses, chain = head._cascade_stages(feats, t["props"], t["prop_valid"], t["gt"],
                                         t["gt_valid"], t["labels"], draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    with torch.no_grad():
        test = head.simple_test([f.detach() for f in feats], t["props"], t["prop_valid"],
                                torch.from_numpy(np.asarray(shapes)), torch.ones(cases.N, 4))
    return dict(jlosses=jlosses, jchain=jchain, jgrads=jgrads, jtest=jtest, head=head,
                losses=losses, chain=chain, feats=feats, test=test, params=params)


KEYS = [f"s{k}.{n}" for k in range(3) for n in ("loss_cls", "loss_bbox", "acc")]


@pytest.mark.parametrize("key", KEYS)
def test_cascade_stage_losses_match_jax(run, key):
    assert set(run["losses"]) == set(run["jlosses"]) == set(KEYS)
    want, got = float(run["jlosses"][key]), run["losses"][key].item()
    if key.endswith("acc"):
        assert got == pytest.approx(want, rel=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got > 0


def test_cascade_gradients_match_jax(run):
    """Every box head's parameters and the four RoIAlign levels' maps (the
    fifth, unused by RoIAlign, gets none on either side)."""
    want = cases.port_state(run["jgrads"][0])
    named = dict(run["head"].named_parameters())
    assert set(named) == set(want) and len(named) == 3 * 8
    for name, p in named.items():
        assert p.grad is not None and np.abs(want[name].numpy()).max() > 0, name
        cases.close_grads(p.grad.numpy(), want[name].numpy(), err_msg=name)
    for i, (f, jg) in enumerate(zip(run["feats"], run["jgrads"][1])):
        jg = np.asarray(jg).transpose(0, 3, 1, 2)
        if i == 4:
            assert f.grad is None and not jg.any()
            continue
        cases.close_grads(f.grad.numpy(), jg, err_msg=f"level {i}")


def test_cascade_refined_boxes_match_jax(run):
    """Stage k's sampled boxes refined by its regressor (without
    ``max_shape``) and their validity: the candidates of stage k + 1."""
    for k, ((boxes, valid), (jb, jv)) in enumerate(zip(run["chain"], run["jchain"])):
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv), err_msg=f"stage {k}")
        jb = np.asarray(jb)
        np.testing.assert_allclose(boxes.numpy(), jb, rtol=0, atol=1e-5 * np.abs(jb).max(),
                                   err_msg=f"stage {k}")


def _same_dets(got, want, box_tol=1e-4):
    jd, jl, jv = (np.asarray(x) for x in want)
    td, tl, tv = (x.numpy() for x in got)
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl[tv], jl[jv])
    np.testing.assert_allclose(td[tv][:, :4], jd[jv][:, :4], rtol=0,
                               atol=box_tol * np.abs(jd[jv][:, :4]).max())
    np.testing.assert_allclose(td[tv][:, 4], jd[jv][:, 4], rtol=0, atol=1e-5)


def test_cascade_simple_test_matches_jax(run):
    """Three stages refined with ``max_shape``, the stage-averaged softmax,
    the last stage's deltas on its input boxes, padded proposals zeroed."""
    _same_dets(run["test"], run["jtest"])


def _jax_variables(det, batch, seed=0):
    """Seeded numpy variables of a whole JAX detector from its shapes
    (``jax.eval_shape``; no compiled init): LeCun-normal kernels, small
    biases, identity frozen BN."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: det.init({"params": jax.random.PRNGKey(0),
                                              "sampling": jax.random.PRNGKey(1)}, batch, "test"))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return (rng.normal(0, 0.05, s.shape) if name == "bias"
                else np.zeros(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_tiny_cascade_detector_simple_test_matches_jax():
    """The slice end to end at tiny size: R18-FPN, RPN proposals, the three
    stages and the NMS, with JAX's weights."""
    model = cases.tiny_model(cases.load_model("cascade", "jax"))
    jdet = jax_build_detector(model, num_views=1)
    rng = np.random.RandomState(3)
    img = rng.normal(0, 1, (cases.N, cases.H, 96, 3)).astype(np.float32)
    batch = {"img": jnp.asarray(img),
             "img_shape": jnp.asarray([[64, 96], [60, 90]], jnp.float32),
             "scale_factor": jnp.ones((cases.N, 4), jnp.float32)}
    variables = _jax_variables(jdet, batch)
    want = jax.jit(lambda v, b: jdet.apply(v, b, "test"))(variables, batch)
    det = build_detector(cases.tiny_model(cases.load_model("cascade", "torch")), device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=cases.C),
                        strict=True)
    det.eval()
    with torch.no_grad():
        got = det.simple_test({"img": torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
                               "img_shape": torch.tensor([[64., 96.], [60., 90.]]),
                               "scale_factor": torch.ones(cases.N, 4)})
    _same_dets(got, want)


def test_cascade_with_a_mask_head_builds_the_htc_head_as_jax_routes_it():
    """A ``CascadeRoIHead`` config with a ``mask_head`` (Cascade Mask R-CNN,
    ``configs/_base_/models/cascade_mask_rcnn_r50_fpn.py``) builds
    ``HybridTaskCascadeRoIHead`` without the info flow or the semantic
    fusion, in both packages (``two_stage.py:86-95``)."""
    path = os.path.join(cases.ROOT, "configs/_base_/models/cascade_mask_rcnn_r50_fpn.py")
    cfg = load_config(path)
    assert cfg.model.roi_head.type == "CascadeRoIHead" and cfg.model.roi_head.mask_head
    det = build_detector(dict(cfg.model), device="meta")
    head = det.roi_head
    assert type(head).__name__ == "HybridTaskCascadeRoIHead"
    assert not head.mask_info_flow and head.semantic_fusion == () and head.semantic_head is None
    assert not hasattr(head, "info_convs") and len(head.mask_head) == 3
    assert not any(k.startswith("roi_head.info_convs") for k in det.state_dict())
    from oadg_tpu.config import Config
    jmodel = Config.fromfile(path, import_custom_modules=False)["model"]
    jroi = jax_build_detector(jmodel, num_views=1).bind({}).roi
    assert type(jroi).__name__ == "HybridTaskCascadeRoIHead"
    assert not jroi.mask_info_flow and tuple(jroi.semantic_fusion) == ()


def test_cascade_weight_map_is_total_under_mmdet_names(run):
    """Every JAX leaf maps to one port tensor and back: ``heads_k`` to
    mmdet's ``roi_head.bbox_head.{k}.*``, the first FC reordered from the
    JAX package's HWC flattening to mmdet's CHW."""
    sd = jax_variables_to_state_dict({"params": {"roi": jax.tree_util.tree_map(
        np.asarray, run["params"])}}, roi_channels=cases.C)
    own = {f"roi_head.{k}": v for k, v in run["head"].state_dict().items()}
    assert set(sd) == set(own)
    assert "roi_head.bbox_head.2.shared_fcs.0.weight" in sd
    w = np.asarray(run["params"]["heads_1"]["shared_fc0"]["kernel"])     # (7*7*C, 32), HWC
    got = sd["roi_head.bbox_head.1.shared_fcs.0.weight"].numpy()         # (32, C*7*7)
    c, y, x = 5, 2, 3
    np.testing.assert_array_equal(got[:, c * 49 + y * 7 + x], w[(y * 7 + x) * cases.C + c])


def test_cascade_loads_an_mmdet_checkpoint_and_htc_one_raises(tmp_path):
    """A cascade checkpoint under mmdet's keys (``roi_head.bbox_head.{k}``,
    ``num_batches_tracked`` beside) loads whole; an mmdet HTC checkpoint
    lacks the JAX head's ``info_convs`` (mmdet has ``mask_head.{k}.conv_res``
    instead), so loading it raises (ROADMAP C)."""
    model = cases.tiny_model(cases.load_model("cascade", "torch"))
    det = build_detector(model, device="cpu")
    gen = torch.Generator().manual_seed(4)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in det.state_dict().items()}
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "cascade.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    report = load_mmdet_checkpoint(det, str(path))
    assert len(report["loaded"]) == len(sd) - 1 and not report["missing"]
    for k, v in det.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    htc = build_detector(cases.tiny_model(cases.load_model("htc", "torch")), device="cpu")
    mm = {k: v.clone() for k, v in htc.state_dict().items() if ".info_convs." not in k}
    mm["roi_head.mask_head.1.conv_res.conv.weight"] = torch.zeros(cases.C, cases.C, 1, 1)
    with pytest.raises(KeyError, match="info_convs"):
        load_mmdet_checkpoint(htc, mm)


def test_jax_cascade_forward_train_raises_the_port_trains_it():
    """JAX's ``forward_train`` passes ``gt_masks=`` to every RoI head
    (``two_stage.py:191-195``); ``CascadeRoIHead.loss`` takes no such
    argument, so a JAX Cascade R-CNN cannot train (ROADMAP C). The port's
    cascade takes it and reads nothing of it."""
    model = cases.tiny_model(cases.load_model("cascade", "jax"))
    jdet = jax_build_detector(model, num_views=1)
    rng = np.random.RandomState(4)
    case = cases.inputs(1)
    batch = {"img": jnp.asarray(rng.normal(0, 1, (cases.N, 64, 64, 3)).astype(np.float32)),
             "img_shape": jnp.full((cases.N, 2), 64.0), "gt_bboxes": jnp.asarray(case["gt"]),
             "gt_labels": jnp.asarray(case["labels"]), "gt_valid": jnp.asarray(case["gt_valid"])}
    with pytest.raises(TypeError, match="gt_masks"):
        jax.eval_shape(lambda: jdet.init({"params": jax.random.PRNGKey(0),
                                          "sampling": jax.random.PRNGKey(1)}, batch, "train"))
    det = build_detector(cases.tiny_model(cases.load_model("cascade", "torch")), device="cpu")
    det.init_weights(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    tb["gt_labels"] = tb["gt_labels"].long()
    losses = det.forward_train(tb, UniformDraws(torch.Generator().manual_seed(0)))
    assert {k for k in losses if k.startswith("s")} == set(KEYS)
    assert all(bool(torch.isfinite(v)) for v in losses.values())


def test_cascade_aug_test_is_refused():
    """JAX's ``aug_test`` reads ``roi.head``, which ``CascadeRoIHead`` lacks
    (``two_stage.py:275-278``); the port's refuses the cascade family with
    a ``ValueError``."""
    det = build_detector(cases.tiny_model(cases.load_model("cascade", "torch")), device="cpu")
    view = {"img": torch.zeros(1, 3, 64, 64), "img_shape": torch.tensor([[64., 64.]]),
            "scale_factor": torch.ones(1, 4)}
    with pytest.raises(ValueError, match="cascade"):
        det.aug_test([view], [(False, "horizontal")])
    import oadg_tpu.models.roi_heads.cascade_roi_head as jcascade
    assert not hasattr(jcascade.CascadeRoIHead, "head")


def test_list_indexed_cfg_options_give_every_stage_8_classes():
    """The cascade configs pair 80 classes with the 8-class Cityscapes
    base: ``--cfg-options model.roi_head.bbox_head.{0,1,2}.num_classes=8``
    (list indices) sets each stage; the class check reads all three and
    refuses stages that disagree."""
    import argparse
    from oadg_tpu_torch.apis.inference import _num_classes
    from oadg_tpu_torch.config import DictAction
    parser = argparse.ArgumentParser()            # as tools/torch_train.py parses them
    parser.add_argument("--cfg-options", nargs="+", action=DictAction)
    cfg = load_config(os.path.join(cases.ROOT, cases.CONFIGS["cascade"]))
    assert _num_classes(cfg) == 80
    cfg.merge_from_dict(parser.parse_args(
        ["--cfg-options", "model.roi_head.bbox_head.0.num_classes=8",
         "model.roi_head.bbox_head.1.num_classes=8"]).cfg_options)
    assert isinstance(cfg.model.roi_head.bbox_head, list)
    with pytest.raises(ValueError, match="disagree"):
        _num_classes(cfg)
    cfg.merge_from_dict(parser.parse_args(
        ["--cfg-options", "model.roi_head.bbox_head.2.num_classes=8"]).cfg_options)
    assert _num_classes(cfg) == 8
    det = build_detector(dict(cfg.model), device="meta")
    assert [h.num_classes for h in det.roi_head.bbox_head] == [8, 8, 8]
