"""The port's serving path against the JAX package, end to end, on the CPU.

The tiny flagship config (``__graft_entry__._flagship_model_cfg(tiny=True)``:
ContrastiveRoIHead + Shared2FCContrastiveHead over an R18-FPN at 16
channels) with a small test_cfg serves two 64x96 images (the second with a
smaller valid region and a scale factor, so clipping and rescaling show).
The JAX detector is initialized once, its frozen BN and head weights are
randomized so that scores are well separated, and its variables go to the
port through ``jax_variables_to_state_dict`` with ``strict=True``.

Tolerances: feature maps, RPN outputs and RoI features rtol=1e-4,
atol=1e-5 (convolution sums reassociate); head outputs rtol=1e-4 with an
absolute floor of 2e-6 times their largest magnitude (the randomized head
reaches logits near 20, and the FC sums reassociate too); proposals and
final boxes atol=1e-3 px; validity, labels and the proposal and detection
order exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _batch():
    rng = np.random.RandomState(0)
    return {
        "img": rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32),
        "img_shape": np.array([[64, 96], [56, 80]], np.float32),
        "scale_factor": np.array([[1, 1, 1, 1], [1.25, 1.25, 1.25, 1.25]],
                                 np.float32),
    }


def _randomize(variables, seed=1):
    """Random frozen-BN statistics; larger RPN and box-head weights so that
    objectness and class scores are far apart relative to float32 noise."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, sub in params.items():
            if k.startswith("FrozenBN") or k == "downsample_bn":
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(k, {}))

    walk(v["params"], v["batch_stats"])
    for scope, std in ((("rpn", "rpn_cls", "Conv_0"), 1.0),
                       (("rpn", "rpn_reg", "Conv_0"), 0.1),
                       (("roi", "head", "fc_cls"), 1.0),
                       (("roi", "head", "fc_reg"), 0.3)):
        node = v["params"]
        for k in scope:
            node = node[k]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    return v


def _jax_pieces(module, batch):
    feats = module.extract_feat(batch["img"])
    cls_scores, bbox_preds = module.rpn(feats)
    boxes, _, valid = module.rpn.get_proposals(
        cls_scores, bbox_preds, batch["img_shape"], dict(module.test_cfg)["rpn"])
    n, p = boxes.shape[:2]
    bidx = jnp.repeat(jnp.arange(n, dtype=jnp.float32), p).reshape(n, p)
    rois = jnp.concatenate([bidx[..., None], boxes], -1).reshape(-1, 5)
    roi_feats = module.roi.extract(feats, rois)
    cls_score, bbox_pred, _ = module.roi.head(roi_feats)
    dets, labels, det_valid = module.roi.simple_test(
        feats, boxes, valid, batch["img_shape"], batch["scale_factor"])
    return dict(feats=feats, cls_scores=cls_scores, bbox_preds=bbox_preds,
                proposals=boxes, prop_valid=valid, roi_feats=roi_feats,
                cls_score=cls_score, bbox_pred=bbox_pred, dets=dets,
                labels=labels, det_valid=det_valid)


def _port_pieces(det, batch):
    with torch.inference_mode():
        feats = det.extract_feat(batch["img"])
        cls_scores, bbox_preds = det.rpn_head(feats)
        boxes, _, valid = det.rpn_head.get_proposals(cls_scores, bbox_preds,
                                                     batch["img_shape"])
        roi_feats = det.roi_head.bbox_roi_extractor(
            feats, det.roi_head.proposals_to_rois(boxes))
        cls_score, bbox_pred, _ = det.roi_head.bbox_head(roi_feats)
        dets, labels, det_valid = det.roi_head.simple_test(
            feats, boxes, valid, batch["img_shape"], batch["scale_factor"])
    return dict(feats=feats, cls_scores=cls_scores, bbox_preds=bbox_preds,
                proposals=boxes, prop_valid=valid, roi_feats=roi_feats,
                cls_score=cls_score, bbox_pred=bbox_pred, dets=dets,
                labels=labels, det_valid=det_valid)


@pytest.fixture(scope="module")
def run():
    _, model = _flagship_model_cfg(tiny=True)
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=1)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jbatch))
    want = jax.jit(lambda v, b: jdet.apply(v, b, method=_jax_pieces))(
        variables, jbatch)
    want = jax.tree_util.tree_map(np.asarray, want)

    handle = init_detector({"model": model}, device="cpu")
    handle.model.load_state_dict(
        jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    got = _port_pieces(handle.model, tbatch)
    return want, got, handle, tbatch


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def test_fpn_outputs(run):
    want, got, _, _ = run
    assert len(got["feats"]) == len(want["feats"]) == 5
    for g, w in zip(got["feats"], want["feats"]):
        np.testing.assert_allclose(_nhwc(g), w, **FEAT_TOL)


def test_rpn_outputs(run):
    want, got, _, _ = run
    for key in ("cls_scores", "bbox_preds"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(_nhwc(g), w, **FEAT_TOL)


def test_proposals(run):
    want, got, _, _ = run
    np.testing.assert_array_equal(got["prop_valid"].numpy(), want["prop_valid"])
    assert want["prop_valid"].sum() > 20
    np.testing.assert_allclose(got["proposals"].numpy(), want["proposals"],
                               rtol=0, atol=1e-3)


def test_roi_features(run):
    want, got, _, _ = run
    assert got["roi_feats"].shape == (60, 16, 7, 7)
    np.testing.assert_allclose(_nhwc(got["roi_feats"]), want["roi_feats"],
                               **FEAT_TOL)


def test_box_head_outputs(run):
    want, got, _, _ = run
    for key in ("cls_score", "bbox_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=2e-6 * np.abs(want[key]).max())


def test_detections(run):
    want, got, _, _ = run
    np.testing.assert_array_equal(got["det_valid"].numpy(), want["det_valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["dets"].numpy(), want["dets"], rtol=0, atol=1e-3)
    assert got["dets"].shape == (2, 10, 5)
    assert 5 <= int(got["det_valid"].sum()) and len(np.unique(want["labels"])) > 1


def test_detector_handle_serves_the_same(run):
    want, _, handle, tbatch = run
    before = ROI_ALIGN_FWD.launches
    dets, labels, valid = handle.test(tbatch)
    assert ROI_ALIGN_FWD.launches == before           # CPU: the plain version
    np.testing.assert_array_equal(valid.numpy(), want["det_valid"])
    np.testing.assert_array_equal(labels.numpy(), want["labels"])
    np.testing.assert_allclose(dets.numpy(), want["dets"], rtol=0, atol=1e-3)


def test_prepare_image_matches_jax_normalize_and_pad():
    from oadg_tpu.data.pipelines.transforms import Normalize, Pad
    from oadg_tpu_torch.apis import prepare_image
    from oadg_tpu_torch.config import load_config
    cfg = load_config("configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py")
    img = np.random.RandomState(5).randint(0, 256, (50, 70, 3), dtype=np.uint8)
    res = Pad(size_divisor=32)(Normalize(**cfg.img_norm_cfg)(dict(img=img.copy())))
    batch = prepare_image(img, cfg, "cpu")
    assert batch["img"].shape == (1, 3, 64, 96)
    np.testing.assert_array_equal(_nhwc(batch["img"])[0], res["img"])
    np.testing.assert_array_equal(batch["img_shape"].numpy(), [[50, 70]])
    np.testing.assert_array_equal(batch["scale_factor"].numpy(), np.ones((1, 4)))
