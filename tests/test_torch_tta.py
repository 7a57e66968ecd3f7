"""The port's test-time paths against the JAX package's, on the CPU:
test-time augmentation (TTA) of the two-stage and single-stage detectors,
its collation and dispatch, soft-NMS, and ``async_inference_detector``.

Models: the tiny R18 Faster R-CNN of ``tests/test_tta.py`` (128x128 JAX
init; ``min_bbox_size=1`` for the reason given there) and the tiny YOLOv3 of
``tests/torch_yolo_cases.py``, the JAX weights carried over by
``jax_variables_to_state_dict``.

Tolerances: TTA detections in float32 have the same count and labels,
boxes within 1e-4 px and scores within 1e-5 (the two packages compute the
same float32 ops; convolutions sum in other orders); soft-NMS keeps the
same set with scores within 1e-6. Where the JAX package is at fault (ROADMAP
C) the test shows the fault and holds the port to mmdet's semantics.
"""
import asyncio
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_data_cases as dcases
import torch_yolo_cases as ycases
from test_tta import HW, MODEL, TEST_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_TOL, SCORE_TOL = 1e-4, 1e-5
H, V = ("horizontal", "vertical")


def port_model_cfg(test_cfg=TEST_CFG):
    """``test_tta.py``'s model for the port (its RoI extractor named)."""
    m = copy.deepcopy(MODEL)
    m["test_cfg"] = copy.deepcopy(test_cfg)
    m["roi_head"]["bbox_roi_extractor"] = dict(
        type="SingleRoIExtractor", out_channels=16, **m["roi_head"]["bbox_roi_extractor"])
    return m


def port_detector(model_cfg, variables):
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    det = build_detector(model_cfg, device="cpu")
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return det.eval()


def np_batch(img, flip=False, scale=1.0, direction=H):
    """One (1, h, w, 3) float32 view of ``img`` (resized by ``scale`` with
    JAX's bilinear resize, then flipped) with its shape and scale factor."""
    h, w = int(round(img.shape[1] * scale)), int(round(img.shape[2] * scale))
    x = np.asarray(jax.image.resize(jnp.asarray(img), (1, h, w, 3), "bilinear"))
    if flip:
        x = x[:, :, ::-1] if direction == H else x[:, ::-1]
    return {"img": np.array(x, np.float32),
            "img_shape": np.asarray([[h, w]], np.float32),
            "scale_factor": np.asarray([[w / img.shape[2], h / img.shape[1]] * 2], np.float32)}


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items() if k != "metas"}


def as_torch(b):
    t = {k: torch.from_numpy(np.array(v)) for k, v in b.items() if k != "metas"}
    t["img"] = t["img"].permute(0, 3, 1, 2).contiguous()
    return t


def valid_dets(out, i=0):
    d, l, v = (np.asarray(x) for x in out)
    return d[i][v[i]], l[i][v[i]]


def assert_dets_close(got, want, min_count=1, box_tol=BOX_TOL):
    (gd, gl), (wd, wl) = valid_dets(got), valid_dets(want)
    assert len(gd) == len(wd) >= min_count
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=box_tol)
    np.testing.assert_allclose(gd[:, 4], wd[:, 4], rtol=0, atol=SCORE_TOL)


@pytest.fixture(scope="module")
def frcnn():
    from oadg_tpu.models import build_detector as jax_build_detector
    det = jax_build_detector(MODEL, None, TEST_CFG, num_views=1)
    img = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, HW, HW, 3)))
    batch = np_batch(img)
    variables = jax.jit(lambda r, b: det.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, as_jax(batch))
    return dict(jdet=det, variables=variables, img=img, batch=batch,
                port=port_detector(port_model_cfg(), variables))


def jax_aug(run, metas, views, det=None, variables=None):
    from oadg_tpu.engine.train_step import make_aug_test_step
    variables = variables or run["variables"]
    return make_aug_test_step(det or run["jdet"], metas)(
        variables["params"], variables.get("batch_stats"), tuple(as_jax(v) for v in views))


def test_identity_tta_equals_simple_test(frcnn):
    from oadg_tpu.engine.train_step import make_test_step as jax_make_test_step
    port, tb = frcnn["port"], as_torch(frcnn["batch"])
    with torch.inference_mode():
        plain = port.simple_test(tb)
        aug = port.aug_test([tb, dict(tb)], ((False, H), (False, H)))
    assert_dets_close(aug, plain, min_count=5)
    v = frcnn["variables"]
    assert_dets_close(aug, jax_make_test_step(frcnn["jdet"])(
        v["params"], v.get("batch_stats"), as_jax(frcnn["batch"])), min_count=5)


def test_single_flip_view_maps_back_exactly(frcnn):
    """A flipped view alone: ``simple_test`` on the flipped image, its boxes
    flipped back (``x -> W - x``), equals ``aug_test`` of that view, and the
    JAX package's ``aug_test``."""
    port = frcnn["port"]
    fb = np_batch(frcnn["img"], flip=True)
    with torch.inference_mode():
        plain = port.simple_test(as_torch(fb))
        aug = port.aug_test([as_torch(fb)], ((True, H),))
    a, la = valid_dets(plain)
    b, lb = valid_dets(aug)
    back = a.copy()
    back[:, 0], back[:, 2] = HW - a[:, 2], HW - a[:, 0]
    o0, o1 = np.lexsort(back[:, :2].T), np.lexsort(b[:, :2].T)
    assert len(back) == len(b) > 0
    np.testing.assert_allclose(back[o0], b[o1], atol=BOX_TOL)
    assert (la[o0] == lb[o1]).all()
    assert_dets_close(aug, jax_aug(frcnn, ((True, H),), [fb]))


@pytest.mark.parametrize("direction", [H, V])
def test_two_scales_and_flip_match_jax_make_aug_test_step(frcnn, direction):
    """Four views (128 and 96 px, each plain and flipped) through the port's
    ``make_aug_test_step`` (numpy loader batches) and the JAX package's."""
    from oadg_tpu_torch.engine.train_step import make_aug_test_step
    metas = ((False, direction), (True, direction)) * 2
    views = [np_batch(frcnn["img"], flip=f, scale=s, direction=direction)
             for s in (1.0, 0.75) for f in (False, True)]
    got = make_aug_test_step(frcnn["port"], metas)(views)
    assert_dets_close(got, jax_aug(frcnn, metas, views), min_count=5)


def test_single_stage_flip_tta_matches_jax():
    """The tiny YOLOv3 (full Darknet-53, narrowed neck and head): a plain and
    a flipped 64x96 view through ``aug_test``, against the JAX package's.
    Boxes within 1e-3 px: the two packages' ``simple_test`` of one view are
    already 3e-4 px apart on boxes of up to ~190 px (52 convolutions summed
    in other orders, then ``exp`` in the decode; ``test_torch_yolo.py``
    holds ``get_bboxes`` to the same 1e-3). A flipped view alone equals the
    port's ``simple_test`` of it, flipped back, within 1e-4 px."""
    from oadg_tpu.engine.train_step import make_aug_test_step as jax_make_aug_test_step
    from oadg_tpu_torch.engine.train_step import make_aug_test_step
    model = ycases.model_cfg()
    jdet = ycases.jax_detector(model, num_views=1)
    img = np.random.RandomState(4).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    views = [np_batch(img), np_batch(img, flip=True)]
    variables = ycases.jax_variables(jdet, views[0])
    for name, sub in variables["params"]["head"].items():     # boxes of a few pixels
        if name.startswith("conv_pred"):
            sub["Conv_0"]["kernel"] = sub["Conv_0"]["kernel"] * np.float32(0.1)
    metas = ((False, H), (True, H))
    want = jax_make_aug_test_step(jdet, metas)(
        variables["params"], variables["batch_stats"], tuple(as_jax(v) for v in views))
    port = port_detector(model, variables)
    got = make_aug_test_step(port, metas)(views)
    assert_dets_close(got, want, min_count=5, box_tol=1e-3)
    with torch.inference_mode():
        plain = port.simple_test(as_torch(views[1]))
        one = port.aug_test([as_torch(views[1])], metas[1:])
    back = plain[0].clone()
    back[..., 0], back[..., 2] = 96 - plain[0][..., 2], 96 - plain[0][..., 0]
    assert_dets_close(one, (back, plain[1], plain[2]), min_count=5)


# ------------------------------------------------ collation and dispatch ----

@pytest.fixture(scope="module")
def tta_loader_run(frcnn, tmp_path_factory):
    """The 4 PNGs of ``torch_data_cases.py`` through the flagship's test
    pipeline with ``MultiScaleFlipAug(img_scale=[(160, 96), (128, 80)],
    flip=True)``: the JAX loader and ``run_test(detector=...)``, the port's
    ``build_test_loader`` and ``single_gpu_test``, the tiny R18 model."""
    from oadg_tpu.apis.test import run_test as jax_run_test
    from oadg_tpu.config import Config
    from oadg_tpu.data import build_dataloader as jax_build_dataloader
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu.engine.train_step import make_test_step as jax_make_test_step
    from oadg_tpu_torch.apis import build_test_loader
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.engine.train_step import make_test_step
    root = tmp_path_factory.mktemp("tta")
    ann_file, img_prefix = dcases.write_dataset(str(root))
    cfg = load_config(os.path.join(ROOT, dcases.FLAGSHIP))
    cfg.merge_from_dict(dcases.cfg_options(ann_file, img_prefix))
    cfg.merge_from_dict({"data.test.pipeline.1.img_scale": [(160, 96), (128, 80)],
                         "data.test.pipeline.1.flip": True})
    jcfg = Config.fromfile(os.path.join(ROOT, dcases.FLAGSHIP), import_custom_modules=False)
    test = copy.deepcopy(cfg.data.test)
    jcfg.merge_from_dict({"data.test": test})
    jds = jax_build_dataset(dict(jcfg.data.test, test_mode=True))
    jloader = jax_build_dataloader(jds, samples_per_gpu=1, workers_per_gpu=2, shuffle=False,
                                   static_hw=(96, 160))
    v = frcnn["variables"]
    want = jax_run_test(jax_make_test_step(frcnn["jdet"]), v["params"], v.get("batch_stats"),
                        jloader, 8, detector=frcnn["jdet"])
    _, loader = build_test_loader(cfg)
    return dict(jloader=jloader, loader=loader, want=want,
                state=dict(test_fn=make_test_step(frcnn["port"]), num_classes=8))


def test_loader_collates_views_as_jax(tta_loader_run):
    got, want = next(iter(tta_loader_run["loader"])), next(iter(tta_loader_run["jloader"]))
    assert got["__tta_metas__"] == want["__tta_metas__"] == (
        (False, H), (True, H), (False, H), (True, H))
    assert len(got["__tta_views__"]) == 4
    for g, w in zip(got["__tta_views__"], want["__tta_views__"]):
        assert sorted(g) == sorted(w)
        for k in ("img", "img_shape", "scale_factor"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert [m["flip"] for m in got["metas"]] == [False]


def test_single_gpu_test_dispatches_tta_as_jax_run_test(tta_loader_run):
    from oadg_tpu_torch.apis import single_gpu_test
    from test_torch_test_loop import assert_results_close
    got = single_gpu_test(tta_loader_run["state"], tta_loader_run["loader"])
    assert_results_close(got, tta_loader_run["want"])
    assert sum(len(r) for img in got for r in img) > 10


def test_the_test_step_sends_a_tta_batch_to_aug_test(tta_loader_run, frcnn):
    """``make_test_step``'s step given a loader's TTA batch returns what
    ``make_aug_test_step(model, metas)`` returns on its views, exactly."""
    from oadg_tpu_torch.engine.train_step import make_aug_test_step
    batch = next(iter(tta_loader_run["loader"]))
    got = tta_loader_run["state"]["test_fn"](batch)
    want = make_aug_test_step(frcnn["port"], batch["__tta_metas__"])(batch["__tta_views__"])
    assert int(want[2].sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- soft-NMS ----

def soft_case(seed, n=60):
    """Seeded boxes with exact duplicates (IoU 1), tied scores and scores
    around a ``min_score`` of 0.05."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[n // 2:n // 2 + 6] = boxes[:6]                  # duplicates
    scores = rng.uniform(0.02, 1.0, n).astype(np.float32)
    scores[10:14] = scores[9]                             # ties
    scores[n // 2] = scores[0]                            # a tied duplicate
    return boxes, scores


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1])
def test_soft_nms_matches_jax(method, seed):
    """``soft_nms_padded`` with as many picks as live boxes."""
    from oadg_tpu.core.post_processing.nms import soft_nms_padded as jax_soft_nms
    from oadg_tpu_torch.core.post_processing.nms import soft_nms_padded
    boxes, scores = soft_case(seed)
    valid = np.ones(len(scores), bool)
    valid[-5:] = False
    kw = dict(iou_threshold=0.3, sigma=0.5, min_score=0.05, method=method,
              max_out=int(valid.sum()))
    ws, wk = (np.asarray(x) for x in jax_soft_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                                  valid=jnp.asarray(valid), **kw))
    gs, gk = soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                             valid=torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(gk.numpy(), wk)
    assert 10 < wk.sum() < valid.sum()
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nms_type", ["soft_nms", "soft_nms_gaussian"])
def test_multiclass_soft_nms_matches_jax(nms_type):
    """``multiclass_nms(nms_type=...)`` over 40 candidates x 3 classes,
    every candidate above ``score_thr`` (so that the 4 x 10 picks stay
    within the live boxes), batched over 2 images in the port."""
    from oadg_tpu.core.post_processing.nms import multiclass_nms as jax_multiclass_nms
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    rng = np.random.RandomState(5)
    boxes = np.stack([soft_case(s, 40)[0] for s in (2, 3)])
    boxes = np.concatenate([boxes, boxes + 3, boxes - 2], -1)            # per class
    scores = rng.uniform(0.06, 1, (2, 40, 4)).astype(np.float32)
    scores[:, 5:9, 1] = scores[:, 4:5, 1]
    kw = dict(score_thr=0.05, iou_threshold=0.5, max_per_img=10, num_classes=3,
              nms_type=nms_type, sigma=0.5, min_score=0.05)
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    for i in range(2):
        want = jax_multiclass_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), **kw)
        wd, wl, wv = (np.asarray(x) for x in want)
        assert wv.all()
        np.testing.assert_array_equal(got[2][i].numpy(), wv)
        np.testing.assert_array_equal(got[1][i].numpy(), wl)
        np.testing.assert_allclose(got[0][i].numpy(), wd, rtol=0, atol=1e-6)


def test_soft_nms_picks_past_the_live_boxes_change_nothing():
    """ROADMAP C: with more picks than live boxes, the JAX package's picks
    land on index 0 once every score is spent and zero its score, so a kept
    box comes out with score 0. The port's spent picks change nothing."""
    from oadg_tpu.core.post_processing.nms import multiclass_nms as jax_multiclass_nms
    from oadg_tpu.core.post_processing.nms import soft_nms_padded as jax_soft_nms
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms, soft_nms_padded
    boxes = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 10, 10.5],
                        [50, 50, 60, 60]], np.float32)
    scores = np.asarray([0.9, 0.8, 0.7, 0.6], np.float32)
    valid = np.asarray([True, True, False, False])
    kw = dict(iou_threshold=0.5, min_score=0.05, max_out=4)
    ws, wk = jax_soft_nms(jnp.asarray(boxes), jnp.asarray(scores), valid=jnp.asarray(valid), **kw)
    gs, gk = soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                             valid=torch.from_numpy(valid), **kw)
    assert np.asarray(wk).tolist() == gk.tolist() == [True, True, False, False]
    assert np.asarray(ws)[0] == 0 and gs.tolist() == pytest.approx([0.9, 0.8, 0, 0])
    cls = np.stack([scores, np.full(4, 0.01, np.float32), np.zeros(4, np.float32)], 1)
    kw = dict(score_thr=0.05, iou_threshold=0.5, max_per_img=3, num_classes=2,
              nms_type="soft_nms", min_score=0.05)
    wd, _, wv = (np.asarray(x) for x in jax_multiclass_nms(jnp.asarray(boxes),
                                                           jnp.asarray(cls), **kw))
    gd, _, gv = (x[0].numpy() for x in multiclass_nms(torch.from_numpy(boxes)[None],
                                                      torch.from_numpy(cls)[None], **kw))
    assert wv.all() and wd[:, 4].tolist() == pytest.approx([0.8, 0.6, 0.0])
    assert gv.all() and gd[:, 4].tolist() == pytest.approx([0.9, 0.8, 0.6])


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_roi_head_soft_nms_matches_jax_simple_test(frcnn, method):
    """The rcnn ``nms=dict(type='soft_nms', iou_threshold=0.5,
    min_score=0.05[, method='gaussian'])`` of a config, through
    ``simple_test`` in both packages."""
    from oadg_tpu.engine.train_step import make_test_step as jax_make_test_step
    from oadg_tpu.models import build_detector as jax_build_detector
    nms = dict(type="soft_nms", iou_threshold=0.5, min_score=0.05)
    if method == "gaussian":
        nms.update(method="gaussian", sigma=0.5)
    test_cfg = dict(TEST_CFG, rcnn=dict(TEST_CFG["rcnn"], nms=nms))
    jdet = jax_build_detector(MODEL, None, test_cfg, num_views=1)
    v = frcnn["variables"]
    want = jax_make_test_step(jdet)(v["params"], v.get("batch_stats"), as_jax(frcnn["batch"]))
    port = port_detector(port_model_cfg(test_cfg), v)
    with torch.inference_mode():
        got = port.simple_test(as_torch(frcnn["batch"]))
    assert_dets_close(got, want, min_count=10)


def test_aug_test_takes_the_rcnn_soft_nms(frcnn):
    """ROADMAP C: the JAX package's two-stage ``aug_test`` merges with hard
    NMS whatever the rcnn ``nms`` says (mmdet's ``merge_aug_bboxes`` path
    takes it), so under gaussian soft-NMS its one-view TTA differs from its
    ``simple_test``; the port's equals JAX's ``simple_test``."""
    from oadg_tpu.engine.train_step import make_test_step as jax_make_test_step
    from oadg_tpu.models import build_detector as jax_build_detector
    test_cfg = dict(TEST_CFG, rcnn=dict(TEST_CFG["rcnn"], nms=dict(
        type="soft_nms", method="gaussian", sigma=0.5, min_score=0.05)))
    jdet = jax_build_detector(MODEL, None, test_cfg, num_views=1)
    v = frcnn["variables"]
    simple = jax_make_test_step(jdet)(v["params"], v.get("batch_stats"), as_jax(frcnn["batch"]))
    jax_tta = jax_aug(frcnn, ((False, H),), [frcnn["batch"]], det=jdet)
    assert not np.array_equal(np.asarray(simple[0]), np.asarray(jax_tta[0]))
    port = port_detector(port_model_cfg(test_cfg), v)
    with torch.inference_mode():
        got = port.aug_test([as_torch(frcnn["batch"])], ((False, H),))
    assert_dets_close(got, simple, min_count=10)


# ------------------------------------------------------------------ async ----

def test_async_inference_detector_matches_inference_detector(frcnn):
    """Two arrays through the flagship's test pipeline (resized to 160x96):
    ``async_inference_detector`` equals ``inference_detector``, for a list
    and for one image."""
    from oadg_tpu_torch.apis import (DetectorHandle, async_inference_detector,
                                     inference_detector)
    from oadg_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, dcases.FLAGSHIP))
    cfg.merge_from_dict({"data.test.pipeline.1.img_scale": dcases.TEST_SCALE})
    handle = DetectorHandle(frcnn["port"], cfg, torch.device("cpu"))
    rng = np.random.RandomState(3)
    imgs = [dcases.textured_image(rng, 120, 200), dcases.textured_image(rng, 96, 160)]
    want = inference_detector(handle, imgs)
    got = asyncio.run(async_inference_detector(handle, imgs))
    assert len(got) == 2 and sum(len(r) for img in got for r in img) > 0
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            np.testing.assert_array_equal(g, w)
    one = asyncio.run(async_inference_detector(handle, imgs[1]))
    for g, w in zip(one, want[1]):
        np.testing.assert_array_equal(g, w)
