"""The port's evaluators against the JAX package's, on the CPU.

Every comparison is exact (``==`` on the summary numbers, equal arrays):
the port's evaluators are copies of the JAX package's numpy code, and its
host library is a copy of the JAX package's native matcher.

- ``COCOEvalBbox``: the hand-derived cases of ``test_coco_eval_golden.py``
  (each case's evaluator call is run by both packages), and seeded fixtures
  of jittered ground truth, crowd boxes, all area ranges and more than 100
  detections an image; the port's native matcher against its numpy one.
- ``eval_map`` and ``eval_recalls`` on the same fixtures, and the box
  helpers of the test path.
- ``CityscapesDataset.evaluate``: the ground truth as detections scores
  bbox AP 1.0, and the port's and the JAX package's datasets score the same
  results equally.
"""
import inspect
import os

import numpy as np
import pytest

import test_coco_eval_golden as golden
import torch_data_cases as cases
from oadg_tpu.core.evaluation import coco_eval as jax_coco_eval
from oadg_tpu.core.evaluation import mean_ap as jax_mean_ap
from oadg_tpu_torch.core.evaluation import coco_eval, mean_ap
from oadg_tpu_torch.utils import host_kernels as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = sorted(name for name, fn in inspect.getmembers(golden, inspect.isfunction)
                if name.startswith("test_"))


@pytest.mark.parametrize("case", GOLDEN)
def test_golden_cases_equal_jax(case, monkeypatch):
    """Each hand-derived case runs with both evaluators: the port's
    summary equals the JAX package's, and the case's own asserts hold."""
    calls = []

    def both(gts, results, cats=(1,)):
        want = jax_coco_eval.COCOEvalBbox(gts, results, cat_ids=list(cats)).accumulate()
        for native_matcher in (True, False):
            got = coco_eval.COCOEvalBbox(gts, results, cat_ids=list(cats),
                                         native=native_matcher).accumulate()
            assert got == want
        calls.append(case)
        return want

    monkeypatch.setattr(golden, "_run", both)
    getattr(golden, case)()
    assert calls


coco_fixture = cases.coco_fixture


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_equals_jax_on_seeded_fixtures(seed):
    gts, results = coco_fixture(seed)
    assert max(len(r[1]) for r in results) > 100
    want = jax_coco_eval.COCOEvalBbox(gts, results, [1, 2, 3]).accumulate()
    got = coco_eval.COCOEvalBbox(gts, results, [1, 2, 3]).accumulate()
    assert len(got) == 12 and got == want
    assert got == coco_eval.COCOEvalBbox(gts, results, [1, 2, 3], native=False).accumulate()
    assert 0 < got["bbox_mAP"] < 1 and got["bbox_mAP_s"] > 0 and got["bbox_mAP_l"] > 0


def test_native_matcher_equals_numpy_matcher():
    """``_evaluate_img`` per (image, class, area range, maxDets) with the
    host library's matcher and with the numpy loop."""
    gts, results = coco_fixture(7, n_images=4)
    n = 0
    for g, r in zip(gts, results):
        for c, (boxes, crowd) in g.items():
            d = r[c]
            for rng in coco_eval.AREA_RANGES.values():
                for mdet in (1, 10, 100):
                    args = (d[:, :4], d[:, 4], boxes, crowd, boxes[:, 2] * boxes[:, 3],
                            rng, mdet)
                    for a, b in zip(coco_eval._evaluate_img(*args, native=True),
                                    coco_eval._evaluate_img(*args, native=False)):
                        np.testing.assert_array_equal(a, b)
                    n += 1
    assert n > 100


def voc_fixture(seed, num_classes=3):
    """(det_results, annotations) in xyxy with ``bboxes_ignore`` /
    ``labels_ignore`` from the crowd boxes."""
    gts, results = coco_fixture(seed, cats=tuple(range(num_classes)))
    dets, anns = [], []
    for g, r in zip(gts, results):
        bbs, lbls, ign, ign_l = [], [], [], []
        for c, (boxes, crowd) in g.items():
            xyxy = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], 1)
            bbs.append(xyxy[crowd == 0])
            lbls.append(np.full(int((crowd == 0).sum()), c))
            ign.append(xyxy[crowd > 0])
            ign_l.append(np.full(int((crowd > 0).sum()), c))
        anns.append(dict(bboxes=np.concatenate(bbs).astype(np.float32),
                         labels=np.concatenate(lbls).astype(np.int64),
                         bboxes_ignore=np.concatenate(ign).astype(np.float32),
                         labels_ignore=np.concatenate(ign_l).astype(np.int64)))
        dets.append([np.concatenate([r[c][:, :2], r[c][:, :2] + r[c][:, 2:4], r[c][:, 4:]],
                                    1).astype(np.float32) for c in range(num_classes)])
    return dets, anns


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("mode", ["area", "11points"])
def test_eval_map_equals_jax(mode, legacy, monkeypatch):
    dets, anns = voc_fixture(3)
    for thr in (0.5, 0.75):
        want = jax_mean_ap.eval_map(dets, anns, iou_thr=thr, mode=mode,
                                    use_legacy_coordinate=legacy)
        got = mean_ap.eval_map(dets, anns, iou_thr=thr, mode=mode,
                               use_legacy_coordinate=legacy)
        assert got == want and 0 < got[0] < 1
    # the numpy matcher against the JAX package's numpy matcher
    from oadg_tpu.core.evaluation import native as jax_native
    monkeypatch.setattr(jax_native, "available", lambda: False)
    want = jax_mean_ap.eval_map(dets, anns, mode=mode, use_legacy_coordinate=legacy)
    assert mean_ap.eval_map(dets, anns, mode=mode, use_legacy_coordinate=legacy,
                            native=False) == want


def test_eval_recalls_equals_jax():
    dets, anns = voc_fixture(4)
    gts = [a["bboxes"] for a in anns]
    props = [np.concatenate(d) for d in dets]
    for thrs in (0.5, np.linspace(0.5, 0.95, 10)):
        want = jax_mean_ap.eval_recalls(gts, props, (10, 30, 100), thrs)
        got = mean_ap.eval_recalls(gts, props, (10, 30, 100), thrs)
        np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_box_helpers_equal_jax():
    from oadg_tpu.core.bbox import geometry as jax_geometry
    from oadg_tpu.core.bbox import transforms as jax_transforms
    from oadg_tpu_torch.core.bbox import geometry, transforms
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 90, (30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (30, 2)),
                            rng.rand(30, 1)], 1).astype(np.float32)
    labels = rng.randint(0, 4, 30)
    for got, want in zip(transforms.bbox2result(boxes, labels, 5),
                         jax_transforms.bbox2result(boxes, labels, 5)):
        np.testing.assert_array_equal(got, want)
    assert [r.shape for r in transforms.bbox2result(boxes[:0], labels[:0], 2)] == [(0, 5)] * 2
    for direction in ("horizontal", "vertical"):
        np.testing.assert_array_equal(
            transforms.bbox_flip(boxes, (100, 130), direction),
            jax_transforms.bbox_flip(boxes, (100, 130), direction))
        np.testing.assert_array_equal(
            transforms.bbox_mapping_back(boxes, (100, 130), [0.5] * 4, True, direction),
            jax_transforms.bbox_mapping_back(boxes, (100, 130), [0.5] * 4, True, direction))
    rois = np.concatenate([rng.randint(0, 3, (30, 1)), boxes[:, :4]], 1)
    for got, want in zip(transforms.roi2bbox(rois), jax_transforms.roi2bbox(rois)):
        np.testing.assert_array_equal(got, want)
    for mode in ("iou", "iof"):
        for legacy in (False, True):
            np.testing.assert_array_equal(
                geometry.bbox_overlaps_np(boxes[:12, :4], boxes[5:, :4], mode, legacy),
                jax_geometry.bbox_overlaps_np(boxes[:12, :4], boxes[5:, :4], mode, legacy))
            np.testing.assert_array_equal(
                native.iou_xyxy(boxes[:12, :4], boxes[5:, :4], legacy),
                jax_native_iou(boxes[:12, :4], boxes[5:, :4], legacy))


def jax_native_iou(a, b, legacy):
    from oadg_tpu.core.evaluation import native as jax_native
    return jax_native.iou_xyxy(a, b, legacy)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.data import build_dataset
    ann_file, img_prefix = cases.write_dataset(str(tmp_path_factory.mktemp("city")))
    cfg = load_config(os.path.join(ROOT, cases.FLAGSHIP))
    cfg.merge_from_dict(cases.cfg_options(ann_file, img_prefix))
    test = dict(cfg.data.test, test_mode=True)
    return build_dataset(test), jax_build_dataset(test)


def gt_as_detections(ds, score=1.0):
    """Every non-crowd annotation of the dataset's classes as a detection
    of its class (what the COCO protocol counts as ground truth)."""
    results = []
    for info in ds.data_infos:
        per_cls = [np.zeros((0, 5), np.float32) for _ in ds.CLASSES]
        for a in ds.coco.img_anns.get(info["id"], []):
            if a["category_id"] in ds.cat2label and not a.get("iscrowd", 0):
                x, y, w, h = a["bbox"]
                label = ds.cat2label[a["category_id"]]
                det = np.asarray([[x, y, x + w, y + h, score]], np.float32)
                per_cls[label] = np.concatenate([per_cls[label], det])
        results.append(per_cls)
    return results


def test_gt_as_detections_scores_ap_one(datasets):
    ds, jds = datasets
    results = gt_as_detections(ds)
    assert sum(len(r) for res in results for r in res) >= 20
    for native_matcher in (True, False):
        got = ds.evaluate(results, metric="bbox", native=native_matcher)
        assert got["bbox_mAP"] == 1.0 and got["bbox_mAP_50"] == 1.0
        assert got == jds.evaluate(results, metric="bbox")


def test_dataset_evaluate_equals_jax(datasets):
    from oadg_tpu.data.datasets.custom import CustomDataset as JaxCustomDataset
    from oadg_tpu_torch.data.datasets.custom import CustomDataset
    ds, jds = datasets
    rng = np.random.RandomState(5)
    results = []
    for res in gt_as_detections(ds, score=0.5):
        per_cls = []
        for r in res:
            jit = r[:, :4] + rng.normal(0, 3, r[:, :4].shape)
            fp = rng.uniform(0, 150, (rng.randint(0, 6), 2))
            fp = np.concatenate([fp, fp + rng.uniform(2, 60, fp.shape)], 1)
            boxes = np.concatenate([jit, fp])
            per_cls.append(np.concatenate([boxes, rng.rand(len(boxes), 1)], 1)
                           .astype(np.float32))
        results.append(per_cls)
    got = ds.evaluate(results, metric="bbox")
    assert got == jds.evaluate(results, metric="bbox") and 0 < got["bbox_mAP"] < 1
    props = [np.concatenate(r) for r in results]
    assert ds.evaluate(props, metric="proposal", proposal_nums=(5, 20)) == \
        jds.evaluate(props, metric="proposal", proposal_nums=(5, 20))
    voc = CustomDataset.evaluate(ds, results, metric="mAP", iou_thr=[0.5, 0.75])
    assert voc == JaxCustomDataset.evaluate(jds, results, metric="mAP", iou_thr=[0.5, 0.75])
    assert 0 < voc["mAP"] < 1
    np.testing.assert_array_equal(
        CustomDataset.evaluate(ds, props, metric="recall")["recall"],
        JaxCustomDataset.evaluate(jds, props, metric="recall")["recall"])


def test_failed_build_of_the_host_library_raises(tmp_path, monkeypatch):
    """No quiet fallback: a compiler that fails raises, naming the source."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host_kernels.cpp"):
        native.load()
    assert not list(tmp_path.glob("*.so"))


def test_host_library_builds_into_the_build_directory():
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.name.startswith("host_kernels_")
    assert so == native.library_path() and so.is_file()
    assert native.load() is native.load()
