"""Panoptic Quality (port of ``oadg_tpu/core/evaluation/panoptic_eval.py:20-150``;
mmdet's ``coco_panoptic.py`` evaluation through panopticapi, replaced by an
in-repo PQ in both packages), in numpy, bit-equal to the JAX package's.

PQ per category = sum over TP of IoU / (|TP| + |FP| / 2 + |FN| / 2); a
prediction matches a gt segment of its category where their IoU is above
0.5 (the union without the prediction's void pixels); crowd gts match
nothing, and a prediction mostly on void or on a crowd region of its class
is no FP. SQ is the mean TP IoU, RQ the F1; PQ = SQ x RQ, each averaged
over the categories seen. A gt map given by path is read with the port's
PNG decoder (``data/pipelines/image_io.py``), not ``cv2``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

VOID = 0


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO panoptic PNG encoding: id = R + 256 G + 256^2 B
    (panopticapi.utils.rgb2id)."""
    color = np.asarray(color, np.uint32)
    if color.ndim == 3:
        return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]
    return color


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    id_map = np.asarray(id_map, np.uint32)
    return np.stack([id_map % 256, (id_map // 256) % 256,
                     (id_map // 65536) % 256], axis=-1).astype(np.uint8)


def _segment_areas(id_map):
    ids, counts = np.unique(id_map, return_counts=True)
    return dict(zip(ids.tolist(), counts.tolist()))


def pq_single(gt_map, gt_segments, pred_map, pred_segments, categories):
    """Accumulate PQ stats for one image.

    Args:
        gt_map/pred_map: (H, W) int segment-id maps (0 = void).
        gt_segments/pred_segments: list of dicts with id/category_id
            (gt dicts may carry iscrowd).
        categories: {cat_id: {...,'isthing':0|1}}.

    Returns {cat_id: [iou_sum, tp, fp, fn]}.
    """
    stats = defaultdict(lambda: [0.0, 0, 0, 0])
    gt_info = {s["id"]: s for s in gt_segments}
    pred_info = {s["id"]: s for s in pred_segments}

    gt_areas = _segment_areas(gt_map)
    pred_areas = _segment_areas(pred_map)

    # joint histogram of (gt_id, pred_id) pairs
    combined = gt_map.astype(np.uint64) * (2 ** 32) + pred_map.astype(
        np.uint64)
    pairs, inter = np.unique(combined, return_counts=True)
    inter_of = {(int(p >> 32), int(p & 0xFFFFFFFF)): int(c)
                for p, c in zip(pairs, inter)}

    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter_of.items():
        if gid not in gt_info or pid not in pred_info:
            continue
        g, p = gt_info[gid], pred_info[pid]
        if g.get("iscrowd", 0):
            continue
        if g["category_id"] != p["category_id"]:
            continue
        # panopticapi subtracts the prediction's void overlap from the
        # union so unlabeled gt pixels don't penalize the match
        union = (gt_areas[gid] + pred_areas[pid] - i
                 - inter_of.get((VOID, pid), 0))
        iou = i / max(union, 1)
        if iou > 0.5:
            c = g["category_id"]
            stats[c][0] += iou
            stats[c][1] += 1
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat = {}
    for gid, g in gt_info.items():
        if g.get("iscrowd", 0):
            crowd_by_cat[g["category_id"]] = gid
            continue
        if gid not in matched_gt:
            stats[g["category_id"]][3] += 1                 # FN
    for pid, p in pred_info.items():
        if pid in matched_pred:
            continue
        # panopticapi: predictions mostly covered by void or by a crowd
        # region of the same class don't count as FP
        void_i = inter_of.get((VOID, pid), 0)
        crowd_i = 0
        cg = crowd_by_cat.get(p["category_id"])
        if cg is not None:
            crowd_i = inter_of.get((cg, pid), 0)
        if (void_i + crowd_i) / max(pred_areas.get(pid, 1), 1) > 0.5:
            continue
        stats[p["category_id"]][2] += 1                     # FP
    return stats


def pq_compute(gts: Sequence[Dict], preds: Sequence, categories: Dict
               ) -> Tuple[float, float, float, Dict]:
    """Aggregate PQ over a dataset.

    Args:
        gts: per image dict(seg_path | seg_map (H, W) ids, segments_info).
        preds: per image (pred_id_map, pred_segments_info) tuples.
        categories: {cat_id: {'isthing': ...}}.
    """
    total = defaultdict(lambda: [0.0, 0, 0, 0])
    for gt, pred in zip(gts, preds):
        if "seg_map" in gt and gt["seg_map"] is not None and not isinstance(
                gt["seg_map"], str):
            gt_map = np.asarray(gt["seg_map"])
        else:
            from ...data.pipelines.image_io import imread
            gt_map = rgb2id(imread(gt["seg_path"])[..., ::-1])    # BGR -> RGB -> id
        pred_map, pred_segments = pred
        st = pq_single(gt_map, gt["segments_info"], np.asarray(pred_map),
                       pred_segments, categories)
        for c, (iou, tp, fp, fn) in st.items():
            total[c][0] += iou
            total[c][1] += tp
            total[c][2] += fp
            total[c][3] += fn

    per_class = {}
    pqs, sqs, rqs = [], [], []
    for c, (iou, tp, fp, fn) in total.items():
        if tp + fp + fn == 0:
            continue
        sq = iou / tp if tp else 0.0
        rq = tp / (tp + 0.5 * fp + 0.5 * fn)
        pq = sq * rq
        per_class[c] = dict(pq=pq, sq=sq, rq=rq)
        pqs.append(pq)
        sqs.append(sq)
        rqs.append(rq)
    n = max(len(pqs), 1)
    return (100 * sum(pqs) / n, 100 * sum(sqs) / n, 100 * sum(rqs) / n,
            per_class)
