"""VOC-style mAP and proposal recall (port of
``oadg_tpu/core/evaluation/mean_ap.py``). numpy on the host; the greedy
matcher runs in the port's host library unless ``native=False``.

Supports ``use_legacy_coordinate`` (+1 box widths, the DWD evaluation) and
both 'area' (VOC2010+) and '11points' (VOC2007) AP modes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..bbox.geometry import bbox_overlaps_np


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> float:
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    # 11-point
    ap = 0.0
    for thr in np.arange(0, 1.1, 0.1):
        prec = precisions[recalls >= thr]
        ap += (prec.max() if prec.size else 0.0) / 11.0
    return float(ap)


def tpfp_default(det_bboxes, gt_bboxes, gt_ignore, iou_thr: float,
                 use_legacy_coordinate: bool = False, native: bool = True):
    """Greedy matching for one (img, class): returns (tp, fp) of shape (D,).

    IoUs and matching run in the host library (``host_kernels.iou_xyxy``,
    ``host_kernels.tpfp_greedy``); ``native=False`` runs the numpy version below.
    """
    extra = 1.0 if use_legacy_coordinate else 0.0
    d = det_bboxes.shape[0]
    g = gt_bboxes.shape[0]
    tp = np.zeros(d)
    fp = np.zeros(d)
    if g == 0:
        fp[:] = 1
        return tp, fp
    if d and native:
        from ...utils.host_kernels import iou_xyxy, tpfp_greedy
        ious_n = iou_xyxy(det_bboxes[:, :4], gt_bboxes,
                          use_legacy_coordinate)
        gi = (gt_ignore.astype(np.uint8) if gt_ignore is not None else None)
        tp, fp = tpfp_greedy(ious_n, det_bboxes[:, -1], gi, iou_thr)
        return tp.astype(np.float64), fp.astype(np.float64)
    ious = bbox_overlaps_np(det_bboxes[:, :4], gt_bboxes,
                            use_legacy_coordinate=use_legacy_coordinate)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    order = np.argsort(-det_bboxes[:, -1], kind="mergesort")
    covered = np.zeros(g, dtype=bool)
    for i in order:
        if ious_max[i] >= iou_thr:
            gi = ious_argmax[i]
            if gt_ignore is not None and gt_ignore[gi]:
                continue                # ignored gt: neither tp nor fp
            if not covered[gi]:
                covered[gi] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             scale_ranges=None,
             iou_thr: float = 0.5,
             dataset=None,
             logger=None,
             mode: str = "area",
             use_legacy_coordinate: bool = False,
             nproc: int = 4,
             native: bool = True,
             **kwargs) -> Tuple[float, List[Dict]]:
    """VOC mAP.

    Args:
        det_results: per image per class (n, 5) [x1,y1,x2,y2,score].
        annotations: per image dict with 'bboxes' (n,4), 'labels' (n,),
            optional 'bboxes_ignore'/'labels_ignore'.

    Returns (mAP, per-class results list).
    """
    num_classes = len(det_results[0])
    extra = 1.0 if use_legacy_coordinate else 0.0
    eval_results = []
    aps = []
    for c in range(num_classes):
        tps, fps, scores = [], [], []
        num_gts = 0
        for dets, ann in zip(det_results, annotations):
            cls_dets = np.asarray(dets[c], np.float32).reshape(-1, 5)
            mask = ann["labels"] == c
            cls_gts = ann["bboxes"][mask].reshape(-1, 4)
            ig_boxes = ann.get("bboxes_ignore", np.zeros((0, 4)))
            ig_labels = ann.get("labels_ignore",
                                np.zeros((len(ig_boxes),), np.int64))
            ig_mask = (ig_labels == c) if len(ig_boxes) else np.zeros(0, bool)
            all_gts = np.concatenate([cls_gts, ig_boxes[ig_mask].reshape(-1, 4)])
            gt_ignore = np.concatenate([np.zeros(len(cls_gts), bool),
                                        np.ones(int(ig_mask.sum()), bool)])
            tp, fp = tpfp_default(cls_dets, all_gts, gt_ignore, iou_thr,
                                  use_legacy_coordinate, native)
            tps.append(tp)
            fps.append(fp)
            scores.append(cls_dets[:, -1])
            num_gts += len(cls_gts)
        tp = np.concatenate(tps)
        fp = np.concatenate(fps)
        sc = np.concatenate(scores)
        order = np.argsort(-sc, kind="mergesort")
        tp = np.cumsum(tp[order])
        fp = np.cumsum(fp[order])
        eps = np.finfo(np.float32).eps
        recalls = tp / max(num_gts, eps)
        precisions = tp / np.maximum(tp + fp, eps)
        ap = average_precision(recalls, precisions, mode) if num_gts > 0 else 0.0
        aps.append((ap, num_gts))
        eval_results.append(dict(
            num_gts=num_gts, num_dets=len(sc), ap=ap,
            recall=float(recalls[-1]) if len(recalls) else 0.0,
            precision=float(precisions[-1]) if len(precisions) else 0.0))
    valid = [ap for ap, n in aps if n > 0]
    mean_ap = float(np.mean(valid)) if valid else 0.0
    if logger is not None:
        names = dataset if dataset else [str(i) for i in range(num_classes)]
        for n, r in zip(names, eval_results):
            logger.info(f"{n}: ap={r['ap']:.4f} gts={r['num_gts']} "
                        f"dets={r['num_dets']} recall={r['recall']:.4f}")
        logger.info(f"mAP: {mean_ap:.4f}")
    return mean_ap, eval_results


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums=(100, 300, 1000), iou_thrs=0.5,
                 logger=None) -> np.ndarray:
    """Proposal recall matrix (reference core/evaluation/recall.py)."""
    if isinstance(iou_thrs, float):
        iou_thrs = [iou_thrs]
    proposal_nums = list(proposal_nums)
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(g) for g in gts)
    if total_gt == 0:
        return recalls
    for ni, pn in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for g, p in zip(gts, proposals):
                if len(g) == 0:
                    continue
                if len(p) == 0:
                    continue
                pp = np.asarray(p)
                if pp.shape[1] == 5:
                    order = np.argsort(-pp[:, 4], kind="mergesort")
                    pp = pp[order]
                pp = pp[:pn, :4]
                ious = bbox_overlaps_np(np.asarray(g), pp)
                hit += int((ious.max(axis=1) >= thr).sum())
            recalls[ni, ti] = hit / total_gt
    return recalls
