"""COCO bbox evaluation (port of ``oadg_tpu/core/evaluation/coco_eval.py``).

The COCOeval bbox protocol: greedy score-ordered matching per (class, IoU
threshold, area range, maxDets), crowd and ignore handling, 101-point
interpolated precision, AP averaged over the ten IoU thresholds .5:.05:.95,
and the 12-number summary. numpy on the host; the matcher runs in the port's
host library (``utils.host_kernels.coco_match``) unless ``native=False`` selects its
plain numpy version.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """IoU with crowd semantics: for crowd gt, IoU = inter / det_area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    da = dets[:, 2] * dets[:, 3]
    ga = gts[:, 2] * gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = np.where(iscrowd[None, :].astype(bool), da[:, None],
                     da[:, None] + ga[None, :] - inter)
    return inter / np.maximum(union, 1e-10)


def _evaluate_img(dets, det_scores, gts, gt_crowd, gt_area, area_rng,
                  max_dets, iou_thrs=IOU_THRS, native=True):
    """Match one (img, cat): returns det_matched (T, D), det_ignore (T, D),
    gt_ignore (G,), det scores (D,)."""
    t = len(iou_thrs)
    order = np.argsort(-det_scores, kind="mergesort")[:max_dets]
    dets = dets[order]
    det_scores = det_scores[order]
    g = len(gts)
    d = len(dets)
    gt_ig = gt_crowd.astype(bool) | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    # sort gts: non-ignored first (pycocotools gtind ordering)
    gt_order = np.argsort(gt_ig, kind="mergesort")
    gts = gts[gt_order]
    gt_ig = gt_ig[gt_order]
    crowd = gt_crowd[gt_order].astype(bool)
    ious = _iou_xywh(dets, gts, crowd)

    if d and g and native:
        from ...utils.host_kernels import coco_match
        m, ig = coco_match(ious, gt_ig.astype(np.uint8),
                           crowd.astype(np.uint8),
                           np.asarray(iou_thrs, np.float32))
        dt_m = m.astype(np.int64)
        dt_ig = ig.astype(bool)
    else:
        dt_m = np.zeros((t, d), dtype=np.int64) - 1
        gt_m = np.zeros((t, g), dtype=np.int64) - 1
        dt_ig = np.zeros((t, d), dtype=bool)
        for ti, thr in enumerate(iou_thrs):
            for di in range(d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g):
                    if gt_m[ti, gi] >= 0 and not crowd[gi]:
                        continue
                    if best_g >= 0 and not gt_ig[best_g] and gt_ig[gi]:
                        break      # can't beat a non-ignored match with ignored
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g >= 0:
                    dt_m[ti, di] = best_g
                    gt_m[ti, best_g] = di
                    dt_ig[ti, di] = gt_ig[best_g]
    # unmatched dets outside the area range are ignored
    da = dets[:, 2] * dets[:, 3]
    out_of_rng = (da < area_rng[0]) | (da > area_rng[1])
    dt_ig |= (dt_m < 0) & out_of_rng[None, :]
    return dt_m >= 0, dt_ig, gt_ig, det_scores


class COCOEvalBbox:
    """results: per image dict {cat_id: (n, 5) [x, y, w, h, score]} (xywh);
    gts: per image dict {cat_id: (boxes (n, 4) xywh, iscrowd (n,))}."""

    def __init__(self, gts: List[Dict], results: List[Dict],
                 cat_ids: Sequence[int], max_dets=(1, 10, 100),
                 iou_thrs=None, area_ranges=None, native: bool = True):
        """``iou_thrs`` / ``area_ranges`` default to the COCO protocol
        (.5:.05:.95 / all-small-medium-large); ``native=False`` matches with
        the numpy matcher instead of the host library's."""
        self.gts = gts
        self.results = results
        self.cat_ids = list(cat_ids)
        self.max_dets = max_dets
        self.iou_thrs = (IOU_THRS if iou_thrs is None
                         else np.asarray(iou_thrs, float))
        self.area_ranges = (dict(AREA_RANGES) if area_ranges is None
                            else dict(area_ranges))
        self.native = native

    def accumulate(self) -> Dict[str, float]:
        t = len(self.iou_thrs)
        k = len(self.cat_ids)
        a = len(self.area_ranges)
        m = len(self.max_dets)
        precision = -np.ones((t, len(REC_THRS), k, a, m))
        recall = -np.ones((t, k, a, m))

        for ki, cat in enumerate(self.cat_ids):
            per_img = []
            for img_gt, img_dt in zip(self.gts, self.results):
                g_boxes, g_crowd = img_gt.get(cat, (np.zeros((0, 4)),
                                                    np.zeros((0,))))
                d = img_dt.get(cat, np.zeros((0, 5)))
                per_img.append((np.asarray(d, float),
                                np.asarray(g_boxes, float),
                                np.asarray(g_crowd, float)))
            for ai, (aname, arng) in enumerate(self.area_ranges.items()):
                for mi, mdet in enumerate(self.max_dets):
                    matched_all, ignored_all, scores_all = [], [], []
                    n_gt = 0
                    for d, g, crowd in per_img:
                        garea = g[:, 2] * g[:, 3] if len(g) else np.zeros((0,))
                        dm, dig, gig, sc = _evaluate_img(
                            d[:, :4], d[:, 4] if len(d) else np.zeros((0,)),
                            g, crowd, garea, arng, mdet, self.iou_thrs,
                            self.native)
                        matched_all.append(dm)
                        ignored_all.append(dig)
                        scores_all.append(sc)
                        n_gt += int((~gig).sum())
                    if n_gt == 0:
                        continue
                    dm = np.concatenate(matched_all, axis=1)
                    dig = np.concatenate(ignored_all, axis=1)
                    sc = np.concatenate(scores_all)
                    order = np.argsort(-sc, kind="mergesort")
                    dm = dm[:, order]
                    dig = dig[:, order]
                    for ti in range(t):
                        keep = ~dig[ti]
                        tp = np.cumsum(dm[ti][keep])
                        fp = np.cumsum(~dm[ti][keep])
                        if len(tp) == 0:
                            recall[ti, ki, ai, mi] = 0
                            precision[ti, :, ki, ai, mi] = 0
                            continue
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-10)
                        recall[ti, ki, ai, mi] = rc[-1]
                        # precision envelope (monotone decreasing)
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall
        return self.summarize()

    def _ap(self, iou=None, area="all", mdet=100):
        if area not in self.area_ranges:        # custom ranges: first = all
            area = next(iter(self.area_ranges))
        ai = list(self.area_ranges).index(area)
        mi = list(self.max_dets).index(mdet)
        p = self.precision[:, :, :, ai, mi]
        if iou is not None:
            ti = int(np.argmin(np.abs(self.iou_thrs - iou)))
            p = p[ti:ti + 1]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else -1.0

    def _ar(self, iou=None, area="all", mdet=100):
        if area not in self.area_ranges:        # custom ranges: first = all
            area = next(iter(self.area_ranges))
        ai = list(self.area_ranges).index(area)
        mi = list(self.max_dets).index(mdet)
        r = self.recall[:, :, ai, mi]
        if iou is not None:
            ti = int(np.argmin(np.abs(self.iou_thrs - iou)))
            r = r[ti:ti + 1]
        r = r[r > -1]
        return float(np.mean(r)) if r.size else -1.0

    def summarize(self) -> Dict[str, float]:
        md = max(self.max_dets)
        out = {
            "bbox_mAP": self._ap(mdet=md),
            "bbox_mAP_50": self._ap(iou=0.5, mdet=md),
            "bbox_mAP_75": self._ap(iou=0.75, mdet=md),
        }
        # area-split metrics only exist under the standard protocol areas
        # (custom area_ranges, e.g. the error-analysis tool's, skip them)
        for key, area in (("s", "small"), ("m", "medium"), ("l", "large")):
            if area in self.area_ranges:
                out[f"bbox_mAP_{key}"] = self._ap(area=area, mdet=md)
        out["AR@1"] = self._ar(mdet=self.max_dets[0])
        if len(self.max_dets) > 1:
            out["AR@10"] = self._ar(mdet=self.max_dets[1])
        out[f"AR@{md}"] = self._ar(mdet=md)
        for key, area in (("s", "small"), ("m", "medium"), ("l", "large")):
            if area in self.area_ranges:
                out[f"AR_{key}@{md}"] = self._ar(area=area, mdet=md)
        return out
