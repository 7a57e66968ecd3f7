"""COCO-panoptic dataset (port of ``CocoPanopticDataset``,
``oadg_tpu/data/datasets/more_datasets.py:131``; the module's other
datasets are not ported yet, ROADMAP A.3)."""
from __future__ import annotations

import os.path as osp
from typing import Any, Dict

import numpy as np

from ...utils.registry import DATASETS
from .coco import CocoDataset


@DATASETS.register_module()
class CocoPanopticDataset(CocoDataset):
    """``:131``: a COCO-panoptic json (``images``, ``annotations`` with
    ``segments_info`` and the PNG's ``file_name``, ``categories`` with
    ``isthing``); the classes are the json's categories in id order,
    ``THING_CLASSES`` and ``STUFF_CLASSES`` their two kinds. ``get_ann_info``
    gives the thing segments' boxes and labels and every segment's id,
    label and kind (``LoadPanopticAnnotations`` reads them); ``evaluate``
    takes per image ``(panoptic id map, segments_info)`` and returns PQ, SQ
    and RQ (``core/evaluation/panoptic_eval.py``)."""
    INSTANCE_OFFSET = 1000

    def load_annotations(self, ann_file):
        import json
        with open(ann_file) as f:
            d = json.load(f)
        self.categories = {c["id"]: c for c in d["categories"]}
        self.cat_ids = sorted(self.categories)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.CLASSES = tuple(self.categories[c]["name"]
                             for c in self.cat_ids)
        self.THING_CLASSES = tuple(
            self.categories[c]["name"] for c in self.cat_ids
            if self.categories[c].get("isthing", 1))
        self.STUFF_CLASSES = tuple(
            self.categories[c]["name"] for c in self.cat_ids
            if not self.categories[c].get("isthing", 1))
        imgs = {im["id"]: im for im in d["images"]}
        anns = {a["image_id"]: a for a in d["annotations"]}
        self.img_ids = sorted(imgs)
        self.panoptic_anns = anns
        infos = []
        for i in self.img_ids:
            info = dict(imgs[i])
            info["filename"] = info["file_name"]
            infos.append(info)
        return infos

    def get_ann_info(self, idx) -> Dict[str, Any]:
        img_id = self.img_ids[idx]
        ann = self.panoptic_anns[img_id]
        bboxes, labels, seg_ids, is_thing = [], [], [], []
        for seg in ann["segments_info"]:
            cat = seg["category_id"]
            thing = self.categories[cat].get("isthing", 1)
            if "bbox" in seg:
                x, y, w, h = seg["bbox"]
                bboxes.append([x, y, x + w, y + h])
            else:
                bboxes.append([0, 0, 0, 0])
            labels.append(self.cat2label[cat])
            seg_ids.append(seg["id"])
            is_thing.append(bool(thing))
        thing_sel = np.asarray(is_thing, bool) if is_thing else \
            np.zeros((0,), bool)
        bboxes = (np.asarray(bboxes, np.float32).reshape(-1, 4)
                  if bboxes else np.zeros((0, 4), np.float32))
        labels = (np.asarray(labels, np.int64)
                  if labels else np.zeros((0,), np.int64))
        return dict(bboxes=bboxes[thing_sel], labels=labels[thing_sel],
                    bboxes_ignore=np.zeros((0, 4), np.float32),
                    seg_ids=[s for s, t in zip(seg_ids, is_thing) if t],
                    seg_labels=labels.tolist(),
                    seg_isthing=list(map(bool, is_thing)),
                    all_seg_ids=seg_ids,
                    masks=[], seg_map=ann.get("file_name"),
                    segments_info=ann["segments_info"])

    def _filter_imgs(self, min_size=32):
        return [i for i, info in enumerate(self.data_infos)
                if min(info["width"], info["height"]) >= min_size]

    def evaluate(self, results, metric="PQ", logger=None, **kw):
        """results: list of (pan_id_map (H, W) int32, segments_info) per
        image — the PanopticFPN host-fusion output format."""
        from ...core.evaluation.panoptic_eval import pq_compute
        gts = []
        for idx in range(len(self.img_ids)):
            ann = self.panoptic_anns[self.img_ids[idx]]
            seg_path = ann.get("file_name")
            if self.seg_prefix and seg_path:
                seg_path = osp.join(self.seg_prefix, seg_path)
            gts.append(dict(seg_path=seg_path,
                            segments_info=ann["segments_info"]))
        pq, sq, rq, per_cls = pq_compute(gts, results, self.categories)
        return {"PQ": pq, "SQ": sq, "RQ": rq}
