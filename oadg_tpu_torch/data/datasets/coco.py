"""COCO-json datasets: ``CocoDataset`` and ``CityscapesDataset`` (port of
``oadg_tpu/data/datasets/coco.py:20-175``), with their own json index
(``_MiniCOCO``) and the port's COCO-protocol evaluator
(``core/evaluation/coco_eval.py``); pycocotools is not needed.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict

import numpy as np

from ...utils.registry import DATASETS
from .custom import CustomDataset


class _MiniCOCO:
    """Minimal COCO-json index (the subset of pycocotools.COCO mmdet uses)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self.img_anns[a["image_id"]].append(a)

    def get_cat_ids(self, cat_names=None):
        if cat_names is None:
            return sorted(self.cats)
        name_to_id = {c["name"]: cid for cid, c in self.cats.items()}
        return [name_to_id[n] for n in cat_names]

    def get_img_ids(self):
        return sorted(self.imgs)


@DATASETS.register_module()
class CocoDataset(CustomDataset):
    CLASSES = ('person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
               'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
               'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog',
               'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra',
               'giraffe', 'backpack', 'umbrella', 'handbag', 'tie',
               'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball',
               'kite', 'baseball bat', 'baseball glove', 'skateboard',
               'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup',
               'fork', 'knife', 'spoon', 'bowl', 'banana', 'apple',
               'sandwich', 'orange', 'broccoli', 'carrot', 'hot dog',
               'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
               'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse',
               'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
               'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
               'scissors', 'teddy bear', 'hair drier', 'toothbrush')

    def load_annotations(self, ann_file):
        self.coco = _MiniCOCO(ann_file)
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        data_infos = []
        for i in self.img_ids:
            info = dict(self.coco.imgs[i])
            info["filename"] = info["file_name"]
            data_infos.append(info)
        return data_infos

    def get_ann_info(self, idx) -> Dict[str, Any]:
        """Boxes (x1, y1, x2, y2), labels, crowd boxes as ``bboxes_ignore``,
        and each kept box's ``segmentation`` (polygons or uncompressed RLE)
        as ``masks``, in box order, as mmdet's ``_parse_ann_info`` keeps them
        for ``LoadAnnotations(with_mask=True)``. (The JAX package's
        ``get_ann_info`` drops ``segmentation``, so a JAX Mask R-CNN trained
        from a COCO json sees all-zero gt masks; ROADMAP C.)"""
        img_id = self.data_infos[idx]["id"]
        anns = self.coco.img_anns.get(img_id, [])
        bboxes, labels, bboxes_ignore, masks = [], [], [], []
        for a in anns:
            if a.get("ignore", False):
                continue
            x, y, w, h = a["bbox"]
            if a.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if a["category_id"] not in self.cat2label:
                continue
            box = [x, y, x + w, y + h]
            if a.get("iscrowd", 0):
                bboxes_ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(self.cat2label[a["category_id"]])
                masks.append(a.get("segmentation"))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(bboxes_ignore, np.float32).reshape(-1, 4),
            masks=masks)

    def _filter_imgs(self, min_size=32):
        valid = []
        ids_with_ann = {a["image_id"] for anns in self.coco.img_anns.values()
                        for a in anns}
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and info["id"] not in ids_with_ann:
                continue
            if min(info["width"], info["height"]) < min_size:
                continue
            valid.append(i)
        return valid

    def evaluate(self, results, metric="bbox", logger=None, classwise=False,
                 proposal_nums=(100, 300, 1000), native: bool = True,
                 **kwargs) -> Dict[str, float]:
        """COCO bbox mAP and recall (the 12-number summary), or proposal
        recall (``'proposal'``). ``results``: per image per-class (n, 5)
        detection lists (per-image proposal arrays for the proposal
        metrics). ``native=False`` matches with the numpy matcher."""
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        if any(m in ("proposal", "proposal_fast") for m in metrics):
            from ...core.evaluation.mean_ap import eval_recalls
            gts = [self.get_ann_info(i)["bboxes"] for i in range(len(self))]
            props = [np.vstack(r) if isinstance(r, list) else np.asarray(r)
                     for r in results]
            ar = eval_recalls(gts, props, proposal_nums,
                              np.linspace(0.5, 0.95, 10))
            out = {f"AR@{n}": round(float(ar[i].mean()), 4)
                   for i, n in enumerate(proposal_nums)}
            if logger is not None:
                logger.info(str(out))
            return out
        from ...core.evaluation.coco_eval import COCOEvalBbox
        gts, dets = [], []
        for idx in range(len(self)):
            img_id = self.data_infos[idx]["id"]
            g = defaultdict(lambda: ([], []))
            for a in self.coco.img_anns.get(img_id, []):
                if a["category_id"] not in self.cat2label:
                    continue
                cid = a["category_id"]
                g[cid][0].append(a["bbox"])
                g[cid][1].append(a.get("iscrowd", 0))
            gts.append({c: (np.asarray(b, float).reshape(-1, 4),
                            np.asarray(cr, float))
                        for c, (b, cr) in g.items()})
            d = {}
            per_cls = results[idx]
            for ci, cls_dets in enumerate(per_cls):
                cls_dets = np.asarray(cls_dets, float).reshape(-1, 5)
                xywh = np.concatenate(
                    [cls_dets[:, :2], cls_dets[:, 2:4] - cls_dets[:, :2],
                     cls_dets[:, 4:5]], axis=1)
                d[self.cat_ids[ci]] = xywh
            dets.append(d)
        ev = COCOEvalBbox(gts, dets, self.cat_ids, native=native)
        summary = ev.accumulate()
        if logger is not None:
            logger.info(" ".join(f"{k}={v:.4f}" for k, v in summary.items()))
        return summary


@DATASETS.register_module()
class CityscapesDataset(CocoDataset):
    """The 8 instance classes of Cityscapes (mmdet's ``cityscapes.py:21``);
    an image is kept in training when it has a non-crowd box of them."""
    CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle')
    PALETTE = [(220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
               (0, 60, 100), (0, 80, 100), (0, 0, 230), (119, 11, 32)]

    def _filter_imgs(self, min_size=32):
        valid = []
        for i, info in enumerate(self.data_infos):
            anns = self.coco.img_anns.get(info["id"], [])
            has_valid = any(not a.get("iscrowd", 0) and a["category_id"]
                            in self.cat2label for a in anns)
            if self.filter_empty_gt and not has_valid:
                continue
            if min(info["width"], info["height"]) < min_size:
                continue
            valid.append(i)
        return valid
