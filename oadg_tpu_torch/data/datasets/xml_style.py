"""VOC-XML datasets: ``XMLDataset``, ``VOCDataset`` and ``SdgodDataset``
(port of ``oadg_tpu/data/datasets/xml_style.py:20-132``).

Each image ``{img_id}`` of the ``ann_file`` list is ``JPEGImages/{img_id}.jpg``
under ``img_prefix`` with its boxes in ``Annotations/{img_id}.xml``
(``xml.etree``); a ``difficult`` object, or one narrower or shorter than
``min_size``, goes to the ignored boxes. An XML without a ``size`` takes
the image file's (``image_io.image_size``, as mmdet opens the image; the
JAX package keeps 0 x 0 there and divides by zero when it groups the images
of a train set). ``SdgodDataset`` is the Diverse
Weather Dataset (DWD / S-DGOD): 7 classes, VOC mAP with
``use_legacy_coordinate=True`` (+1 box widths) through the port's
``core/evaluation/mean_ap.py:eval_map``, with ``scale_ranges`` and one
``AP_<class>`` key per class.
"""
from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from ...utils.registry import DATASETS
from ..pipelines.image_io import image_size
from .custom import CustomDataset


@DATASETS.register_module()
class XMLDataset(CustomDataset):

    def __init__(self, min_size=None, img_subdir="JPEGImages",
                 ann_subdir="Annotations", **kwargs):
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.min_size = min_size
        super().__init__(**kwargs)
        self.cat2label = {cat: i for i, cat in enumerate(self.CLASSES)}

    def _xml_path(self, img_id) -> str:
        return osp.join(self.img_prefix, self.ann_subdir, f"{img_id}.xml")

    def load_annotations(self, ann_file):
        self.cat2label = {cat: i for i, cat in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            img_ids = [line.strip() for line in f if line.strip()]
        data_infos = []
        for img_id in img_ids:
            filename = osp.join(self.img_subdir, f"{img_id}.jpg")
            xml_path = self._xml_path(img_id)
            size = ET.parse(xml_path).getroot().find("size") if osp.exists(xml_path) else None
            if size is not None:
                width = int(size.find("width").text)
                height = int(size.find("height").text)
            else:
                width, height = image_size(osp.join(self.img_prefix, filename))
            data_infos.append(dict(id=img_id, filename=filename, width=width,
                                   height=height))
        return data_infos

    def get_ann_info(self, idx) -> Dict:
        xml_path = self._xml_path(self.data_infos[idx]["id"])
        bboxes, labels, bboxes_ignore, labels_ignore = [], [], [], []
        if osp.exists(xml_path):
            for obj in ET.parse(xml_path).getroot().findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                label = self.cat2label[name]
                difficult = obj.find("difficult")
                difficult = 0 if difficult is None else int(difficult.text)
                bnd = obj.find("bndbox")
                bbox = [float(bnd.find(t).text) for t in ("xmin", "ymin", "xmax", "ymax")]
                ignore = bool(self.min_size) and (bbox[2] - bbox[0] < self.min_size
                                                  or bbox[3] - bbox[1] < self.min_size)
                if difficult or ignore:
                    bboxes_ignore.append(bbox)
                    labels_ignore.append(label)
                else:
                    bboxes.append(bbox)
                    labels.append(label)
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(bboxes_ignore, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(labels_ignore, np.int64))


@DATASETS.register_module()
class VOCDataset(XMLDataset):
    CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.year = 2007 if "VOC2007" in self.img_prefix else 2012

    def evaluate(self, results, metric="mAP", logger=None, iou_thr=0.5, **kwargs):
        """VOC mAP: 11-point for VOC2007, area otherwise; legacy +1 widths."""
        from ...core.evaluation.mean_ap import eval_map
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        mode = "11points" if self.year == 2007 else "area"
        mean_ap, _ = eval_map(results, annotations, iou_thr=iou_thr,
                              dataset=self.CLASSES, logger=logger, mode=mode,
                              use_legacy_coordinate=True)
        return {"mAP": mean_ap}


@DATASETS.register_module()
class SdgodDataset(XMLDataset):
    """The Diverse Weather Dataset (reference mmdet/datasets/sdgod.py:12)."""
    CLASSES = ('bus', 'bike', 'car', 'motor', 'person', 'rider', 'truck')

    def evaluate(self, results, metric="mAP", logger=None, iou_thr=0.5,
                 scale_ranges=None, **kwargs):
        """Area mAP with legacy +1 widths, rounded to 4 places, and
        ``AP_<class>`` per class."""
        from ...core.evaluation.mean_ap import eval_map
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        mean_ap, per_cls = eval_map(
            results, annotations, scale_ranges=scale_ranges, iou_thr=iou_thr,
            dataset=self.CLASSES, logger=logger, use_legacy_coordinate=True)
        out = {"mAP": round(mean_ap, 4)}
        for name, r in zip(self.CLASSES, per_cls):
            out[f"AP_{name}"] = round(r["ap"], 4)
        return out
