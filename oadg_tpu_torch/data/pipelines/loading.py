"""Loading pipeline ops (port of ``oadg_tpu/data/pipelines/loading.py:22,53,68,200``):
the image from its file (``image_io.imread``, the counterpart of
``cv2.imread``) or from the caller's array, the annotation's boxes,
labels and instance masks, and a COCO-panoptic PNG's masks and label map.
numpy on the host."""
from __future__ import annotations

import os.path as osp
from typing import Any, Dict

import numpy as np

from ...utils.registry import PIPELINES
from .image_io import imread


@PIPELINES.register_module()
class LoadImageFromFile:
    """``img`` (H, W, 3) uint8 BGR (RGB with ``channel_order='rgb'``) from
    ``img_prefix / img_info['filename']``; ``float32`` with ``to_float32``."""

    def __init__(self, to_float32: bool = False, color_type: str = "color",
                 channel_order: str = "bgr", file_client_args=None):
        self.to_float32 = to_float32
        self.color_type = color_type
        self.channel_order = channel_order

    def __call__(self, results: Dict[str, Any]):
        if results.get("img_prefix") is not None:
            filename = osp.join(results["img_prefix"],
                                results["img_info"]["filename"])
        else:
            filename = results["img_info"]["filename"]
        img = imread(filename, self.color_type)
        if self.channel_order == "rgb":
            img = np.ascontiguousarray(img[..., ::-1])
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = filename
        results["ori_filename"] = results["img_info"]["filename"]
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["img_fields"] = ["img"]
        return results


@PIPELINES.register_module()
class LoadImageFromWebcam(LoadImageFromFile):
    """The caller's array in ``results['img']`` instead of a file."""

    def __call__(self, results):
        img = results["img"]
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = None
        results["ori_filename"] = None
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["img_fields"] = ["img"]
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """``gt_bboxes`` (and ``gt_bboxes_ignore``) and ``gt_labels`` from
    ``results['ann_info']``; with ``with_mask``, ``gt_masks``: each
    instance's polygons or uncompressed RLE (``ann_info['masks']``) drawn
    full-image and cropped to its box at 56 x 56, (N, 56, 56) float32
    (``loading.py:87-121``), with ``mask_fields``. Segmentation maps
    (``with_seg``) are not ported: ``LoadPanopticAnnotations`` reads the
    panoptic ones."""

    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False,
                 poly2mask: bool = True, file_client_args=None):
        if with_seg:
            raise NotImplementedError("LoadAnnotations(with_seg): segmentation maps are "
                                      "not ported (ROADMAP A, 'Long tail': panoptic heads)")
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask

    def __call__(self, results: Dict[str, Any]):
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].copy()
            results["bbox_fields"] = ["gt_bboxes"]
            if ann.get("bboxes_ignore") is not None:
                results["gt_bboxes_ignore"] = ann["bboxes_ignore"].copy()
                results["bbox_fields"].append("gt_bboxes_ignore")
        if self.with_label:
            results["gt_labels"] = ann["labels"].copy()
        if self.with_mask:
            results["gt_masks"] = self._load_masks(results, ann)
            results["mask_fields"] = ["gt_masks"]
        return results

    @staticmethod
    def _load_masks(results, ann) -> np.ndarray:
        """Each instance of ``ann['masks']`` (a list of polygons, flat
        ``[x0, y0, x1, y1, ...]``, or an uncompressed RLE dict, column-major
        with ``size``) as a full-image bitmap, cropped to its box of
        ``ann['bboxes']`` at 56 x 56 (``BitmapMasks.to_box_cropped``)."""
        from ...core.mask.structures import BitmapMasks, PolygonMasks   # not on the image path
        h = results["img_info"].get("height") or results["img"].shape[0]
        w = results["img_info"].get("width") or results["img"].shape[1]
        insts = []
        for m in ann.get("masks") or []:
            if m is None or (isinstance(m, dict) and isinstance(m.get("counts"), str)):
                raise ValueError("LoadAnnotations(with_mask=True) takes polygons or "
                                 "uncompressed RLE; got an annotation without "
                                 "segmentation or a compressed RLE")
            if isinstance(m, dict):            # uncompressed RLE
                flat = np.zeros(h * w, np.uint8)
                pos, val = 0, 0
                for c in m.get("counts", []):
                    flat[pos:pos + c] = val
                    pos += c
                    val = 1 - val
                insts.append(flat.reshape(w, h).T if m.get("size") else flat.reshape(h, w))
            else:                              # polygons
                insts.append(PolygonMasks([m], h, w).to_bitmap().masks[0])
        boxes = ann["bboxes"] if insts else np.zeros((0, 4), np.float32)
        return BitmapMasks(insts, h, w).to_box_cropped(boxes, m0=56)


@PIPELINES.register_module()
class LoadPanopticAnnotations:
    """``oadg_tpu/data/pipelines/loading.py:200``: the boxes and labels of
    ``ann_info`` (the thing segments', ``CocoPanopticDataset.get_ann_info``),
    the panoptic PNG of ``seg_prefix / ann_info['seg_map']`` decoded by the
    port's reader (BGR, as ``cv2.imread``, reversed to RGB) into segment ids
    ``R + 256 G + 65536 B``; ``gt_masks`` (n, H, W) uint8, one full-image
    mask per thing segment in ``all_seg_ids`` order; ``gt_semantic_seg``
    (H, W) uint8, every segment's (thing and stuff) label, 255 void. numpy
    on the host, equal to the JAX op's outputs. It always loads all three:
    a ``with_bbox``, ``with_mask`` or ``with_seg`` set False is refused."""

    def __init__(self, **kwargs):
        off = [k for k in ("with_bbox", "with_mask", "with_seg") if kwargs.get(k, True) is False]
        if off:
            raise ValueError(f"LoadPanopticAnnotations({', '.join(off)}=False) is not ported: "
                             "it always loads the boxes, the thing masks and the label map")

    def __call__(self, results: Dict[str, Any]):
        from ...core.evaluation.panoptic_eval import rgb2id
        ann = results["ann_info"]
        results["gt_bboxes"] = ann["bboxes"]
        results["gt_labels"] = ann["labels"]
        results.setdefault("bbox_fields", []).append("gt_bboxes")
        seg_map = ann.get("seg_map")
        prefix = results.get("seg_prefix")
        id_map = rgb2id(imread(osp.join(prefix, seg_map) if prefix else seg_map)[..., ::-1])
        masks = [(id_map == sid).astype(np.uint8)
                 for sid, thing in zip(ann["all_seg_ids"], ann["seg_isthing"]) if thing]
        results["gt_masks"] = (np.stack(masks) if masks
                               else np.zeros((0,) + id_map.shape, np.uint8))
        results.setdefault("mask_fields", []).append("gt_masks")
        sem = np.full(id_map.shape, 255, np.uint8)
        for sid, lbl in zip(ann["all_seg_ids"], ann["seg_labels"]):
            sem[id_map == sid] = lbl
        results["gt_semantic_seg"] = sem
        results.setdefault("seg_fields", []).append("gt_semantic_seg")
        return results
