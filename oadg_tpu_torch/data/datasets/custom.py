"""``CustomDataset`` and the ``RepeatDataset`` / ``ConcatDataset`` wrappers
(port of ``oadg_tpu/data/datasets/custom.py``).

Host-side dataset: annotation loading, pipeline invocation, aspect-ratio
group flags, empty-gt filtering and the VOC-style ``evaluate``. Subclasses
implement ``load_annotations`` / ``get_ann_info``. A sample's pipeline input
carries its index as ``sample_idx``, from which the ``Corrupt`` op seeds
the image's draws (``Collect`` drops it).
"""
from __future__ import annotations

import os.path as osp
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...utils.registry import DATASETS
from ..pipelines.formatting import Compose


@DATASETS.register_module()
class CustomDataset:
    CLASSES: Optional[Sequence[str]] = None
    PALETTE = None

    def __init__(self, ann_file: str, pipeline, classes=None,
                 data_root: Optional[str] = None, img_prefix: str = "",
                 seg_prefix=None, proposal_file=None, test_mode: bool = False,
                 filter_empty_gt: bool = True, file_client_args=None, **kwargs):
        self.ann_file = ann_file
        self.data_root = data_root
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.CLASSES = self.get_classes(classes)
        if self.data_root is not None:
            if not osp.isabs(self.ann_file):
                self.ann_file = osp.join(self.data_root, self.ann_file)
            if not (self.img_prefix is None or osp.isabs(self.img_prefix)):
                self.img_prefix = osp.join(self.data_root, self.img_prefix)
        self.data_infos = self.load_annotations(self.ann_file)
        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            self._set_group_flag()
        self.pipeline = Compose(pipeline)

    @classmethod
    def get_classes(cls, classes=None):
        if classes is None:
            return cls.CLASSES
        if isinstance(classes, str):
            with open(classes) as f:
                return [line.strip() for line in f if line.strip()]
        return list(classes)

    def load_annotations(self, ann_file):
        raise NotImplementedError

    def get_ann_info(self, idx) -> Dict[str, Any]:
        return self.data_infos[idx]["ann"]

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        valid = []
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and len(self.get_ann_info(i)["bboxes"]) == 0:
                continue
            if min(info["width"], info["height"]) < min_size:
                continue
            valid.append(i)
        return valid

    def _set_group_flag(self):
        """Aspect-ratio group flag: 1 for landscape images; the loader
        batches within a group."""
        self.flag = np.zeros(len(self), dtype=np.uint8)
        for i in range(len(self)):
            info = self.data_infos[i]
            if info["width"] / info["height"] > 1:
                self.flag[i] = 1

    def __len__(self):
        return len(self.data_infos)

    def pre_pipeline(self, results):
        results["img_prefix"] = self.img_prefix
        results["seg_prefix"] = getattr(self, "seg_prefix", None)
        results["bbox_fields"] = []
        results["mask_fields"] = []
        results["seg_fields"] = []
        return results

    def prepare_train_img(self, idx):
        results = dict(img_info=self.data_infos[idx],
                       ann_info=self.get_ann_info(idx), sample_idx=int(idx))
        self.pre_pipeline(results)
        return self.pipeline(results)

    def prepare_test_img(self, idx):
        results = dict(img_info=self.data_infos[idx], sample_idx=int(idx))
        self.pre_pipeline(results)
        return self.pipeline(results)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_img(idx)
        while True:
            data = self.prepare_train_img(idx)
            if data is not None:
                return data
            idx = np.random.randint(len(self))

    def get_cat_ids(self, idx):
        return self.get_ann_info(idx)["labels"].astype(np.int64).tolist()

    # ---------------- evaluation ----------------

    def get_gt_lists(self):
        """All gt as (bboxes list, labels list) per image for eval."""
        anns = [self.get_ann_info(i) for i in range(len(self))]
        return ([a["bboxes"] for a in anns], [a["labels"] for a in anns])

    def evaluate(self, results, metric="mAP", logger=None, iou_thr=0.5,
                 scale_ranges=None, **kwargs):
        """VOC-style mAP (``metric='mAP'``) or proposal recall
        (``'recall'``) over per-image per-class detection lists."""
        from ...core.evaluation.mean_ap import eval_map, eval_recalls
        metrics = metric if isinstance(metric, list) else [metric]
        eval_results = {}
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        for m in metrics:
            if m == "mAP":
                iou_thrs = [iou_thr] if isinstance(iou_thr, float) else iou_thr
                aps = []
                for t in iou_thrs:
                    mean_ap, _ = eval_map(results, annotations, iou_thr=t,
                                          dataset=self.CLASSES, logger=logger)
                    aps.append(mean_ap)
                    eval_results[f"AP{int(t * 100):02d}"] = round(mean_ap, 3)
                eval_results["mAP"] = sum(aps) / len(aps)
            elif m == "recall":
                gt_bboxes = [a["bboxes"] for a in annotations]
                rec = eval_recalls(gt_bboxes, results,
                                   proposal_nums=kwargs.get("proposal_nums",
                                                            (100, 300, 1000)),
                                   iou_thrs=iou_thr)
                eval_results["recall"] = rec
        return eval_results


@DATASETS.register_module()
class RepeatDataset:
    """Repeat a dataset ``times`` times."""

    def __init__(self, dataset, times: int, **kwargs):
        from ..builder import build_dataset
        self.dataset = (build_dataset(dataset) if isinstance(dataset, dict)
                        else dataset)
        self.times = times
        self.CLASSES = self.dataset.CLASSES
        if hasattr(self.dataset, "flag"):
            self.flag = np.tile(self.dataset.flag, times)
        self._ori_len = len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len

    def evaluate(self, *args, **kwargs):
        return self.dataset.evaluate(*args, **kwargs)


@DATASETS.register_module()
class ConcatDataset:
    """The datasets one after the other."""

    def __init__(self, datasets, separate_eval: bool = True, **kwargs):
        from ..builder import build_dataset
        self.datasets = [build_dataset(d) if isinstance(d, dict) else d
                         for d in datasets]
        self.separate_eval = separate_eval
        self.CLASSES = self.datasets[0].CLASSES
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])
        if all(hasattr(d, "flag") for d in self.datasets):
            self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        offset = 0 if d == 0 else int(self.cumulative_sizes[d - 1])
        return self.datasets[d][idx - offset]
