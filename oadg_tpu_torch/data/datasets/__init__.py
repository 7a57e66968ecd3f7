"""Datasets of the port's test path; importing this registers them."""
from .coco import CityscapesDataset, CocoDataset
from .custom import ConcatDataset, CustomDataset, RepeatDataset

__all__ = ["CityscapesDataset", "CocoDataset", "ConcatDataset", "CustomDataset",
           "RepeatDataset"]
