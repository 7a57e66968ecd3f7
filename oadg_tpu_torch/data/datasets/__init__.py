"""Datasets of the port's test and train paths; importing this registers them."""
from .coco import CityscapesDataset, CocoDataset
from .custom import ConcatDataset, CustomDataset, RepeatDataset
from .more_datasets import CocoPanopticDataset
from .xml_style import SdgodDataset, VOCDataset, XMLDataset

__all__ = ["CityscapesDataset", "CocoDataset", "CocoPanopticDataset", "ConcatDataset", "CustomDataset",
           "RepeatDataset", "SdgodDataset", "VOCDataset", "XMLDataset"]
