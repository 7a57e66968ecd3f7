"""Backbones of the port."""
from .darknet import Darknet
from .resnet import ResNet

__all__ = ["Darknet", "ResNet"]
