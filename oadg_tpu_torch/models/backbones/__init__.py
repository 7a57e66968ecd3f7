"""Backbones of the port."""
from .darknet import Darknet
from .resnet import ResNet, ResNeXt

__all__ = ["Darknet", "ResNet", "ResNeXt"]
