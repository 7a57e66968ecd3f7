"""Backbones of the port."""
from .darknet import Darknet
from .resnet import ResNet, ResNeXt
from .trident_resnet import TridentResNet

__all__ = ["Darknet", "ResNet", "ResNeXt", "TridentResNet"]
