"""Backbones of the port."""
from .darknet import Darknet
from .hourglass import HourglassNet
from .resnet import ResNet, ResNeXt
from .trident_resnet import TridentResNet

__all__ = ["Darknet", "HourglassNet", "ResNet", "ResNeXt", "TridentResNet"]
