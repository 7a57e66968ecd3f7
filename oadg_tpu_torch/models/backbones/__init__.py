"""Backbones of the port."""
from .csp_darknet import CSPDarknet
from .darknet import Darknet
from .hourglass import HourglassNet
from .resnet import ResNet, ResNeXt
from .ssd_vgg import SSDVGG
from .trident_resnet import TridentResNet

__all__ = ["CSPDarknet", "Darknet", "HourglassNet", "ResNet", "ResNeXt", "SSDVGG",
           "TridentResNet"]
