"""Backbones of the port."""
from .csp_darknet import CSPDarknet
from .darknet import Darknet
from .hourglass import HourglassNet
from .mobilenet_v2 import MobileNetV2
from .regnet import RegNet
from .resnest import ResNeSt
from .resnet import Res2Net, ResNet, ResNeXt
from .ssd_vgg import SSDVGG
from .trident_resnet import TridentResNet

__all__ = ["CSPDarknet", "Darknet", "HourglassNet", "MobileNetV2", "RegNet", "Res2Net",
           "ResNeSt", "ResNet", "ResNeXt", "SSDVGG", "TridentResNet"]
