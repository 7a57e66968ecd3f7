"""Backbones of the port."""
from .resnet import ResNet

__all__ = ["ResNet"]
