"""Necks of the port."""
from .fpn import FPN

__all__ = ["FPN"]
