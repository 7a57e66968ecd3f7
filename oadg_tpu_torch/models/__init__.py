"""Models of the port; importing this registers every type the serving and
training slices build."""
from . import backbones, dense_heads, detectors, losses, necks, roi_heads  # noqa: F401
from ..core import anchor, bbox  # noqa: F401  (prior generator, box coder)
from .builder import build_detector

__all__ = ["build_detector"]
