from .anchor_generator import AnchorGenerator, SSDAnchorGenerator, YOLOAnchorGenerator

__all__ = ["AnchorGenerator", "SSDAnchorGenerator", "YOLOAnchorGenerator"]
