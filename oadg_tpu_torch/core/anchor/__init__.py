from .anchor_generator import AnchorGenerator, YOLOAnchorGenerator

__all__ = ["AnchorGenerator", "YOLOAnchorGenerator"]
