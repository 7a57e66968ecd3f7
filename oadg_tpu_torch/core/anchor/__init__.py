from .anchor_generator import AnchorGenerator

__all__ = ["AnchorGenerator"]
