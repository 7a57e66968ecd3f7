"""Instance masks of the port (host-side numpy)."""
from .structures import BitmapMasks, PolygonMasks, paste_masks

__all__ = ["BitmapMasks", "PolygonMasks", "paste_masks"]
