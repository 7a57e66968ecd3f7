"""Dense heads of the port."""
from .rpn_head import RPNHead

__all__ = ["RPNHead"]
