"""Training hooks of the port; importing this registers them in ``HOOKS``."""
from .hooks import (CheckLossHook, EMAHook, ExpMomentumEMAHook, Hook,
                    LinearMomentumEMAHook, NumClassCheckHook, TextLoggerHook)

__all__ = ["CheckLossHook", "EMAHook", "ExpMomentumEMAHook", "Hook",
           "LinearMomentumEMAHook", "NumClassCheckHook", "TextLoggerHook"]
