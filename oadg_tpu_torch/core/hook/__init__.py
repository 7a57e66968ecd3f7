"""Training hooks of the port; importing this registers them in ``HOOKS``."""
from .hooks import (CheckLossHook, EMAHook, ExpMomentumEMAHook, FeatureHook, Hook,
                    LinearMomentumEMAHook, NumClassCheckHook, ProfilerHook, SetEpochInfoHook,
                    SyncNormHook, SyncRandomSizeHook, TextLoggerHook, WandbLogger,
                    WandbLoggerMulti, YOLOXModeSwitchHook)

__all__ = ["CheckLossHook", "EMAHook", "ExpMomentumEMAHook", "FeatureHook", "Hook",
           "LinearMomentumEMAHook", "NumClassCheckHook", "ProfilerHook", "SetEpochInfoHook",
           "SyncNormHook", "SyncRandomSizeHook", "TextLoggerHook", "WandbLogger",
           "WandbLoggerMulti", "YOLOXModeSwitchHook"]
