"""Engine of the port: optimizer, LR schedule, OA-Mix preprocess, the train and
test steps, and the epoch runner (``engine/runner.py``, imported where used)."""
from .optim import build_lr_schedule, build_optimizer
from .preprocess import make_oadg_preprocess
from .train_step import (make_test_step, make_train_step, parse_losses,
                         upload_train_batch)

__all__ = ["build_lr_schedule", "build_optimizer", "make_oadg_preprocess",
           "make_test_step", "make_train_step", "parse_losses", "upload_train_batch"]
