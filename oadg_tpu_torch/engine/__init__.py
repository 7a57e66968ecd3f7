"""Engine of the port: optimizer, LR schedule, OA-Mix preprocess, the train and test steps."""
from .optim import build_lr_schedule, build_optimizer
from .preprocess import make_oadg_preprocess
from .train_step import make_test_step, make_train_step, parse_losses

__all__ = ["build_lr_schedule", "build_optimizer", "make_oadg_preprocess",
           "make_test_step", "make_train_step", "parse_losses"]
