"""Training engine of the port: optimizer, LR schedule, OA-Mix preprocess and the train step."""
from .optim import build_lr_schedule, build_optimizer
from .preprocess import make_oadg_preprocess
from .train_step import make_train_step, parse_losses

__all__ = ["build_lr_schedule", "build_optimizer", "make_oadg_preprocess",
           "make_train_step", "parse_losses"]
