"""Training engine of the port: optimizer, LR schedule and the train step."""
from .optim import build_lr_schedule, build_optimizer
from .train_step import make_train_step, parse_losses

__all__ = ["build_lr_schedule", "build_optimizer", "make_train_step",
           "parse_losses"]
