"""Shared model helpers of the port (``oadg_tpu/models/utils/``): the
gaussian heatmap targets of CenterNet and the corner heads."""
from .misc import class_planes, gaussian_radius, gen_gaussian_target, images_mean

__all__ = ["class_planes", "gaussian_radius", "gen_gaussian_target", "images_mean"]
