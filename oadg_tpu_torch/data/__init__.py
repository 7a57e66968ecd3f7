"""Data layer of the port (``oadg_tpu/data``): the datasets, the test and
train pipelines and the loader. numpy on the host, as in the JAX package."""
from . import datasets, pipelines, samplers  # noqa: F401  (registers their types)
from .builder import (PrefetchLoader, StaticBatcher, build_dataloader, build_dataset,
                      static_hw_from_pipeline)

__all__ = ["PrefetchLoader", "StaticBatcher", "build_dataloader", "build_dataset",
           "static_hw_from_pipeline"]
