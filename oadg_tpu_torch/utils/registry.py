"""Name -> class registries for the types the configs name
(port of ``oadg_tpu/utils/registry.py``, reduced to what the serving,
training, test and runner slices build: ``dict(type='Name', **kwargs)`` -> ``Name(**kwargs)``)."""
from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    """A string -> class map filled by ``@REGISTRY.register_module()``."""

    def __init__(self, name: str):
        self.name = name
        self.module_dict: Dict[str, Any] = {}

    def get(self, key: str):
        return self.module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module=None):
        """Decorator registering a class under its name (or ``name``);
        ``register_module(name=..., module=cls)`` registers ``cls`` at once."""
        def _decorator(cls):
            key = name or cls.__name__
            if key in self.module_dict:
                raise KeyError(f"{key} is already registered in {self.name}")
            self.module_dict[key] = cls
            return cls
        return _decorator if module is None else _decorator(module)


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: Optional[dict] = None):
    """``registry[cfg['type']](**rest, **default_args)``; cfg keys win."""
    args = dict(default_args or {})
    args.update(cfg)
    name = args.pop("type")
    cls = registry.get(name)
    if cls is None:
        raise KeyError(f"{name} is not registered in {registry.name} "
                       "(the port builds only the ported slices' types)")
    return cls(**args)


def cfg_args(cfg: Optional[dict], default: dict, type_name: str) -> dict:
    """The keyword arguments of ``cfg`` (``default`` when it is empty),
    without its ``type``, for the class ``type_name``; a ``type`` that
    names another class raises ``ValueError`` (a missing one is
    ``type_name``)."""
    args = dict(cfg or default)
    name = args.pop("type", type_name)
    if name != type_name:
        raise ValueError(f"{name} is not ported: this takes {type_name} (the port builds "
                         "only the ported slices' types)")
    return args


BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
ROI_EXTRACTORS = Registry("roi_extractor")
DETECTORS = Registry("detector")
PRIOR_GENERATORS = Registry("prior_generator")
BBOX_CODERS = Registry("bbox_coder")
BBOX_ASSIGNERS = Registry("bbox_assigner")
BBOX_SAMPLERS = Registry("bbox_sampler")
LOSSES = Registry("loss")
DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")
HOOKS = Registry("hook")
