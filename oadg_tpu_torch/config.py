"""mmcv-style python-file configs (the port's own copy of the subset of
``oadg_tpu/config/config.py`` it needs: ``_base_`` inheritance with deep
merge and ``_delete_`` keys, dot access on nested dicts).

The OA-DG configs name their bases by the reference's absolute
``/ws/external/...`` paths; those resolve onto this repository's ``configs/``
tree. ``custom_imports`` are not executed: they name JAX-side modules.
"""
from __future__ import annotations

import ast
import copy
import os.path as osp
import types
from typing import Any, Dict

_BASE_KEY = "_base_"
_DELETE_KEY = "_delete_"
_LEGACY_PREFIXES = ("/ws/external/configs/", "/ws/external/")
_REPO_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, name, value):
        super().__setitem__(name, _to_config_dict(value))

    def __deepcopy__(self, memo):
        other = ConfigDict()
        memo[id(self)] = other
        for k, v in self.items():
            dict.__setitem__(other, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return other


def _to_config_dict(obj):
    if isinstance(obj, ConfigDict):
        return obj
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if type(obj) in (list, tuple):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _resolve_base(base: str, cur_dir: str) -> str:
    for prefix in _LEGACY_PREFIXES:
        if base.startswith(prefix):
            base = base[len(prefix):]
            if prefix.endswith("configs/"):
                base = osp.join("configs", base)
            break
    for cand in (base, osp.join(cur_dir, base), osp.join(_REPO_ROOT, base)):
        if osp.isfile(cand):
            return cand
    raise FileNotFoundError(f"base config not found: {base} (from {cur_dir})")


def _load_py(filename: str) -> Dict[str, Any]:
    with open(filename, encoding="utf-8") as f:
        content = f.read()
    ast.parse(content, filename)
    mod = types.ModuleType("_oadg_torch_cfg_")
    mod.__file__ = filename
    exec(compile(content, filename, "exec"), mod.__dict__)
    return {k: v for k, v in mod.__dict__.items()
            if not k.startswith("__")
            and not isinstance(v, (types.ModuleType, types.FunctionType, type))}


def _merge(base: dict, override: dict) -> dict:
    """Deep-merge ``override`` into ``base``; ``dict(_delete_=True, ...)``
    replaces instead of merging."""
    base = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict):
            v = dict(v)
            if k in base and isinstance(base[k], dict) and not v.pop(_DELETE_KEY, False):
                base[k] = _merge(base[k], v)
            else:
                v.pop(_DELETE_KEY, None)
                base[k] = copy.deepcopy(v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _file2dict(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    cfg = _load_py(filename)
    bases = cfg.pop(_BASE_KEY, [])
    merged: Dict[str, Any] = {}
    for base in [bases] if isinstance(bases, str) else bases:
        merged = _merge(merged, _file2dict(_resolve_base(base, osp.dirname(filename))))
    return _merge(merged, cfg)


def load_config(path) -> ConfigDict:
    """mmdet-style python config file -> nested ``ConfigDict`` with its
    ``_base_`` files merged in."""
    return _to_config_dict(_file2dict(str(path)))
