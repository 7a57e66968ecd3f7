"""mmcv-style python-file configs (the port's own copy of the subset of
``oadg_tpu/config/config.py`` it needs: ``_base_`` inheritance with deep
merge and ``_delete_`` keys, dot access on nested dicts).

The OA-DG configs name their bases by the reference's absolute
``/ws/external/...`` paths; those resolve onto this repository's ``configs/``
tree. ``custom_imports`` are not executed: they name JAX-side modules.
"""
from __future__ import annotations

import argparse
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

    def merge_from_dict(self, options: Dict[str, Any]):
        """Merge dotted-key overrides in place, e.g. ``{'model.backbone.depth':
        101}`` or ``{'data.test.pipeline.1.img_scale': (1024, 512)}`` (a
        digit key indexes a list): what ``--cfg-options`` passes
        (``oadg_tpu/config/config.py:287``)."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        merged = _merge(_plain(self), option_cfg, allow_list_keys=True)
        dict.clear(self)
        for k, v in merged.items():
            self[k] = v

    def dump(self, file: str):
        """Write the config as a python file that ``load_config`` reads
        back as it is: one ``key = value`` line a top-level key."""
        import pprint
        with open(file, "w", encoding="utf-8") as f:
            for k, v in self.items():
                f.write(f"{k} = {pprint.pformat(_plain(v), width=100, sort_dicts=False)}\n")


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


def _plain(obj):
    """``obj`` with every nested ``ConfigDict`` turned into a plain dict."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _merge(base, override: dict, allow_list_keys: bool = False):
    """Deep-merge ``override`` into ``base``; ``dict(_delete_=True, ...)``
    replaces instead of merging. With ``allow_list_keys`` a digit key of
    ``override`` indexes a list of ``base``, as in mmcv's
    ``Config._merge_a_into_b``."""
    base = copy.deepcopy(base)
    for k, v in override.items():
        if allow_list_keys and k.isdigit() and isinstance(base, list):
            k = int(k)
            if len(base) <= k:
                raise KeyError(f"index {k} exceeds list length {len(base)}")
            base[k] = (_merge(base[k], v, allow_list_keys) if isinstance(v, dict)
                       else v)
            continue
        if isinstance(v, dict):
            v = dict(v)
            mergeable = (dict, list) if allow_list_keys else dict
            if k in base and isinstance(base[k], mergeable) and not v.pop(_DELETE_KEY, False):
                base[k] = _merge(base[k], v, allow_list_keys)
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


class DictAction(argparse.Action):
    """argparse action for ``KEY=VALUE`` pairs whose values are Python
    literals (``oadg_tpu/config/config.py:320``): ``true`` / ``false`` are
    booleans, an unparsable value with commas a tuple of its parts, anything
    else the string."""

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, val = kv.split("=", maxsplit=1)
            options[key] = self.parse_value(val)
        setattr(namespace, self.dest, options)

    @staticmethod
    def parse_value(val: str):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        if val.lower() in ("true", "false"):
            return val.lower() == "true"
        if "," in val:
            return tuple(DictAction.parse_value(v) for v in val.split(","))
        return val
