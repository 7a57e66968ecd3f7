"""Config loading, shared with the JAX package.

The config system is ``oadg_tpu/config/config.py``, which imports only the
standard library. It is loaded here by file path, so the JAX package (whose
``__init__`` imports JAX) is never imported.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_CONFIG_PY = Path(__file__).resolve().parent.parent / "oadg_tpu" / "config" / "config.py"
_MODULE_NAME = "oadg_tpu_torch._shared_config"


def _config_module():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_MODULE_NAME, _CONFIG_PY)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_MODULE_NAME] = mod
        spec.loader.exec_module(mod)
    return mod


def load_config(path):
    """mmdet-style python config file -> ``Config`` (``_base_`` resolved;
    ``custom_imports`` not executed, since they name JAX-side modules)."""
    return _config_module().Config.fromfile(str(path), import_custom_modules=False)
