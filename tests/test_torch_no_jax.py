"""The port stands alone: no import of JAX, flax, optax or the JAX package
anywhere in ``oadg_tpu_torch/`` or ``chip_smoke.py``, none at run time (the
config loader is the port's own copy, held here to the JAX package's on
the OA-DG configs), and no silent CPU fallback for a CUDA device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "oadg_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    return sorted((ROOT / "oadg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax():
    files = _port_sources()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, oadg_tpu_torch.apis, oadg_tpu_torch.utils.checkpoint, "
            "oadg_tpu_torch.engine, oadg_tpu_torch.models.losses, "
            "oadg_tpu_torch.ops.oamix_device, oadg_tpu_torch.engine.preprocess, "
            "oadg_tpu_torch.utils.draws, oadg_tpu_torch.config as c; "
            "c.load_config('configs/OA-DG/cityscapes/"
            "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_init_detector_cuda_without_card_raises(monkeypatch):
    from oadg_tpu_torch.apis import init_detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(ROOT / "configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py", device="cuda")


def test_build_detector_defaults_to_the_card(monkeypatch):
    """``build_detector`` builds on ``cuda`` unless told otherwise, and
    raises without a card; ``device="cpu"`` builds on the CPU."""
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.models import build_detector
    model = load_config(ROOT / "configs/OA-DG/cityscapes/"
                        "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py")["model"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(dict(model))
    det = build_detector(dict(model), device="cpu", num_views=2)
    assert {p.device.type for p in det.parameters()} == {"cpu"}


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("path", [
    "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py",
    "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py",
    "configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py"])
def test_config_loader_matches_the_jax_package(path):
    from oadg_tpu.config import Config
    from oadg_tpu_torch.config import load_config
    want = Config.fromfile(str(ROOT / path), import_custom_modules=False).to_dict()

    def plain(o):
        if isinstance(o, dict):
            return {k: plain(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(plain(v) for v in o)
        return o

    assert plain(load_config(ROOT / path)) == want
