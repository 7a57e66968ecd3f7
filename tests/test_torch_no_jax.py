"""The port stands alone: no import of JAX, flax, optax or the JAX package
anywhere in ``oadg_tpu_torch/``, ``chip_smoke.py`` or the ``tools/torch_*.py``
entry points,
none at run time (the config loader is the port's own copy, held here to
the JAX package's on the OA-DG configs), no OpenCV or PIL on the PNG and
JPEG paths (``image_io`` does not import ``cv2`` at all), no OpenCV or PIL
in the corruption suite and the robustness tools, and no silent CPU
fallback for a CUDA device."""
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
    return sorted((ROOT / "oadg_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_test.py",
        ROOT / "tools" / "torch_train.py", ROOT / "tools" / "torch_test_robustness.py",
        ROOT / "tools" / "torch_robustness_eval.py",
        ROOT / "tools" / "torch_get_corrupted_dataset.py",
        ROOT / "tools" / "torch_test_dwd.py"]


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
            "oadg_tpu_torch.utils.draws, oadg_tpu_torch.data, "
            "oadg_tpu_torch.core.evaluation, oadg_tpu_torch.apis.test, "
            "oadg_tpu_torch.apis.train, oadg_tpu_torch.engine.runner, "
            "oadg_tpu_torch.core.hook, oadg_tpu_torch.data.pipelines.oa_mix, "
            "oadg_tpu_torch.utils.host_kernels, oadg_tpu_torch.utils.jpeg, "
            "oadg_tpu_torch.data.datasets.xml_style, "
            "oadg_tpu_torch.models.backbones.resnet, "
            "oadg_tpu_torch.core.post_processing.nms, oadg_tpu_torch.engine.optim, "
            "oadg_tpu_torch.core.bbox.transforms, oadg_tpu_torch.core.hook.hooks, "
            "oadg_tpu_torch.models.detectors.two_stage, "
            "oadg_tpu_torch.models.detectors.single_stage, "
            "oadg_tpu_torch.core.mask, oadg_tpu_torch.models.roi_heads.mask_heads, "
            "oadg_tpu_torch.config as c; "
            "sys.path.insert(0, 'tools'); import torch_test_dwd; "
            "c.load_config('configs/OA-DG/cityscapes/"
            "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py'); "
            "c.load_config('configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py'); "
            "c.load_config('configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_data_parallel_loads_no_jax():
    """``parallel/``, ``data/samplers.py`` and the launcher paths of both
    tools import and run (``init_distributed`` with no launcher environment,
    each sampler once) without loading JAX or the JAX package."""
    code = ("import sys, numpy as np; sys.path.insert(0, 'tools'); "
            "import oadg_tpu_torch.parallel as p, oadg_tpu_torch.data.samplers as s, "
            "torch_train, torch_test; "
            "assert p.init_distributed('pytorch', device='cpu') == (0, 1); "
            "ds = type('D', (), {'__len__': lambda self: 5})(); "
            "[list(c(ds)) for c in (s.GroupSampler, s.DistributedGroupSampler, "
            "s.DistributedSampler)]; "
            "assert torch_train.parse_args(['c.py', '--launcher', 'slurm']).launcher == 'slurm'; "
            "assert torch_test.parse_args(['c.py', 'x', '--launcher', 'mpi']).launcher == 'mpi'; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("script,target", [("torch_dist_train.sh", "torch_train.py"),
                                           ("torch_dist_test.sh", "torch_test.py")])
def test_dist_scripts_launch_the_port_tools(script, target):
    """The two launch scripts start the port's own tools (which import no
    JAX: ``test_sources_import_no_jax``) through ``torch.distributed.run``
    with ``--launcher pytorch``, never the JAX package's ``tools/*.py``."""
    text = (ROOT / "tools" / script).read_text()
    assert "-m torch.distributed.run" in text and "--launcher pytorch" in text
    assert f'"$(dirname "$0")/{target}"' in text
    assert ROOT / "tools" / target in _port_sources()
    assert all(f"/{name}.py" not in text for name in ("train", "test"))


def test_png_path_loads_no_opencv_or_pil(tmp_path):
    """Importing the port, writing a PNG with its encoder and reading it
    back through ``LoadImageFromFile`` loads neither ``cv2`` nor PIL."""
    code = ("import sys, numpy as np, oadg_tpu_torch.apis, oadg_tpu_torch.data; "
            "from oadg_tpu_torch.data.pipelines import image_io, LoadImageFromFile; "
            "img = np.arange(6 * 7 * 3, dtype=np.uint8).reshape(6, 7, 3); "
            f"image_io.imwrite({str(tmp_path / 'a.png')!r}, img); "
            "out = LoadImageFromFile()(dict(img_prefix=None, img_info=dict("
            f"filename={str(tmp_path / 'a.png')!r})))['img']; "
            "assert (out == img).all(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'jax', 'oadg_tpu')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_jpeg_path_loads_no_opencv_or_pil(tmp_path):
    """Writing a JPEG with the port's encoder and reading it back through
    ``LoadImageFromFile`` and ``SdgodDataset``'s pipeline loads neither
    ``cv2`` nor PIL, and ``image_io`` names no ``cv2`` in its source."""
    path = tmp_path / "a.jpg"
    code = ("import sys, numpy as np, oadg_tpu_torch.apis, oadg_tpu_torch.data; "
            "from oadg_tpu_torch.data.pipelines import image_io, LoadImageFromFile; "
            "img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8); "
            f"image_io.imwrite({str(path)!r}, img); "
            "out = LoadImageFromFile()(dict(img_prefix=None, img_info=dict("
            f"filename={str(path)!r})))['img']; "
            "from oadg_tpu_torch.utils.jpeg import jpeg_roundtrip; "
            "assert (out == jpeg_roundtrip(img, 95)).all(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'jax', 'oadg_tpu')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    source = (ROOT / "oadg_tpu_torch/data/pipelines/image_io.py").read_text()
    mods = list(_imports(ROOT / "oadg_tpu_torch/data/pipelines/image_io.py"))
    assert "cv2" not in mods and "import cv2" not in source


def test_corruptions_and_robustness_tools_load_no_opencv_pil_or_jax():
    """Importing the suite, its OpenCV stand-ins and the three robustness
    tools, and running the corruptions that call OpenCV in the JAX package,
    loads none of ``cv2``, PIL, JAX or the JAX package."""
    code = ("import sys, numpy as np; sys.path.insert(0, 'tools'); "
            "import oadg_tpu_torch.ops.corruptions as c, oadg_tpu_torch.ops.cv_host, "
            "torch_test_robustness, torch_robustness_eval, torch_get_corrupted_dataset; "
            "img = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(np.uint8); "
            "[c.corrupt_numpy(img, n, 3, rng=np.random.RandomState(1)) for n in ("
            "'defocus_blur', 'motion_blur', 'zoom_blur', 'snow', 'frost', 'brightness', "
            "'saturate', 'elastic_transform', 'pixelate', 'jpeg_compression', 'spatter')]; "
            "c.corrupt_numpy(img, 'spatter', 1, rng=np.random.RandomState(1)); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'jax', 'jaxlib', 'oadg_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_image_decoder_does_not_load_the_evaluation():
    """The PNG decoder reaches the host library through ``utils``, not
    through ``core/evaluation``."""
    code = ("import sys, numpy as np; from oadg_tpu_torch.data.pipelines import image_io; "
            "img = np.arange(6 * 7 * 3, dtype=np.uint8).reshape(6, 7, 3); "
            "assert (image_io.decode_png(image_io.encode_png(img)) == img).all(); "
            "bad = sorted(m for m in sys.modules if m.startswith('oadg_tpu_torch.core')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_train_tool_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    """``tools/torch_train.py`` builds the model on ``cuda`` unless
    ``--device cpu``, and raises without a card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_train_tool",
                                                  ROOT / "tools" / "torch_train.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([str(ROOT / "configs/OA-DG/cityscapes/"
                           "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"),
                   "--work-dir", str(tmp_path), "--seed", "0"])


def test_init_detector_cuda_without_card_raises(monkeypatch):
    from oadg_tpu_torch.apis import init_detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(ROOT / "configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py", device="cuda")


def test_test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``load_model_state`` and ``tools/torch_test.py`` run on ``cuda``
    unless told otherwise, and raise without a card."""
    import importlib.util

    from oadg_tpu_torch.apis import load_model_state
    from oadg_tpu_torch.config import load_config
    cfg = load_config(ROOT / "configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_state(cfg, "none")
    for name in ("torch_test", "torch_test_dwd"):
        spec = importlib.util.spec_from_file_location(f"{name}_tool",
                                                      ROOT / "tools" / f"{name}.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        assert tool.parse_args(["c.py", "none"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([str(ROOT / "configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py"),
                   "none", "--out-dir", str(tmp_path)])


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


def test_yolo_path_loads_no_jax_opencv_or_pil():
    """The YOLOv3 path: both YOLOv3 configs load, the OA-DG one builds on the
    CPU (Darknet-53, the YOLO neck and head), and its SSD-style train
    pipeline ops (``Expand``, ``MinIoURandomCrop``, the float32 ``Resize``,
    ``PhotoMetricDistortion`` with its HSV round trip) run, loading none of
    ``cv2``, PIL, JAX or the JAX package."""
    code = ("import sys, numpy as np, oadg_tpu_torch.config as c; "
            "from oadg_tpu_torch.models import build_detector; "
            "from oadg_tpu_torch.data.pipelines import Compose; "
            "cfg = c.load_config('configs/OA-DG/cityscapes/"
            "yolov3_d53_mstrain-1024_20e_oadg.py'); "
            "c.load_config('configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e.py'); "
            "m = build_detector(dict(cfg.model), device='cpu', num_views=2); "
            "ops = Compose([p for p in cfg.data.train.pipeline[2:8]]); np.random.seed(0); "
            "img = np.random.uniform(0, 255, (60, 90, 3)).astype(np.float32); "
            "out = ops(dict(img=img, img_shape=img.shape, img_fields=['img'], "
            "bbox_fields=['gt_bboxes'], gt_bboxes=np.array([[5, 5, 40, 30]], np.float32), "
            "gt_labels=np.array([1]))); "
            "assert out['img_raw'].dtype == np.float32 and max(out['img'].shape) <= 1024; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'PIL', 'jax', 'jaxlib', 'oadg_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_test_time_and_engine_paths_load_no_jax(tmp_path):
    """On the CPU: the tiny flagship's test-time augmentation (two views,
    one flipped) and gaussian soft-NMS, AdamW with the cosine schedule and
    exp warmup, every hook built from a config, and an mmdet-layout
    checkpoint grafted by ``init_detector``: none of them loads JAX, the
    JAX package or OpenCV."""
    code = f"""
import sys, copy, numpy as np, torch
sys.path.insert(0, 'tests')
import torch_data_cases as cases
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from oadg_tpu_torch.utils.registry import HOOKS, build_from_cfg
import oadg_tpu_torch.core.hook
cfg = cases.tiny_model(load_config(cases.FLAGSHIP))
cfg.model.test_cfg.rcnn.nms = dict(type='soft_nms', method='gaussian', min_score=0.05)
h = init_detector(cfg, device='cpu')
img = torch.randn(1, 3, 64, 96)
view = dict(img=img, img_shape=torch.tensor([[64., 96.]]), scale_factor=torch.ones(1, 4))
with torch.inference_mode():
    d, l, v = h.model.aug_test([view, dict(view, img=img.flip(-1))],
                               ((False, 'horizontal'), (True, 'horizontal')))
assert d.shape == (1, 10, 5)
opt = build_optimizer(h.model, dict(type='AdamW', lr=1e-4, weight_decay=0.05))
sched = build_lr_schedule(dict(policy='CosineAnnealing', min_lr_ratio=0.01, warmup='exp',
                               warmup_iters=2, warmup_ratio=0.1), 1e-4, 3, max_epochs=1)
assert type(opt).__name__ == 'AdamW' and sched(0) < sched(2)
for name in ('YOLOXModeSwitchHook', 'SyncRandomSizeHook', 'SetEpochInfoHook', 'SyncNormHook',
             'FeatureHook', 'WandbLogger', 'WandbLoggerMulti', 'ProfilerHook'):
    build_from_cfg(dict(type=name), HOOKS)
sd = dict(h.model.state_dict(), **{{'backbone.bn1.num_batches_tracked': torch.tensor(1)}})
torch.save(dict(meta=dict(epoch=1), state_dict=sd, optimizer=dict()), {str(tmp_path / "m.pth")!r})
r = init_detector(cfg, {str(tmp_path / "m.pth")!r}, device='cpu', seed=3).checkpoint_report
assert not r['missing'] and len(r['skipped']) == 1
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('cv2', 'jax', 'jaxlib', 'flax', 'optax', 'oadg_tpu'))
print(bad); sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
