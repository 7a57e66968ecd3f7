"""Method-efficacy gate for the port: OA-DG must beat plain training on
robustness, as ``tests/test_method_efficacy.py`` requires of the JAX package.

The same fixture: the 4-image colour-coded set of ``test_overfit_map.py``
(written here by the port's PNG encoder, the same pixels), the same tiny
OA-DG and standard configs (``CONFIG_TEMPLATE`` and ``STANDARD_TEMPLATE``),
the same budget, the same 4 corruptions at severity 3 through a ``Corrupt``
op at pipeline position 1, and the same strict mPC margin ``MPC_MARGIN``.
Both arms train through ``tools/torch_train.py`` and are scored through
``tools/torch_test.py`` (mAP50), on the card when there is one.

It imports only the JAX package's test templates, so it also runs where
neither JAX nor OpenCV is installed:
``python -m pytest --noconftest -m slow tests/test_torch_method_efficacy.py``.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _jax_fixture():
    """``test_method_efficacy`` (templates, corruptions, margin); its
    module imports ``cv2`` for the JAX dataset writer, which this file does
    not call, so a stand-in module covers a machine without OpenCV."""
    stub = "cv2" not in sys.modules and importlib.util.find_spec("cv2") is None
    if stub:
        sys.modules["cv2"] = types.ModuleType("cv2")
    try:
        import test_method_efficacy as eff
    finally:
        if stub:
            del sys.modules["cv2"]
    return eff


def _make_dataset(root, n_imgs, h, w):
    """``test_overfit_map.make_dataset``'s images and boxes, written by the
    port's encoder."""
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    (root / "imgs").mkdir()
    rng = np.random.RandomState(7)
    images, annotations, aid = [], [], 0
    for i in range(n_imgs):
        img = np.full((h, w, 3), 114, np.uint8)
        images.append(dict(id=i, file_name=f"i{i}.png", width=w, height=h))
        for j, bgr in enumerate([(40, 40, 220), (40, 220, 40)]):
            x = 4 + 48 * j + int(rng.randint(0, 10))
            y = 4 + int(rng.randint(0, 26))
            img[y:y + 30, x:x + 30] = bgr
            annotations.append(dict(id=aid, image_id=i, category_id=j + 1,
                                    bbox=[x, y, 30, 30], area=900, iscrowd=0))
            aid += 1
        imwrite(str(root / "imgs" / f"i{i}.png"), img)
    (root / "ann.json").write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=1, name="person"), dict(id=2, name="car")])))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.slow
def test_port_oadg_beats_standard_on_corruption_robustness(tmp_path):
    eff = _jax_fixture()
    from test_overfit_map import CONFIG_TEMPLATE, H, N_IMGS, W
    eff._sanity_check_templates()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    root = tmp_path / "data"
    root.mkdir()
    _make_dataset(root, N_IMGS, H, W)
    epochs = int(os.environ.get("OADG_EFFICACY_EPOCHS", "12"))
    seed = int(os.environ.get("OADG_EFFICACY_SEED", "0"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    results = {}
    for name, template, num_views in (("standard", eff.STANDARD_TEMPLATE, 1),
                                      ("oadg", CONFIG_TEMPLATE, 2)):
        template = eff._checked_replace(template, "seed = 0", f"seed = {seed}")
        cfg_path = eff._write_cfg(tmp_path, f"{name}_train", template, root,
                                  epochs=epochs, num_views=num_views)
        work = tmp_path / f"work_{name}"
        res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_train.py"),
                              cfg_path, "--work-dir", str(work), "--device", device,
                              "--seed", str(seed), "--no-validate"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=3000)
        assert res.returncode == 0, res.stderr[-4000:]
        ckpt = str(work / f"epoch_{epochs}.pth")
        assert os.path.exists(ckpt), sorted(os.listdir(work))
        out = {}
        for corruption in (None,) + eff.CORRUPTIONS:
            tag = corruption or "clean"
            cfg = eff._write_cfg(tmp_path, f"{name}_{tag}", template, root,
                                 corruption=corruption, epochs=epochs, num_views=num_views)
            metrics = _tool("torch_test").main([cfg, ckpt, "--eval", "bbox", "--device", device])
            out[tag] = metrics["bbox_mAP_50"]
        results[name] = out

    std, oadg = results["standard"], results["oadg"]
    std_mpc = float(np.mean([std[c] for c in eff.CORRUPTIONS]))
    oadg_mpc = float(np.mean([oadg[c] for c in eff.CORRUPTIONS]))
    record = dict(seed=seed, epochs=epochs, device=device, corruptions=list(eff.CORRUPTIONS),
                  severity=eff.SEVERITY, standard=std, oadg=oadg, std_mpc=std_mpc,
                  oadg_mpc=oadg_mpc, margin=oadg_mpc - std_mpc)
    print("EFFICACY_RECORD " + json.dumps(record))
    assert std["clean"] >= 0.8, results
    assert oadg["clean"] >= 0.8, results
    assert oadg_mpc >= std_mpc + eff.MPC_MARGIN, (
        f"OA-DG mPC {oadg_mpc:.3f} < standard {std_mpc:.3f} + margin {eff.MPC_MARGIN}: "
        f"{results}")
    assert oadg["clean"] >= std["clean"] - 0.15, results
