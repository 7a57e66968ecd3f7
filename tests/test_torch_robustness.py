"""The robustness path of the port on the CPU: the ``Corrupt`` op, the
aggregation of ``tools/torch_robustness_eval.py`` against the JAX package's,
``tools/torch_test_robustness.py`` and ``tools/torch_get_corrupted_dataset.py``
on the tiny flagship (``torch_data_cases.tiny_model``, seeded weights) and
the 4 PNGs of ``torch_data_cases``.
"""
import copy
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

import torch_data_cases as cases
from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.data import build_dataset
from oadg_tpu_torch.data.pipelines.image_io import imread
from oadg_tpu_torch.ops.corruptions import BENCHMARK_CORRUPTIONS, corrupt_numpy, sample_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("robust")
    ann_file, img_prefix = cases.write_dataset(str(root / "city"))
    cfg = cases.tiny_model(load_config(os.path.join(ROOT, cases.FLAGSHIP)))
    cfg.merge_from_dict(cases.cfg_options(ann_file, img_prefix))
    path = str(root / "tiny.py")
    cfg.dump(path)
    return dict(root=root, cfg=load_config(path), config=path, ann_file=ann_file,
                img_prefix=img_prefix)


@pytest.mark.parametrize("name", ["glass_blur", "fog", "frost"])
def test_corrupt_op_draws_from_the_image_seed(data, name):
    """The op's image equals ``corrupt_numpy`` with ``RandomState`` of the
    image's seed, which equals the JAX ``corrupt_numpy`` after
    ``np.random.seed`` of it (frost within ``test_torch_corruptions``'s
    tolerance: 1 level on at most 2e-4 of values); the global generator is
    left alone."""
    from oadg_tpu.ops.corruptions import corrupt_numpy as jax_corrupt_numpy
    tc = dict(data["cfg"]["data"]["test"], test_mode=True,
              pipeline=[dict(type="LoadImageFromFile"),
                        dict(type="Corrupt", corruption=name, severity=2)])
    ds = build_dataset(tc)
    state = np.random.get_state()
    for i in range(len(ds)):
        got = ds[i]["img"]
        img = imread(os.path.join(data["img_prefix"], ds.data_infos[i]["filename"]))
        seed = sample_seed(i, name, 2)
        assert np.array_equal(got, corrupt_numpy(img, name, 2, rng=np.random.RandomState(seed)))
        np.random.seed(seed)
        diff = np.abs(got.astype(int) - jax_corrupt_numpy(img, name, 2))
        limit = 2e-4 if name == "frost" else 0.0
        assert diff.max() <= (1 if limit else 0) and (diff > 0).mean() <= limit
        np.random.set_state(state)
    assert sample_seed(3, name, 2) != sample_seed(3, name, 3) != sample_seed(2, name, 3)


def test_corrupt_cells_are_equal_with_one_and_four_loader_threads(data):
    pipeline = list(data["cfg"]["data"]["test"]["pipeline"])
    pipeline.insert(1, dict(type="Corrupt", corruption="glass_blur", severity=3))
    batches = []
    for workers in (1, 4, 4):
        cfg = copy.deepcopy(data["cfg"])
        cfg["data"]["test"]["pipeline"] = pipeline
        cfg["data"]["workers_per_gpu"] = workers
        _, loader = build_test_loader(cfg)
        assert loader.num_workers == workers
        batches.append(list(loader))
    clean = list(build_test_loader(data["cfg"])[1])
    for other in batches[1:]:
        cases.assert_equal_nested(other, batches[0])
    assert not np.array_equal(batches[0][0]["img"], clean[0]["img"])


def _jax_get_results():
    sys.path.insert(0, os.path.join(ROOT, "tools", "analysis_tools"))
    import robustness_eval
    return robustness_eval.get_results


def _agg_full(rng):
    return {c: {s: {"bbox_mAP": 0.4 if s == 0 else float(rng.uniform(0.05, 0.35)),
                    "bbox_mAP_50": float(rng.uniform(0, 1))} for s in range(6)}
            for c in BENCHMARK_CORRUPTIONS}


@pytest.mark.parametrize("case", ["full", "missing_and_zero_clean", "subset", "other_metric"])
def test_get_results_equals_jax(tmp_path, case):
    """The cases of ``tests/test_robustness_eval.py`` and two more: a subset
    of corruptions with holdout ones mixed in, and another metric."""
    rng = np.random.RandomState(0)
    metric = None
    if case == "full":
        agg = _agg_full(rng)
    elif case == "missing_and_zero_clean":
        agg = {BENCHMARK_CORRUPTIONS[0]: {0: {"bbox_mAP": 0.0}, 1: {"bbox_mAP": 0.2}}}
    elif case == "subset":
        full = _agg_full(rng)
        agg = {c: full[c] for c in ("fog", "gaussian_noise", "pixelate")}
        agg["speckle_noise"] = {0: {"bbox_mAP": 0.9}}
        del agg["fog"][3]
    else:
        agg, metric = _agg_full(rng), "bbox_mAP_50"
    path = str(tmp_path / "agg.pkl")
    with open(path, "wb") as f:
        pickle.dump(agg, f)
    got = _tool("torch_robustness_eval").get_results(path, metric=metric, prints=None)
    want = _jax_get_results()(path, metric=metric, prints=None)
    assert got["corruptions"] == want["corruptions"]
    np.testing.assert_array_equal(got["results"], want["results"])
    assert (got["P"], got["mPC"], got["rPC"]) == (want["P"], want["mPC"], want["rPC"])
    if case == "missing_and_zero_clean":
        assert got["P"] == 0.0 and got["rPC"] == 0.0 and got["mPC"] == pytest.approx(0.04)


def test_robustness_tool_on_the_cpu(data, capsys):
    """Two corruptions at severities 0 1 2: the pickle's layout, the clean
    cell evaluated once and reused, the printed P / mPC / rPC those of
    ``get_results`` on the pickle."""
    out = str(data["root"] / "robust.pkl")
    ret = _tool("torch_test_robustness").main(
        [data["config"], "none", "--device", "cpu", "--corruptions", "gaussian_noise", "fog",
         "--severities", "0", "1", "2", "--out", out])
    text = capsys.readouterr().out
    with open(out, "rb") as f:
        agg = pickle.load(f)
    assert sorted(agg) == ["fog", "gaussian_noise"]
    assert all(sorted(agg[c]) == [0, 1, 2] for c in agg)
    assert agg["fog"][0] is not None and agg["fog"][0] == agg["gaussian_noise"][0]
    cell = agg["fog"][2]
    assert "bbox_mAP" in cell and all(isinstance(v, float) for v in cell.values())
    assert text.count(" sev 0]") == 1 and text.count(" sev 1]") == 2
    want = _tool("torch_robustness_eval").get_results(out, prints=None)
    assert (ret["P"], ret["mPC"], ret["rPC"]) == (want["P"], want["mPC"], want["rPC"])
    for line in (f"P (clean bbox_mAP): {want['P']:.4f}", f"rPC: {want['rPC']:.4f}",
                 f"mPC (2 corruptions, sev 1-5): {want['mPC']:.4f}"):
        assert line in text
    assert "images/s" in text


def test_corrupted_copy_reads_back_as_the_on_the_fly_cells(data):
    """``tools/torch_get_corrupted_dataset.py`` writes 2 corruptions at
    severity 1; through ``--load-dataset corrupted`` the cells see the same
    images and give the same detections as the on-the-fly cells."""
    out_root = str(data["root"] / "city-c")
    _tool("torch_get_corrupted_dataset").main(
        [data["config"], "--out", out_root, "--corruptions", "defocus_blur", "shot_noise",
         "--severities", "1"])
    rob = _tool("torch_test_robustness")
    state = load_model_state(data["cfg"], "none", device="cpu")
    for corr in ("defocus_blur", "shot_noise"):
        got = []
        for mode in ("corrupted", None):
            cfg = copy.deepcopy(data["cfg"])
            cfg["data"]["test"] = rob.cell_test_cfg(cfg["data"]["test"], corr, 1, mode, out_root)
            ds, loader = build_test_loader(cfg)
            batches = list(loader)
            got.append((batches, single_gpu_test(state, iter(batches))))
        np.testing.assert_array_equal(np.stack([b["img"] for b in got[0][0]]),
                                      np.stack([b["img"] for b in got[1][0]]))
        cases.assert_equal_nested(got[0][1], got[1][1])


def test_corrupted_dataset_refuses_other_formats(data, tmp_path):
    import json
    with open(data["ann_file"]) as f:
        ann = json.load(f)
    ann["images"][1]["file_name"] = "city_01_leftImg8bit.jpg"
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(ann))
    with pytest.raises(ValueError, match="no JPEG writer"):
        _tool("torch_get_corrupted_dataset").main(
            [data["config"], "--out", str(tmp_path / "out"), "--corruptions", "fog",
             "--cfg-options", f"data.test.ann_file={path}"])
    assert not (tmp_path / "out").exists()
