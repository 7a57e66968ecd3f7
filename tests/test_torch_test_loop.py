"""The port's test loop against the JAX package's, end to end, on the CPU.

Over the 4-image COCO-json Cityscapes set of ``torch_data_cases.py`` (the
flagship's test pipeline at the test scale (160, 96)), the tiny flagship
(``__graft_entry__._flagship_model_cfg(tiny=True)``) runs in both packages:
JAX's ``run_test(make_test_step(det), ...)`` over the JAX loader, and the
port's ``single_gpu_test`` over ``build_test_loader``, with the JAX weights
(frozen BN and heads randomized, as ``test_torch_slice.py`` does, so that
scores separate) carried across by ``jax_variables_to_state_dict`` and a
``torch.save``d checkpoint.

Tolerances (those of ``test_torch_slice.py``): per image and class the same
number of detections, boxes within 1e-3 px, scores within 1e-4 relative;
evaluation of the same results exactly equal.
"""
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_data_cases as cases
from __graft_entry__ import _flagship_model_cfg
from test_torch_slice import _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 8
CANVAS = (96, 160)


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_plain(v) for v in o)
    return o


def assert_results_close(got, want):
    assert len(got) == len(want)
    for i, (g_img, w_img) in enumerate(zip(got, want)):
        assert len(g_img) == len(w_img) == NUM_CLASSES
        for c, (g, w) in enumerate(zip(g_img, w_img)):
            assert g.shape == w.shape and g.dtype == np.float32, (i, c, g.shape, w.shape)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=1e-4, atol=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from oadg_tpu.apis.test import run_test as jax_run_test
    from oadg_tpu.config import Config
    from oadg_tpu.data import build_dataloader as jax_build_dataloader
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu.engine.train_step import make_test_step as jax_make_test_step
    from oadg_tpu.models import build_detector as jax_build_detector
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

    root = tmp_path_factory.mktemp("loop")
    ann_file, img_prefix = cases.write_dataset(str(root))
    options = cases.cfg_options(ann_file, img_prefix)
    _, model = _flagship_model_cfg(tiny=True)
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    model = _plain(model)

    cfg = load_config(os.path.join(ROOT, cases.FLAGSHIP))
    cfg.merge_from_dict(options)
    cfg["model"] = model
    jcfg = Config.fromfile(os.path.join(ROOT, cases.FLAGSHIP), import_custom_modules=False)
    jcfg.merge_from_dict({"data.test": _plain(cfg.data.test), "model": model})

    jdet = jax_build_detector(model, num_views=1)
    dummy = {"img": jnp.zeros((1,) + CANVAS + (3,), jnp.float32),
             "img_shape": jnp.asarray([CANVAS], jnp.float32),
             "scale_factor": jnp.ones((1, 4), jnp.float32)}
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, dummy))
    jax_test_fn = jax_make_test_step(jdet)
    jds = jax_build_dataset(dict(jcfg.data.test, test_mode=True))
    jloader = jax_build_dataloader(jds, samples_per_gpu=1, workers_per_gpu=2,
                                   shuffle=False, static_hw=CANVAS, rank=0, world_size=1)
    want = jax_run_test(jax_test_fn, variables["params"], variables["batch_stats"],
                        jloader, NUM_CLASSES)

    checkpoint = str(root / "tiny.pth")
    torch.save(jax_variables_to_state_dict(variables, roi_channels=16), checkpoint)
    dataset, loader = build_test_loader(cfg)
    state = load_model_state(cfg, checkpoint, device="cpu")
    got = single_gpu_test(state, loader)
    return dict(want=want, got=got, cfg=cfg, jcfg=jcfg, jdet=jdet, variables=variables,
                jax_test_fn=jax_test_fn, jds=jds, dataset=dataset, state=state,
                checkpoint=checkpoint, options=options, root=root)


def test_single_gpu_test_matches_jax_run_test(run):
    assert_results_close(run["got"], run["want"])
    counts = [sum(len(r) for r in img) for img in run["got"]]
    assert all(n > 0 for n in counts) and len({c for img in run["got"]
                                                for c, r in enumerate(img) if len(r)}) > 1


def test_evaluation_is_equal_on_both_sides(run):
    for results in (run["got"], run["want"]):
        got = run["dataset"].evaluate(results, metric="bbox")
        assert got == run["jds"].evaluate(results, metric="bbox")
        assert len(got) == 12


def test_test_step_takes_the_loader_batch_and_keeps_the_model_in_eval(run):
    """One batch: NHWC numpy in, the model's eval mode, and the step's
    outputs equal ``DetectorHandle.test`` on the same image as NCHW."""
    handle = run["state"]["handle"]
    batch = next(iter(build_loader(run)))
    handle.model.train()
    dets, labels, valid = run["state"]["test_fn"](batch)
    assert not handle.model.training
    assert dets.shape == (1, 10, 5) and not dets.requires_grad
    img = torch.from_numpy(batch["img"]).permute(0, 3, 1, 2).contiguous()
    want = handle.test({"img": img, "img_shape": torch.from_numpy(batch["img_shape"]),
                        "scale_factor": torch.from_numpy(batch["scale_factor"])})
    for g, w in zip((dets, labels, valid), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


def build_loader(run):
    from oadg_tpu_torch.apis import build_test_loader
    return build_test_loader(run["cfg"])[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_test_tool", os.path.join(ROOT, "tools", "torch_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _write_config(run):
    path = run["root"] / "tiny_cfg.py"
    path.write_text(f"_base_ = [{os.path.join(ROOT, cases.FLAGSHIP)!r}]\n"
                    f"model = {run['cfg']['model']!r}\n")
    return str(path)


def test_torch_test_tool_on_the_cpu(run, capsys):
    """``tools/torch_test.py main()`` with ``--device cpu --eval bbox --out``
    and the dataset given by ``--cfg-options``: the pickle loads back to
    ``single_gpu_test``'s results and the printed metrics are the dataset's."""
    out = str(run["root"] / "results.pkl")
    options = [f"{k}={v}" if not isinstance(v, tuple) else f"{k}=({v[0]},{v[1]})"
               for k, v in run["options"].items()]
    metrics = _tool().main([_write_config(run), run["checkpoint"], "--device", "cpu",
                            "--eval", "bbox", "--out", out, "--cfg-options", *options])
    with open(out, "rb") as f:
        results = pickle.load(f)
    assert_results_close(results, run["got"])
    assert metrics == run["dataset"].evaluate(results, metric="bbox")
    assert "bbox_mAP" in capsys.readouterr().out


def test_torch_test_tool_refuses_show_dir(run):
    with pytest.raises(SystemExit, match="core/visualization"):
        _tool().main([_write_config(run), "none", "--device", "cpu", "--show-dir", "x"])


def test_inference_detector_matches_jax(run):
    """One array (resized by the test pipeline) and one PNG file."""
    from oadg_tpu.apis.inference import DetectorHandle as JaxHandle
    from oadg_tpu.apis.inference import inference_detector as jax_inference
    from oadg_tpu_torch.apis import inference_detector
    jhandle = JaxHandle(run["jdet"], run["variables"], run["jcfg"], NUM_CLASSES)
    jhandle._test_fn = run["jax_test_fn"]          # the loop's compiled step, same shape
    handle = run["state"]["handle"]
    assert handle.CLASSES == cases.CLASSES
    img = cases.textured_image(np.random.RandomState(9), 120, 200)
    path = os.path.join(run["cfg"].data.test.img_prefix, "city_03_leftImg8bit.png")
    for inp in (img, path):
        got, want = inference_detector(handle, inp), jax_inference(jhandle, inp)
        assert_results_close([got], [want])
        assert sum(len(r) for r in got) > 0
    both = inference_detector(handle, [img, path])
    assert_results_close(both, [jax_inference(jhandle, img), jax_inference(jhandle, path)])
