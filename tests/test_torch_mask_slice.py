"""The tiny Cityscapes Mask R-CNN in the port against the JAX package, on the CPU.

``configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py`` made tiny
(``torch_mask_cases.tiny_mask_model``: R18-FPN at 16 channels, the mask
head's 2 convs of 16 channels, 16 rois an image of which 4 mask slots) on
the batch of ``test_torch_train_step.py`` (2 images of 64x96, 5 gts, one
padded) with seeded elliptical box-cropped gt masks. The JAX detector's
variables go to the port through ``jax_variables_to_state_dict``; the JAX
``forward_train`` runs with two fixed sampling keys and the port is handed
the uniforms drawn from them, so both sample the same anchors and rois.

Tolerances: each loss (``loss_mask`` included) rtol=1e-4; every trainable
gradient rtol=1e-3 with an absolute floor of 1e-5 of its largest magnitude
(as ``test_torch_train_step.py``); the mask head's gradients also rtol=1e-4
with a floor of 1e-5. ``simple_test``'s four outputs: the same labels and
valid detections, boxes and scores within 1e-4 of the largest, mask
probabilities within 1e-5 (the convolutions sum in another order).
Then the JAX ``run_test``'s three-way unpack against the port's test loop,
and ``tools/torch_train.py`` on the tiny config with masks.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_mask_cases as cases
from oadg_tpu.config import Config
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from test_torch_train_step import _batch, _randomize

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, G = 2, 64, 96, 5
KEYS = [jax.random.PRNGKey(31), jax.random.PRNGKey(32)]


def _gt_masks(rng, m0=56):
    """(B, G, m0, m0) box-cropped masks: an ellipse of random centre and
    radii in each crop."""
    yy, xx = (np.mgrid[0:m0, 0:m0] + 0.5) / m0
    c = rng.uniform(0.35, 0.65, (B, G, 2, 1, 1))
    r = rng.uniform(0.25, 0.5, (B, G, 2, 1, 1))
    return ((((xx - c[:, :, 0]) / r[:, :, 0]) ** 2 + ((yy - c[:, :, 1]) / r[:, :, 1]) ** 2)
            <= 1).astype(np.float32)


def _jax_draws(num_anchors, num_cand):
    def pair(key, size):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (size,)), jax.random.uniform(kn, (size,))

    rpn = [pair(k, num_anchors) for k in jax.random.split(KEYS[0], B)]
    roi = [pair(k, num_cand) for k in jax.random.split(KEYS[1], B)]
    as_t = lambda x: torch.from_numpy(np.asarray(x))          # noqa: E731
    return {"rpn.pos": as_t([p for p, _ in rpn]), "rpn.neg": as_t([n for _, n in rpn]),
            "rcnn.pos": as_t([p for p, _ in roi]), "rcnn.neg": as_t([n for _, n in roi])}


def _models():
    jmodel = cases.tiny_mask_model(Config.fromfile(os.path.join(ROOT, cases.MASK_CONFIG),
                                                   import_custom_modules=False)["model"])
    tmodel = cases.tiny_mask_model(load_config(os.path.join(ROOT, cases.MASK_CONFIG))["model"])
    return jmodel, tmodel


@pytest.fixture(scope="module")
def run():
    jmodel, tmodel = _models()
    batch = {k: v[:B] for k, v in _batch().items()}
    batch["gt_masks"] = _gt_masks(np.random.RandomState(8))
    batch["scale_factor"] = np.ones((B, 4), np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(jmodel, num_views=1)
    test_batch = {k: jbatch[k] for k in ("img", "img_shape", "scale_factor")}
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, test_batch))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 2]

    def loss_fn(params, batch_stats, b):
        losses = jdet.apply({"params": params, "batch_stats": batch_stats}, b, "train")
        return sum(v for k, v in losses.items() if "loss" in k), losses

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 2
    test_fn = jax.jit(lambda v, b: jdet.apply(v, b, "test"))
    jtest = test_fn(variables, test_batch)

    det = init_detector({"model": tmodel}, device="cpu", num_views=1, seed=3).model
    det.train()
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = det.extract_feat(tbatch["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = tmodel["train_cfg"]["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=_jax_draws(num_anchors, G + rp))
    losses = det.forward_train(tbatch, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16)
    det.eval()
    with torch.no_grad():
        ttest = det.simple_test({k: tbatch[k] for k in ("img", "img_shape", "scale_factor")})
    return dict(jlosses=jlosses, losses=losses, det=det, want_grads=want_grads,
                jtest=jtest, ttest=ttest, variables=variables, test_fn=test_fn,
                test_batch=batch)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc",
                                 "loss_bbox", "loss_mask"])
def test_mask_rcnn_loss_matches_jax(run, key):
    assert set(run["losses"]) == set(run["jlosses"])
    want = float(run["jlosses"][key])
    got = run["losses"][key].item()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0 or key == "acc"


def test_mask_rcnn_every_trainable_gradient_matches_jax(run):
    det, want = run["det"], run["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    assert sum(k.startswith("roi_head.mask_head.") for k, _ in trainable) == 8
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=name)
        if name.startswith("roi_head.mask_head."):
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_mask_rcnn_simple_test_matches_jax(run):
    """dets, labels, valid and the (N, D, 28, 28) mask probabilities."""
    jd, jl, jv, jm = (np.asarray(x) for x in run["jtest"])
    td, tl, tv, tm = (x.numpy() for x in run["ttest"])
    assert tm.shape == jm.shape == (B, 10, 28, 28) and tm.dtype == np.float32
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl[tv], jl[jv])
    np.testing.assert_allclose(td[tv], jd[jv], rtol=0, atol=1e-4 * np.abs(jd[jv]).max())
    np.testing.assert_allclose(tm[tv], jm[jv], rtol=0, atol=1e-5)
    assert ((tm >= 0) & (tm <= 1)).all()


def test_jax_run_test_cannot_unpack_a_mask_rcnn_the_port_scores_its_boxes(run):
    """The JAX ``run_test`` unpacks three outputs of the test step
    (``oadg_tpu/apis/test.py:53,57``), so it raises on a Mask R-CNN, whose
    test step returns four (ROADMAP C). The port's ``run_test`` scores the
    boxes and leaves the masks on the device."""
    from oadg_tpu.apis.test import run_test as jax_run_test
    from oadg_tpu_torch.apis.test import dets_to_results, fetch_dets, run_test
    from oadg_tpu_torch.engine.train_step import make_test_step
    batch = dict(run["test_batch"])
    loader = [{k: batch[k] for k in ("img", "img_shape", "scale_factor")}]
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_run_test(lambda p, s, b: run["test_fn"]({"params": p, "batch_stats": s}, b),
                     run["variables"]["params"], run["variables"]["batch_stats"], loader, 8)
    results = run_test(make_test_step(run["det"]), loader, 8)
    assert len(results) == B and all(len(r) == 8 for r in results)
    want = dets_to_results(*fetch_dets(*run["ttest"][:3]), 8)
    for r, w in zip(results, want):         # the NHWC batch: convolutions sum apart
        for a, b in zip(r, w):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(initial=0), 1))


def test_torch_train_tool_trains_the_mask_config(tmp_path):
    """``tools/torch_train.py --device cpu`` on the tiny Cityscapes Mask R-CNN
    whose train pipeline loads masks (``LoadAnnotations(with_mask=True)``,
    ``Collect`` with ``gt_masks``): one epoch of 2 iterations over 4 PNGs
    with polygon and RLE instances, ``loss_mask`` logged and finite, a
    checkpoint with the mask head, then the test loop's ``bbox`` score."""
    ann_file, prefix = cases.write_mask_dataset(str(tmp_path / "data"))
    cfg = load_config(os.path.join(ROOT, cases.MASK_CONFIG))
    cases.tiny_mask_model(cfg["model"])
    train = cfg.data.train.dataset
    train.pipeline = cases.with_mask_pipeline(train.pipeline)
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1, "data.train.times": 1,
            "data.train.dataset.ann_file": ann_file, "data.train.dataset.img_prefix": prefix,
            "data.train.dataset.pipeline.2.img_scale": [(96, 64), (80, 56)],
            "max_gt": 16, "runner.max_epochs": 1, "log_config.interval": 1,
            "lr_config.warmup_iters": 2}
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann_file, f"data.{split}.img_prefix": prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 64)})
    cfg.merge_from_dict(opts)
    assert cfg.data.train.dataset.pipeline[1] == dict(type="LoadAnnotations", with_bbox=True,
                                                      with_mask=True)
    cfg.dump(str(tmp_path / "tiny_mask_rcnn.py"))
    work = tmp_path / "work"
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_train.py"),
         str(tmp_path / "tiny_mask_rcnn.py"), "--device", "cpu", "--work-dir", str(work),
         "--seed", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in open(work / "log.json") if line.strip()]
    train_lines = [ln for ln in lines if ln.get("mode") == "train"]
    assert len(train_lines) == 2
    assert all(np.isfinite(ln["loss_mask"]) and ln["loss_mask"] > 0 for ln in train_lines)
    val = [ln for ln in lines if ln.get("mode") == "val"]
    assert len(val) == 1 and "bbox_mAP" in val[0]
    sd = torch.load(work / "epoch_1.pth", weights_only=True)["state_dict"]
    assert "roi_head.mask_head.upsample.weight" in sd
