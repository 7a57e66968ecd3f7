"""The plain Faster R-CNN (the flagship's ``_base_``, the paper's standard
arm) in the port against the JAX package, on the CPU.

``configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py`` made tiny
as ``torch_data_cases.tiny_model`` makes the flagship (R18-FPN at 16
channels, 32 sampled anchors and 16 rois an image): StandardRoIHead,
Shared2FCBBoxHead, the stock CrossEntropyLoss / L1Loss / SmoothL1Loss, one
view. One batch of 2 images of 64x96 (one padded gt). The JAX
``forward_train`` runs with two fixed sampling keys (anchors, rois) and the
port is handed the uniforms JAX draws from them, as in
``test_torch_train_step.py``, whose batch and weight randomization this
reuses. Tolerances as there: each loss rtol=1e-4, every trainable gradient
rtol=1e-3 with an absolute floor of 1e-5 of its largest magnitude, one SGD
update 1e-6.

Then ``tools/torch_train.py --device cpu`` trains the tiny baseline config
for 2 epochs of 2 iterations on the 4 PNGs of ``torch_data_cases``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_data_cases as cases
from oadg_tpu.config import Config
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine import build_lr_schedule, build_optimizer, make_train_step
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from test_torch_train_step import _batch, _randomize

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py"
B, H, W, G = 2, 64, 96, 5
KEYS = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]


def _tiny_baseline(cfg):
    """``tiny_model``'s sizes on the baseline (no contrastive branch)."""
    m = cfg["model"]
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    m["rpn_head"].update(in_channels=16, feat_channels=16)
    m["roi_head"]["bbox_roi_extractor"].update(out_channels=16)
    m["roi_head"]["bbox_head"].update(in_channels=16, fc_out_channels=32)
    m["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                          nms=dict(iou_threshold=0.7), min_bbox_size=0)
    m["train_cfg"]["rpn"]["sampler"]["num"] = 32
    m["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    m["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    m["test_cfg"]["rcnn"].update(max_per_img=10)
    return cfg


def _jax_draws(num_anchors, num_cand):
    def pair(key, size):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (size,)), jax.random.uniform(kn, (size,))

    rpn = [pair(k, num_anchors) for k in jax.random.split(KEYS[0], B)]
    roi = [pair(k, num_cand) for k in jax.random.split(KEYS[1], B)]
    as_t = lambda x: torch.from_numpy(np.asarray(x))          # noqa: E731
    return {"rpn.pos": as_t([p for p, _ in rpn]), "rpn.neg": as_t([n for _, n in rpn]),
            "rcnn.pos": as_t([p for p, _ in roi]), "rcnn.neg": as_t([n for _, n in roi])}


@pytest.fixture(scope="module")
def run():
    model = _tiny_baseline(Config.fromfile(os.path.join(ROOT, BASELINE),
                                           import_custom_modules=False))["model"]
    assert model["roi_head"]["type"] == "StandardRoIHead"
    batch = {k: v[:B] for k, v in _batch().items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=1)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jbatch["img"], "img_shape": jbatch["img_shape"]}))
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

    det = init_detector({"model": model}, device="cpu", num_views=1, seed=3).model
    det.train()
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        feats = det.extract_feat(tbatch["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=_jax_draws(num_anchors, G + rp))
    losses = det.forward_train(tbatch, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16)
    return dict(model=model, variables=variables, jlosses=jlosses, jgrads=jgrads,
                want_grads=want_grads, losses=losses, det=det, batch=tbatch)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc",
                                 "loss_bbox"])
def test_baseline_loss_matches_jax(run, key):
    assert set(run["losses"]) == set(run["jlosses"])
    want = float(run["jlosses"][key])
    got = float(run["losses"][key].detach())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0 or key == "acc"


def test_baseline_every_trainable_gradient_matches_jax(run):
    det, want = run["det"], run["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=name)
    # No sampled anchor reads the top FPN output at 64x96, on either side.
    zero = [k for k, _ in trainable if not np.abs(want[k].numpy()).any()]
    assert zero == ["neck.fpn_convs.3.conv.weight", "neck.fpn_convs.3.conv.bias"], zero
    frozen = [k for k, p in det.named_parameters() if not p.requires_grad]
    assert frozen and all(dict(det.named_parameters())[k].grad is None for k in frozen)


def test_baseline_sgd_update_matches_jax(run):
    cfg = load_config(os.path.join(ROOT, BASELINE))
    det = run["det"]
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    opt = build_optimizer(det, cfg.optimizer)
    for name, p in det.named_parameters():
        p.grad = run["want_grads"][name].clone() if p.requires_grad else None
    opt.step()
    jparams = run["variables"]["params"]
    tx = jax_build_optimizer(jparams, cfg.optimizer, lambda t: cfg.optimizer["lr"],
                             model_cfg=run["model"])
    updates, _ = tx.update(run["jgrads"], tx.init(jparams), jparams)
    jafter = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates))},
        roi_channels=16)
    for name, p in det.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.detach().numpy(), jafter[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
            if run["want_grads"][name].abs().max() > 0:
                assert not torch.equal(p.detach(), before[name]), name
        else:
            assert torch.equal(p.detach(), before[name]), name


def test_baseline_train_step_runs_on_the_cpu(run):
    """``make_train_step`` without a preprocess (one view, no OA-Mix):
    finite float32 losses, trainable parameters move, frozen ones stay."""
    cfg = load_config(os.path.join(ROOT, BASELINE))
    det = init_detector({"model": run["model"]}, device="cpu", num_views=1, seed=3).model
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    step = make_train_step(det, build_optimizer(det, cfg.optimizer),
                           build_lr_schedule(dict(cfg.lr_config, warmup=None),
                                             cfg.optimizer["lr"], 100))
    log = step(run["batch"], torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in log.values())
    frozen = {k for k, p in det.named_parameters() if not p.requires_grad}
    still = {k for k, p in det.named_parameters() if torch.equal(p.detach(), before[k])}
    # the top FPN output's bias starts at 0 and gets no gradient (see above)
    assert still - frozen == {"neck.fpn_convs.3.conv.bias"} and frozen <= still


def test_torch_train_tool_trains_the_baseline_config(tmp_path):
    """``tools/torch_train.py --device cpu`` on the tiny baseline: 2 epochs
    of 2 iterations with an evaluation after each, checkpoints and logs."""
    ann_file, img_prefix = cases.write_dataset(str(tmp_path / "data"), sizes=cases.TRAIN_SIZES)
    cfg = _tiny_baseline(load_config(os.path.join(ROOT, BASELINE)))
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1, "data.train.times": 1,
            "data.train.dataset.ann_file": ann_file,
            "data.train.dataset.img_prefix": img_prefix,
            "data.train.dataset.pipeline.2.img_scale": list(cases.TRAIN_SCALES),
            "max_gt": 16, "runner.max_epochs": 2, "log_config.interval": 1,
            "lr_config.warmup_iters": 3}
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann_file, f"data.{split}.img_prefix": img_prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 64)})
    cfg.merge_from_dict(opts)
    assert not any(p.get("type") == "OAMix" for p in cfg.data.train.dataset.pipeline)
    cfg.dump(str(tmp_path / "tiny_baseline.py"))
    work = tmp_path / "work"
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_train.py"),
         str(tmp_path / "tiny_baseline.py"), "--device", "cpu", "--work-dir", str(work),
         "--seed", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (work / "epoch_2.pth").exists() and (work / "latest.pth").exists()
    lines = [json.loads(line) for line in open(work / "log.json") if line.strip()]
    train = [ln for ln in lines if ln.get("mode") == "train"]
    assert len(train) == 4 and all(np.isfinite(ln["loss"]) for ln in train)
    assert {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"} <= set(train[0])
    assert sum(ln.get("mode") == "val" for ln in lines) == 2
