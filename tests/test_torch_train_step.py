"""The port's OA-DG training step against the JAX package, on the CPU.

The tiny flagship config (``__graft_entry__._flagship_model_cfg(tiny=True)``:
R18-FPN at 16 channels, ContrastiveRoIHead, ``num_views=2``) takes one
views-major batch of 2 images x 2 views of 64x96 (view 2 is view 1 with
noise; one padded gt). The JAX detector's variables (frozen-BN statistics
and the RPN / box-head weights randomized so that scores are well apart)
go to the port through ``jax_variables_to_state_dict``. The JAX
``forward_train`` runs with three fixed sampling keys; the port is handed
the uniform draws ``jax.random.uniform`` makes from those keys' splits, so
both sample the same anchors, rois and random proposals.

Tolerances: each loss rtol=1e-4 (convolution and FC sums reassociate);
every trainable gradient rtol=1e-3 with an absolute floor of 1e-5 times its
largest magnitude (gradients sum over many more terms); one SGD update on
identical gradients 1e-6; frozen parameters bit-identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.engine.optim import build_lr_schedule as jax_build_lr_schedule
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.models.detectors.two_stage import random_boxes_uniform as jax_random_boxes
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine import build_lr_schedule, build_optimizer, make_train_step
from oadg_tpu_torch.models.detectors.two_stage import random_boxes_uniform
from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
B, V, H, W, G = 2, 2, 64, 96, 5
KEYS = [jax.random.PRNGKey(11), jax.random.PRNGKey(12), jax.random.PRNGKey(13)]
FLAGSHIP = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"


def _batch():
    rng = np.random.RandomState(0)
    img = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    img = np.concatenate([img, img + rng.normal(0, 0.2, img.shape).astype(np.float32)])
    x1 = rng.uniform(0, 50, (B, G))
    y1 = rng.uniform(0, 30, (B, G))
    gt = np.stack([x1, y1, np.minimum(x1 + rng.uniform(10, 50, (B, G)), W),
                   np.minimum(y1 + rng.uniform(10, 34, (B, G)), H)], -1)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    gt[1, -1] = 0
    return {"img": img,
            "gt_bboxes": np.tile(gt.astype(np.float32), (V, 1, 1)),
            "gt_labels": np.tile(rng.randint(0, 8, (B, G)).astype(np.int32), (V, 1)),
            "gt_valid": np.tile(valid, (V, 1)),
            "img_shape": np.array([[H, W]] * (B * V), np.float32)}


def _randomize(variables, seed=1):
    """Random frozen-BN statistics and affines; larger RPN and box-head
    weights, so that objectness and class scores are far apart relative to
    float32 noise and the proposals' order is the same on both sides."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, sub in params.items():
            if k.startswith("FrozenBN") or k == "downsample_bn":
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(k, {}))

    walk(v["params"], v["batch_stats"])
    for scope, std in ((("rpn", "rpn_cls", "Conv_0"), 1.0),
                       (("rpn", "rpn_reg", "Conv_0"), 0.1),
                       (("roi", "head", "fc_cls"), 0.3),
                       (("roi", "head", "fc_reg"), 0.1)):
        node = v["params"]
        for k in scope:
            node = node[k]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    return v


def _jax_draws(num_anchors, num_cand, num_boxes):
    """The uniforms the JAX package draws from ``KEYS`` (rpn, roi, random
    proposals): ``sample_masks`` / ``sample`` split each image's key into
    (positive, negative), ``random_boxes_uniform`` into four."""
    def pair(key, size):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (size,)), jax.random.uniform(kn, (size,))

    rpn = [pair(k, num_anchors) for k in jax.random.split(KEYS[0], B * V)]
    roi = [pair(k, num_cand) for k in jax.random.split(KEYS[1], B)]
    boxes = [[jax.random.uniform(s, (num_boxes,)) for s in jax.random.split(k, 4)]
             for k in jax.random.split(KEYS[2], B * V)]
    as_t = lambda x: torch.from_numpy(np.asarray(x))
    return {"rpn.pos": as_t([p for p, _ in rpn]), "rpn.neg": as_t([n for _, n in rpn]),
            "rcnn.pos": as_t([p for p, _ in roi]), "rcnn.neg": as_t([n for _, n in roi]),
            "random_boxes": as_t(boxes)}


def _torch_batch(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["img"] = t["img"].permute(0, 3, 1, 2).contiguous()
    return t


@pytest.fixture(scope="module")
def run():
    _, model = _flagship_model_cfg(tiny=True)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=V)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jbatch["img"], "img_shape": jbatch["img_shape"]}))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 3]

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
    assert calls == ["sampling"] * 3

    handle = init_detector({"model": model}, device="cpu", num_views=V)
    det = handle.model
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16),
                        strict=True)
    tbatch = _torch_batch(batch)
    with torch.no_grad():
        feats = det.extract_feat(tbatch["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=_jax_draws(num_anchors, G + rp, 10))
    losses = det.forward_train(tbatch, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16)
    return dict(model=model, variables=variables, jlosses=jlosses, jgrads=jgrads,
                want_grads=want_grads, losses=losses, det=det, batch=tbatch,
                given=draws.given)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                 "acc", "loss_bbox", "loss_cont"])
def test_loss_matches_jax(run, key):
    want = float(run["jlosses"][key])
    got = float(run["losses"][key].detach())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if key == "loss_cont":
        assert got > 0


def test_every_trainable_gradient_matches_jax(run):
    det, want = run["det"], run["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    assert len(trainable) == 79
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    moved = [k for k, _ in trainable if np.abs(want[k].numpy()).max() > 0]
    assert len(moved) == len(trainable)


def test_frozen_stages_get_no_gradient(run):
    det, want = run["det"], run["want_grads"]
    frozen = [k for k, p in det.named_parameters() if not p.requires_grad]
    assert frozen and all(k.startswith(("backbone.conv1", "backbone.bn1",
                                        "backbone.layer1.")) for k in frozen)
    assert len(frozen) == 15
    for name in frozen:
        assert dict(det.named_parameters())[name].grad is None
        assert not np.any(want[name].numpy()), name       # JAX stop_gradient


def _sgd_on_jax_grads(run, grad_clip=None):
    """One SGD step of the port on the JAX gradients, and the JAX
    optimizer's step on the same, both at lr 0.01, with ``grad_clip``."""
    cfg = load_config(FLAGSHIP)
    det = run["det"]
    params = {k: p.detach().clone() for k, p in det.named_parameters()}
    opt = build_optimizer(det, cfg.optimizer, grad_clip=grad_clip)
    for name, p in det.named_parameters():
        p.grad = run["want_grads"][name].clone() if p.requires_grad else None
    opt.step()
    after = {k: p.detach().clone() for k, p in det.named_parameters()}
    with torch.no_grad():
        for name, p in det.named_parameters():
            p.copy_(params[name])
    jparams = run["variables"]["params"]
    tx = jax_build_optimizer(jparams, cfg.optimizer, lambda t: cfg.optimizer["lr"],
                             model_cfg=run["model"], grad_clip=grad_clip)
    updates, _ = tx.update(run["jgrads"], tx.init(jparams), jparams)
    jafter = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          optax.apply_updates(jparams, updates))},
        roi_channels=16)
    return det, params, after, jafter


def test_sgd_update_matches_jax_optimizer(run):
    det, before, after, jafter = _sgd_on_jax_grads(run)
    n = 0
    for name, p in det.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(after[name].numpy(), jafter[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
            n += not torch.equal(after[name], before[name])
    assert n == 79


def _trainable_grad_norm(run):
    return float(np.sqrt(sum(np.sum(run["want_grads"][k].numpy().astype(np.float64) ** 2)
                             for k, p in run["det"].named_parameters() if p.requires_grad)))


@pytest.mark.parametrize("ratio", [0.5, 2.0])
def test_clipped_sgd_update_matches_jax_optimizer(run, ratio):
    """``grad_clip=dict(max_norm=...)`` with the gradients' global norm
    above (ratio 0.5: clipped) and below it (ratio 2: left as they are),
    against the JAX chain with ``optax.clip_by_global_norm``, on the
    trainable parameters (the JAX side decays the frozen ones)."""
    norm = _trainable_grad_norm(run)
    det, before, after, jafter = _sgd_on_jax_grads(run, dict(max_norm=ratio * norm))
    _, _, plain, _ = _sgd_on_jax_grads(run)
    moved = {True: 0, False: 0}
    for name, p in det.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(after[name].numpy(), jafter[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
            moved[torch.equal(after[name], plain[name])] += 1
    # clipped: every parameter with a gradient moves less than unclipped
    assert moved[True] + moved[False] == 79
    if ratio > 1:
        assert moved[False] == 0
    else:
        assert moved[False] > 70


def test_grad_clip_none_is_plain_sgd(run):
    det = run["det"]
    cfg = load_config(FLAGSHIP)
    assert type(build_optimizer(det, cfg.optimizer)) is torch.optim.SGD
    assert type(build_optimizer(det, cfg.optimizer, grad_clip=None)) is torch.optim.SGD
    empty = build_optimizer(det, cfg.optimizer, grad_clip=dict())
    assert type(empty) is torch.optim.SGD        # as the reference: {} clips nothing
    assert build_optimizer(det, cfg.optimizer, grad_clip=dict(norm_type=2)).max_norm == 35


def test_frozen_params_do_not_move_and_jax_decays_them(run):
    """The port follows mmdet: frozen parameters get no update and no
    weight decay. The JAX optimizer masks their gradient to zero before
    ``add_decayed_weights`` (oadg_tpu/engine/optim.py:145-158), so it moves
    them by -lr * wd * p; this pins that difference."""
    cfg = load_config(FLAGSHIP)
    lr, wd = cfg.optimizer["lr"], cfg.optimizer["weight_decay"]
    det, before, after, jafter = _sgd_on_jax_grads(run)
    for name, p in det.named_parameters():
        if not p.requires_grad:
            assert torch.equal(after[name], before[name]), name
            b = before[name].numpy()
            # the difference of two float32 parameters is exact to one ulp
            np.testing.assert_allclose(jafter[name].numpy() - b, -lr * wd * b,
                                       rtol=0, atol=1.2e-7 * np.abs(b).max(),
                                       err_msg=name)
    stem = before["backbone.conv1.weight"].numpy()
    assert np.abs(jafter["backbone.conv1.weight"].numpy() - stem).max() > 0


def test_lr_schedule_matches_jax():
    cfg = load_config(FLAGSHIP)
    base = cfg.optimizer["lr"]
    lr_config = dict(cfg.lr_config, step=[1])
    got = build_lr_schedule(lr_config, base, steps_per_epoch=400)
    want = jax_build_lr_schedule(lr_config, base, steps_per_epoch=400)
    for t in (0, 1, 250, 399, 400, 499, 500):
        np.testing.assert_allclose(got(t), float(want(jnp.asarray(t))), rtol=1e-6)
    assert got(0) == pytest.approx(base * 0.001) and got(600) == pytest.approx(base * 0.1)


def test_train_step_runs_the_plain_versions_on_the_cpu(run):
    """``make_train_step`` on CPU tensors: losses finite, every trainable
    parameter moves, frozen ones stay, and no kernel is launched."""
    cfg = load_config(FLAGSHIP)
    handle = init_detector({"model": run["model"]}, device="cpu", num_views=V, seed=3)
    det = handle.model
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    step = make_train_step(det, build_optimizer(det, cfg.optimizer),
                           build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100))
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    for i in range(2):
        log = step(run["batch"], torch.Generator().manual_seed(i))
        assert all(torch.isfinite(v) for v in log.values())
    assert step.t == 2
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd, bwd)
    for name, p in det.named_parameters():
        assert torch.equal(p.detach(), before[name]) != p.requires_grad, name


def test_train_mode_in_the_step_and_eval_for_serving(run):
    """``init_detector`` leaves a serving model (one view) in eval mode and
    a training one in train mode; the step sets train mode. The flagship's
    losses do not depend on the mode (frozen BN, no dropout)."""
    cfg = load_config(FLAGSHIP)
    assert not init_detector({"model": run["model"]}, device="cpu").model.training
    det = init_detector({"model": run["model"]}, device="cpu", num_views=V, seed=3).model
    assert det.training
    det.eval()
    modes = []
    forward_train = det.forward_train
    det.forward_train = lambda *a: (modes.append(det.training), forward_train(*a))[1]
    step = make_train_step(det, build_optimizer(det, cfg.optimizer),
                           build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100))
    step(run["batch"], torch.Generator().manual_seed(0))
    assert modes == [True] and det.training
    trained = run["det"]
    trained.eval()
    try:
        with torch.no_grad():
            losses = trained.forward_train(run["batch"], UniformDraws(given=run["given"]))
    finally:
        trained.train()
    for k, v in run["losses"].items():
        torch.testing.assert_close(losses[k], v.detach(), rtol=0, atol=0, msg=k)


def test_random_boxes_match_jax():
    """``random_boxes_uniform`` on the four uniforms of each image's key
    split, against the JAX function on the keys (jitted, as in the step)."""
    shapes = np.array([[64, 96], [1024, 2048], [800, 1600]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    scales, ratios = (0.01, 0.3), (0.3, 1 / 0.3)
    want_b, want_v = jax.jit(jax.vmap(lambda k, s: jax_random_boxes(
        k, s, 200, scales, ratios)))(keys, jnp.asarray(shapes))
    u = torch.from_numpy(np.asarray(
        [[jax.random.uniform(s, (200,)) for s in jax.random.split(k, 4)] for k in keys]))
    got_b, got_v = random_boxes_uniform(torch.from_numpy(shapes), 200, scales, ratios, u)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert 0 < int(got_v.sum()) < got_v.numel()
