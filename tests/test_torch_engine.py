"""The port's engine leftovers against the JAX package's, on the CPU:
LR schedules, Adam and AdamW, the hooks' runner-side parts (the head's L1
switch, the feature capture, the random input size with the prefetching
loader) and mmdet-layout ``.pth`` checkpoints.

Tolerances: schedules equal JAX's float32 values at every iteration within
rtol 1e-6; after 5 Adam / AdamW steps every trainable parameter within
rtol 1e-6 (atol 1e-6 of the largest magnitude of its tensor) of the optax
chain's; a checkpoint takes the same tensors as JAX's graft and serves
JAX's detections (boxes within 1e-3 px, scores within 1e-4 relative, as in
``test_torch_test_loop.py``). Where the JAX package is at fault (ROADMAP C)
the test shows the fault and holds the port to mmcv / mmdet.
"""
import copy
import math
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_data_cases as dcases
import torch_dwd_cases as wcases
import torch_yolo_cases as ycases
from oadg_tpu.engine.optim import build_lr_schedule as jax_build_lr_schedule
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine.optim import build_lr_schedule, build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------- schedules ----

SCHEDULES = {
    # tests/test_optim_schedules.py's three and tests/test_hooks.py's YOLOX
    "step_linear": (dict(policy="step", warmup="linear", warmup_iters=500,
                         warmup_ratio=0.001, step=[1]), 0.01, 1000, 2100),
    "cosine": (dict(policy="cosineannealing", min_lr_ratio=0.1, max_iters=100), 1.0, 10, 130),
    "step_constant": (dict(policy="step", step=[], warmup="constant", warmup_iters=10,
                           warmup_ratio=0.5), 1.0, 10, 30),
    "yolox": (dict(policy="YOLOX", warmup="exp", by_epoch=False, warmup_by_epoch=True,
                   warmup_ratio=1, warmup_iters=5, num_last_epochs=2, min_lr_ratio=0.05,
                   total_epochs=10), 0.01, 10, 110),
    # exp warmup on both policies it applies to
    "step_exp": (dict(policy="step", step=[2, 3], gamma=0.5, warmup="exp", warmup_iters=20,
                      warmup_ratio=0.1), 0.02, 10, 45),
    "cosine_exp": (dict(policy="CosineAnnealing", min_lr_ratio=0.01, warmup="exp",
                        warmup_iters=2, warmup_ratio=0.1, max_iters=30), 1e-4, 10, 40),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_at_every_iteration(name):
    """The port evaluates in float64, JAX in float32: rtol 1e-6, and 5e-6
    under ``exp`` warmup, whose float32 ``ratio ** (1 - k)`` XLA computes
    within ~2e-6 relative."""
    lr_config, base, steps, n = SCHEDULES[name]
    got = build_lr_schedule(lr_config, base, steps)
    want = jax.jit(jax_build_lr_schedule(lr_config, base, steps))
    ts = np.arange(n)
    rtol = 5e-6 if lr_config.get("warmup") == "exp" and name != "yolox" else 1e-6
    np.testing.assert_allclose([got(int(t)) for t in ts], np.asarray(jax.vmap(want)(ts)),
                               rtol=rtol, atol=1e-12 * base)


def test_cosine_without_max_iters_anneals_over_the_run():
    """ROADMAP C: the JAX runner builds the schedule without ``max_iters``,
    so JAX's cosine divides by 1 and reaches ``min_lr`` at iteration 1. The
    port anneals as mmcv's ``CosineAnnealingLrUpdaterHook``: by epoch over
    the runner's ``max_epochs`` (``by_epoch=False``: by iteration), the
    warmup on top."""
    cfg = dict(policy="CosineAnnealing", min_lr_ratio=0.01, warmup="exp", warmup_iters=2,
               warmup_ratio=0.1)
    base, steps, epochs = 1e-4, 5, 12
    jax_sched = jax_build_lr_schedule(cfg, base, steps)
    assert float(jax_sched(1)) == pytest.approx(base * 0.01 * 0.1 ** 0.5)
    assert float(jax_sched(2)) == pytest.approx(base * 0.01)
    with pytest.raises(ValueError, match="max_epochs"):
        build_lr_schedule(cfg, base, steps)

    def mmcv(progress, t):
        lr = base * 0.01 + 0.5 * (base - base * 0.01) * (math.cos(math.pi * progress) + 1)
        return lr * (0.1 ** (1 - t / 2) if t < 2 else 1.0)

    by_epoch = build_lr_schedule(cfg, base, steps, max_epochs=epochs)
    by_iter = build_lr_schedule(dict(cfg, by_epoch=False), base, steps, max_epochs=epochs)
    for t in range(steps * epochs):
        assert by_epoch(t) == pytest.approx(mmcv((t // steps) / epochs, t), rel=1e-12)
        assert by_iter(t) == pytest.approx(mmcv(t / (steps * epochs), t), rel=1e-12)
    assert by_epoch(steps) == pytest.approx(mmcv(1 / epochs, steps))
    assert by_epoch(steps) > base * 0.98 > 50 * float(jax_sched(steps))
    absolute = build_lr_schedule(dict(policy="CosineAnnealing", min_lr=1e-6), base, steps,
                                 max_epochs=epochs)
    assert absolute(steps * epochs - 1) == pytest.approx(
        1e-6 + 0.5 * (base - 1e-6) * (math.cos(math.pi * 11 / 12) + 1))


def test_yolox_takes_the_runners_max_epochs():
    """ROADMAP C: the JAX ``yolox`` policy reads ``total_epochs`` from
    ``lr_config`` (300 without it); mmdet reads the runner's
    ``max_epochs``, and so does the port."""
    cfg = dict(policy="YOLOX", warmup_iters=5, num_last_epochs=2, min_lr_ratio=0.05)
    base, steps = 0.01, 10
    got = build_lr_schedule(cfg, base, steps, max_epochs=10)
    want = jax_build_lr_schedule(dict(cfg, total_epochs=10), base, steps)
    wrong = jax_build_lr_schedule(cfg, base, steps)
    ts = range(110)
    np.testing.assert_allclose([got(t) for t in ts], [float(want(t)) for t in ts], rtol=1e-6)
    assert got(95) == pytest.approx(base * 0.05)
    assert float(wrong(95)) > 0.9 * base


def test_unknown_policy_and_warmup_raise():
    with pytest.raises(NotImplementedError, match="poly"):
        build_lr_schedule(dict(policy="poly"), 0.1, 10)
    with pytest.raises(NotImplementedError, match="quadratic"):
        build_lr_schedule(dict(policy="step", warmup="quadratic"), 0.1, 10)


# ------------------------------------------------------------ optimizers ----

LR_CONFIG = dict(policy="CosineAnnealing", min_lr_ratio=0.1, max_iters=10)


@pytest.fixture(scope="module")
def tiny_flagship():
    """The tiny flagship built for training, its parameters as the JAX
    package's tree (the JAX converter of the port's state dict)."""
    from oadg_tpu.utils.checkpoint import convert_torch_state_dict
    from oadg_tpu_torch.apis import init_detector
    cfg = dcases.tiny_model(load_config(os.path.join(ROOT, dcases.FLAGSHIP)))
    det = init_detector({"model": cfg["model"]}, device="cpu", num_views=2, seed=1).model
    params = convert_torch_state_dict(det.state_dict(), roi_channels=16)["params"]
    return cfg, det, jax.tree_util.tree_map(jnp.asarray, params)


def _steps(tiny_flagship, optimizer_cfg, grad_clip=None, steps=5):
    """``steps`` updates of the port's optimizer and of the JAX chain with
    the same seeded gradients (zero for the port's frozen parameters) and a
    cosine LR -> (port parameters before and after, JAX's after, as port
    state dicts)."""
    from oadg_tpu.utils.checkpoint import convert_torch_state_dict
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    cfg, det0, jparams = tiny_flagship
    det = copy.deepcopy(det0)
    lr_config = LR_CONFIG
    sched = build_lr_schedule(lr_config, optimizer_cfg["lr"], 5)
    opt = build_optimizer(det, optimizer_cfg, grad_clip=grad_clip)
    tx = jax_build_optimizer(jparams, optimizer_cfg,
                             jax_build_lr_schedule(lr_config, optimizer_cfg["lr"], 5),
                             model_cfg=dict(cfg["model"]), grad_clip=grad_clip)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    rng = np.random.RandomState(7)
    trainable = {k for k, p in det.named_parameters() if p.requires_grad}
    for t in range(steps):
        grads = {k: (torch.from_numpy(rng.normal(0, 1, v.shape).astype(np.float32))
                     if k in trainable else torch.zeros_like(v))
                 for k, v in det.state_dict().items()}
        for k, p in det.named_parameters():
            p.grad = grads[k].clone() if p.requires_grad else None
        for group in opt.param_groups:
            group["lr"] = sched(t)
        opt.step()
        jgrads = convert_torch_state_dict(grads, roi_channels=16)["params"]
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, jgrads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    after = {k: p.detach().clone() for k, p in det.named_parameters()}
    return det, before, after, jax_variables_to_state_dict({"params": jparams},
                                                           roi_channels=16)


@pytest.mark.parametrize("kind,wd,clip", [("AdamW", 0.05, dict(max_norm=35)),
                                          ("AdamW", 0.05, None), ("Adam", 0.0, None)])
def test_adam_steps_match_the_optax_chain(tiny_flagship, kind, wd, clip):
    """Trainable parameters equal the JAX chain's after 5 steps (with the
    clip, the seeded gradients' global norm exceeds ``max_norm``); frozen
    ones stay in the port and, under AdamW, decay by ``lr * wd * p`` a step
    in the JAX chain (ROADMAP C, "Decay of frozen parameters")."""
    det, before, after, jafter = _steps(
        tiny_flagship, dict(type=kind, lr=1e-3, weight_decay=wd, betas=(0.9, 0.99)), clip)
    sched = build_lr_schedule(LR_CONFIG, 1e-3, 5)
    decay = np.prod([1 - sched(t) * wd for t in range(5)])
    assert {type(build_optimizer(det, dict(type=kind, lr=1.0), grad_clip=clip)).__name__} == {
        ("Clipped" if clip else "") + kind}
    frozen = 0
    for name, p in det.named_parameters():
        want = jafter[name].numpy()
        if p.requires_grad:
            assert not torch.equal(after[name], before[name]), name
            np.testing.assert_allclose(after[name].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=name)
        else:
            frozen += 1
            assert torch.equal(after[name], before[name]), name
            np.testing.assert_allclose(want, before[name].numpy() * decay, rtol=1e-6,
                                       err_msg=name)
    assert frozen > 0


def test_adam_decay_and_eps_follow_torch_not_jax():
    """ROADMAP C: mmdet's ``Adam`` is ``torch.optim.Adam``, whose weight decay
    is added to the gradient; the JAX package decays ``Adam`` as AdamW does
    and ignores the config's ``eps`` in both. One parameter, 3 steps."""
    p0 = np.asarray([1.5, -2.0, 0.25], np.float32)
    grads = [np.asarray(g, np.float32) for g in ([0.3, -0.1, 0.02], [0.1, 0.2, -0.4],
                                                  [-0.5, 0.05, 0.1])]

    def port(cfg):
        m = torch.nn.Linear(3, 1, bias=False)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(p0)[None])
        opt = build_optimizer(m, cfg)
        for g in grads:
            m.weight.grad = torch.from_numpy(g)[None].clone()
            opt.step()
        return m.weight.detach().numpy()[0]

    def jax_chain(cfg):
        params = {"w": jnp.asarray(p0)}
        tx = jax_build_optimizer(params, cfg, lambda t: cfg["lr"])
        state = tx.init(params)
        for g in grads:
            up, state = tx.update({"w": jnp.asarray(g)}, state, params)
            params = optax.apply_updates(params, up)
        return np.asarray(params["w"])

    def torch_ref(cls, **kw):
        w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = cls([w], **kw)
        for g in grads:
            w.grad = torch.from_numpy(g).clone()
            opt.step()
        return w.detach().numpy()

    # rtol 1e-5: optax's float32 bias correction 1 - 0.999 ** t is 1.3e-5
    # relative off at t = 1 (torch's is float64)
    adam = dict(type="Adam", lr=0.1, weight_decay=0.1)
    np.testing.assert_allclose(port(adam), torch_ref(torch.optim.Adam, lr=0.1, weight_decay=0.1),
                               rtol=1e-6)
    np.testing.assert_allclose(jax_chain(adam), port(dict(adam, type="AdamW")), rtol=1e-5)
    assert np.abs(port(adam) - jax_chain(adam)).max() > 1e-3
    eps = dict(type="AdamW", lr=0.1, weight_decay=0.0, eps=1.0)
    np.testing.assert_allclose(port(eps), torch_ref(torch.optim.AdamW, lr=0.1, weight_decay=0.0,
                                                    eps=1.0), rtol=1e-6)
    np.testing.assert_allclose(jax_chain(eps), port(dict(eps, eps=1e-8)), rtol=1e-5)
    assert np.abs(port(eps) - jax_chain(eps)).max() > 1e-3


# -------------------------------------------------------- runner and hooks ----

def test_enable_head_l1_as_jax():
    """``EpochBasedRunner.enable_head_l1``: a two-stage model has no
    ``bbox_head`` and is left as it is (JAX rebuilds the same detector); the
    YOLOv3 head has no ``use_l1``: the JAX registry drops the key with a
    warning when it builds the rebuilt head, and the port warns the same
    and leaves the head; a head with ``use_l1`` gets it on, weights kept."""
    from oadg_tpu.engine.runner import EpochBasedRunner as JaxRunner
    from oadg_tpu.utils.registry import HEADS as JAX_HEADS
    from oadg_tpu.utils.registry import build_from_cfg as jax_build_from_cfg
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine.runner import EpochBasedRunner
    yolo = ycases.model_cfg(cont=False)
    jstub = types.SimpleNamespace(cfg=types.SimpleNamespace(model=yolo, get=lambda k, d=None: d),
                                  tx=optax.sgd(0.1), mesh=None, _preprocess=None)
    JaxRunner.enable_head_l1(jstub)
    head_cfg = dict(jstub.det.bbox_head)
    assert head_cfg.pop("use_l1") is True
    with pytest.warns(UserWarning, match="YOLOV3Head: dropping config key 'use_l1'"):
        jhead = jax_build_from_cfg(dict(head_cfg, use_l1=True, type="YOLOV3Head"), JAX_HEADS)
    assert not hasattr(jhead, "use_l1")

    model = init_detector({"model": yolo}, device="cpu").model
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="YOLOV3Head: dropping config key 'use_l1'"):
        EpochBasedRunner.enable_head_l1(types.SimpleNamespace(model=model))
    assert not hasattr(model.bbox_head, "use_l1")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())
    cfg = dcases.tiny_model(load_config(os.path.join(ROOT, dcases.FLAGSHIP)))
    two_stage = init_detector({"model": cfg["model"]}, device="cpu").model
    EpochBasedRunner.enable_head_l1(types.SimpleNamespace(model=two_stage))
    assert not hasattr(two_stage, "bbox_head")
    head = types.SimpleNamespace(use_l1=False)
    EpochBasedRunner.enable_head_l1(types.SimpleNamespace(model=types.SimpleNamespace(
        bbox_head=head)))
    assert head.use_l1 is True


def test_feature_hook_captures_what_jax_captures(tiny_flagship):
    """``FeatureHook(layer_list=['neck']).capture``: the JAX package's
    ``capture_intermediates`` of the ``neck_m`` scope and the port's forward
    hook on ``neck`` give the same 5 FPN maps (NHWC vs NCHW, within 1e-4 of
    the largest); the port's hooks are gone after the capture."""
    from oadg_tpu.core.hook.hooks import FeatureHook as JaxFeatureHook
    from oadg_tpu.models import build_detector as jax_build_detector
    from oadg_tpu.utils.checkpoint import convert_torch_state_dict
    from oadg_tpu_torch.core.hook import FeatureHook
    cfg, det, _ = tiny_flagship
    model = copy.deepcopy(det).eval()
    variables = convert_torch_state_dict(model.state_dict(), roi_channels=16)
    img = np.random.RandomState(2).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    shape = np.asarray([[64, 96]], np.float32)
    jdet = jax_build_detector(dict(cfg["model"]), num_views=1)

    class Jitted:           # the hook's ``det.apply``, compiled instead of run op by op
        @staticmethod
        def apply(variables, batch, mode, **kw):
            return jax.jit(lambda v, b: jdet.apply(v, b, mode, **kw))(variables, batch)

    jrunner = types.SimpleNamespace(params=variables["params"],
                                    batch_stats=variables["batch_stats"], det=Jitted)
    want = JaxFeatureHook(layer_list=["neck"]).capture(
        jrunner, {"img": jnp.asarray(img), "img_shape": jnp.asarray(shape),
                  "scale_factor": jnp.ones((1, 4))})
    hook = FeatureHook(layer_list=["neck"])
    got = hook.capture(types.SimpleNamespace(model=model), {
        "img": torch.from_numpy(img).permute(0, 3, 1, 2), "img_shape": torch.from_numpy(shape),
        "scale_factor": torch.ones(1, 4)})
    assert list(got) == ["neck"] and list(want) == ["neck_m"]
    maps = want["neck_m"]["__call__"][0]
    assert len(got["neck"]) == len(maps) == 5
    for g, w in zip(got["neck"], maps):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    assert all(not m._forward_hooks for m in model.modules())
    with pytest.raises(KeyError, match="no module"):
        FeatureHook(layer_list=["nope"]).capture(types.SimpleNamespace(model=model), {})


class _GatedDataset:
    """Samples of one 40x56 image; ``__getitem__`` of an index >= ``gate``
    sets ``reached`` and waits for ``open``, so that the test changes the
    canvas between batches deterministically."""

    def __init__(self, n=5, gate=2):
        self.n, self.gate = n, gate
        self.open = threading.Event()
        self.reached = threading.Event()      # the loader asked for index ``gate``

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i >= self.gate:
            self.reached.set()
            assert self.open.wait(30)
        img = np.full((40, 56, 3), i, np.float32)
        return dict(img=img, img_metas=dict(img_shape=img.shape))


def test_sync_random_size_hook_with_the_prefetching_loader():
    """``SyncRandomSizeHook`` after the first batch: both packages' loaders
    (one thread, prefetch 1) yield the batch in flight at the old canvas and
    the rest at the hook's size, the JAX hook's and the port's sizes equal
    over 100 iterations."""
    from oadg_tpu.core.hook.hooks import SyncRandomSizeHook as JaxHook
    from oadg_tpu.data.builder import PrefetchLoader as JaxLoader
    from oadg_tpu_torch.core.hook import SyncRandomSizeHook
    from oadg_tpu_torch.data.builder import PrefetchLoader
    kw = dict(ratio_range=(2, 4), img_scale=(64, 96), interval=10)
    jhook, hook = JaxHook(**kw), SyncRandomSizeHook(**kw)
    for it in range(0, 100, 10):
        jb, b = types.SimpleNamespace(static_hw=None), types.SimpleNamespace(static_hw=None)
        jhook.after_train_iter(types.SimpleNamespace(iter=it, loader=types.SimpleNamespace(
            batcher=jb)), {})
        hook.after_train_iter(types.SimpleNamespace(iter=it, loader=types.SimpleNamespace(
            batcher=b)), {})
        assert b.static_hw == jb.static_hw == hook.size_at(it)
    shapes = {}
    for name, cls, h in (("jax", JaxLoader, jhook), ("port", PrefetchLoader, hook)):
        ds = _GatedDataset()
        loader = cls(ds, 1, num_workers=1, shuffle=False, static_hw=(64, 64), drop_last=False,
                     prefetch=1)
        seen = []
        for i, batch in enumerate(loader):
            seen.append(batch["img"].shape[1:3])
            if i == 0:
                # the one thread has collated batch 1 before it asks for index 2
                assert ds.reached.wait(30)
                h.after_train_iter(types.SimpleNamespace(iter=30, loader=loader), {})
                ds.open.set()
        shapes[name] = seen
    new = hook.size_at(30)
    assert shapes["port"] == shapes["jax"] == [(64, 64), (64, 64)] + [new] * 3


# ------------------------------------------------------ mmdet checkpoints ----

def _bn_prefixes(sd):
    return sorted({k[:-len("running_mean")] for k in sd if k.endswith("running_mean")})


def write_mmdet_pth(path, sd, classes):
    """``sd`` as a published mmdet checkpoint: a ``num_batches_tracked`` per
    BN, an EMA buffer, ``meta`` and ``optimizer``."""
    state = dict(sd)
    for pre in _bn_prefixes(sd):
        state[pre + "num_batches_tracked"] = torch.tensor(1234)
    state["ema_backbone_conv1_weight"] = torch.zeros(3)
    torch.save({"meta": {"mmdet_version": "2.28.2", "CLASSES": tuple(classes), "epoch": 12,
                         "iter": 35700},
                "state_dict": state,
                "optimizer": {"state": {}, "param_groups": [{"lr": 0.01, "momentum": 0.9,
                                                             "params": [0, 1]}]}}, path)
    return state


def _jax_graft(path, det, batch):
    """JAX's ``init_detector(cfg, path)`` graft: ``load_checkpoint_variables``
    onto an init tree of zeros -> (the grafted variables, the mmdet keys of
    the leaves it took)."""
    from oadg_tpu.utils.checkpoint import load_checkpoint_variables, merge_variables
    from oadg_tpu_torch.utils.checkpoint import _torch_key
    shapes = jax.eval_shape(lambda: det.init({"params": jax.random.PRNGKey(0),
                                              "sampling": jax.random.PRNGKey(1)}, batch, "test"))
    init = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    loaded = load_checkpoint_variables(path)
    merged = merge_variables(init, loaded)
    taken = set()

    def walk(dst, src, path):
        for k, v in src.items():
            if isinstance(v, dict):
                if isinstance(dst.get(k), dict):
                    walk(dst[k], v, path + (k,))
            elif k in dst and np.shape(dst[k]) == np.shape(v):
                taken.add(_torch_key(path + (k,)))

    for col in ("params", "batch_stats"):
        walk(init[col], loaded[col], ())
    return merged, taken


def test_flagship_mmdet_pth_serves_as_jax(tiny_flagship, tmp_path):
    """A seeded tiny flagship written as an mmdet ``.pth``: JAX's
    ``load_checkpoint_variables`` + ``merge_variables`` and the port's
    ``init_detector`` take the same tensors (every model tensor; not
    ``num_batches_tracked``, not ``ema_*``) and serve the same detections."""
    from oadg_tpu.engine.train_step import make_test_step
    from oadg_tpu.models import build_detector as jax_build_detector
    cfg, det, _ = tiny_flagship
    sd = det.state_dict()
    path = str(tmp_path / "flagship.pth")
    state = write_mmdet_pth(path, sd, dcases.CLASSES)
    img = np.random.RandomState(3).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    batch = {"img": jnp.asarray(img), "img_shape": jnp.asarray([[64.0, 96.0]]),
             "scale_factor": jnp.ones((1, 4))}
    jdet = jax_build_detector(dict(cfg["model"]), num_views=1)
    merged, taken = _jax_graft(path, jdet, batch)
    from oadg_tpu_torch.apis import init_detector
    handle = init_detector({"model": cfg["model"]}, checkpoint=path, device="cpu", seed=5)
    report = handle.checkpoint_report
    assert set(report["loaded"]) == taken == set(sd)
    assert report["missing"] == []
    assert sorted(s.split(" ")[0] for s in report["skipped"]) == sorted(set(state) - set(sd))
    want = make_test_step(jdet)(merged["params"], merged["batch_stats"], batch)
    got = handle.test({"img": torch.from_numpy(img).permute(0, 3, 1, 2),
                       "img_shape": torch.tensor([[64.0, 96.0]]),
                       "scale_factor": torch.ones(1, 4)})
    from test_torch_test_loop import assert_results_close
    from oadg_tpu_torch.apis.test import dets_to_results, fetch_dets
    from oadg_tpu.apis.test import dets_to_results as jax_dets_to_results
    got = dets_to_results(*fetch_dets(*got), 8)
    assert sum(len(r) for r in got[0]) > 0
    assert_results_close(got, jax_dets_to_results(*want, 8))


def test_dwd_mmdet_pth_takes_what_jax_takes(tmp_path):
    """The tiny DWD R101-DC5 (caffe ResNet, one 2048-channel RoI level): the
    same tensors as JAX's graft, JAX's grafted leaves equal to the source
    model's, and the port's loaded model serves the source model's
    detections exactly."""
    from oadg_tpu.models import build_detector as jax_build_detector
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    model = wcases.tiny_dwd_model(copy.deepcopy(dict(load_config(
        os.path.join(ROOT, wcases.DWD))["model"])), depth=101)
    src = init_detector({"model": model}, device="cpu", seed=2)
    sd = src.model.state_dict()
    path = str(tmp_path / "dwd.pth")
    write_mmdet_pth(path, sd, wcases.SDGOD_CLASSES)
    batch = {"img": jnp.zeros((1, 64, 96, 3)), "img_shape": jnp.asarray([[64.0, 96.0]]),
             "scale_factor": jnp.ones((1, 4))}
    merged, taken = _jax_graft(path, jax_build_detector(model, num_views=1), batch)
    handle = init_detector({"model": model}, checkpoint=path, device="cpu", seed=9)
    assert set(handle.checkpoint_report["loaded"]) == taken == set(sd)
    back = jax_variables_to_state_dict(merged)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    img = torch.from_numpy(np.random.RandomState(1).normal(0, 1, (1, 3, 64, 96)).astype(
        np.float32))
    b = {"img": img, "img_shape": torch.tensor([[64.0, 96.0]]), "scale_factor": torch.ones(1, 4)}
    for g, w in zip(handle.test(b), src.test(b)):
        assert torch.equal(g, w)


def test_yolo_mmdet_pth_loads_where_jax_raises(tmp_path):
    """ROADMAP C: JAX's ``convert_torch_state_dict`` knows the ResNet / FPN /
    RPN / RoI-head names only and raises on the YOLOv3 checkpoint (a
    Darknet BN's 1-d weight taken for a conv kernel); the port loads every
    tensor of it and serves the source model's detections exactly."""
    from oadg_tpu.utils.checkpoint import load_checkpoint_variables
    from oadg_tpu_torch.apis import init_detector
    model = ycases.model_cfg()
    src = init_detector({"model": model}, device="cpu", seed=4)
    sd = src.model.state_dict()
    path = str(tmp_path / "yolo.pth")
    write_mmdet_pth(path, sd, dcases.CLASSES)
    with pytest.raises(ValueError):
        load_checkpoint_variables(path)
    handle = init_detector({"model": model}, checkpoint=path, device="cpu", seed=8)
    report = handle.checkpoint_report
    assert set(report["loaded"]) == set(sd) and not report["missing"]
    assert len(report["skipped"]) == len(_bn_prefixes(sd)) + 1
    img = torch.from_numpy(np.random.RandomState(1).normal(0, 1, (1, 3, 64, 96)).astype(
        np.float32))
    b = {"img": img, "img_shape": torch.tensor([[64.0, 96.0]]), "scale_factor": torch.ones(1, 4)}
    for g, w in zip(handle.test(b), src.test(b)):
        assert torch.equal(g, w)


def test_checkpoint_graft_edges(tiny_flagship, tmp_path):
    """A classification checkpoint is read as the backbone's (its ``fc.``
    dropped), the rest of the model keeping its seeded values; keys the
    model lacks are skipped and reported; a detector checkpoint lacking a
    tensor, or a shape mismatch, raises and leaves the model as it was; the
    runner's ``load_weights`` (``load_from``) grafts the same way."""
    from oadg_tpu_torch.engine.runner import EpochBasedRunner, get_root_logger
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint, mmdet_state_dict
    _, det, _ = tiny_flagship
    model = copy.deepcopy(det)
    backbone = {k[len("backbone."):]: torch.full_like(v, 0.5)
                for k, v in det.state_dict().items() if k.startswith("backbone.")}
    cls_ckpt = dict(backbone, **{"fc.weight": torch.zeros(10, 4), "fc.bias": torch.zeros(10)})
    sd, backbone_only = mmdet_state_dict(cls_ckpt)
    assert backbone_only and sorted(sd) == sorted(f"backbone.{k}" for k in backbone)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_mmdet_checkpoint(model, cls_ckpt)
    assert len(report["loaded"]) == len(backbone) and report["missing"]
    assert all(torch.equal(model.state_dict()[k], before[k]) for k in report["missing"])
    assert all((model.state_dict()[k] == 0.5).all() for k in report["loaded"])
    full = {k: v + 1 for k, v in before.items()}
    extra = {"state_dict": dict(full, **{"mask_head.conv.weight": torch.zeros(2)})}
    report = load_mmdet_checkpoint(model, extra)
    assert report["loaded"] == sorted(full) and report["missing"] == []
    assert report["skipped"] == ["mask_head.conv.weight (not in the model)"]
    assert all(torch.equal(model.state_dict()[k], v) for k, v in full.items())
    partial = {"state_dict": {k: v for k, v in before.items() if k != "rpn_head.rpn_conv.weight"}}
    bad = {"state_dict": dict(before, **{"rpn_head.rpn_conv.weight": torch.zeros(1, 2, 3, 3)})}
    for ckpt, err, match in ((partial, KeyError, "rpn_head.rpn_conv.weight"),
                             (bad, ValueError, "rpn_head.rpn_conv.weight")):
        with pytest.raises(err, match=match):
            load_mmdet_checkpoint(model, ckpt)
        assert all(torch.equal(model.state_dict()[k], v) for k, v in full.items())
    stub = types.SimpleNamespace(model=model, logger=get_root_logger())
    assert EpochBasedRunner.load_weights(stub, extra) == report
    with pytest.raises(KeyError):
        EpochBasedRunner.load_weights(stub, partial)


@pytest.mark.parametrize("layout", ["epoch_pth", "bare_state_dict"])
def test_init_detector_refuses_a_checkpoint_lacking_a_tensor(tiny_flagship, tmp_path, layout):
    """The port's own ``epoch_{n}.pth`` (``Checkpointer.save``) or a bare
    ``state_dict`` with one tensor removed raises through ``init_detector``
    instead of serving that tensor's seeded value; whole, it loads every
    tensor and serves the source model's detections exactly."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine.runner import Checkpointer
    cfg, det, _ = tiny_flagship
    src = init_detector({"model": cfg["model"]}, device="cpu", seed=6)
    if layout == "epoch_pth":
        opt = torch.optim.SGD(src.model.parameters(), lr=0.1)
        path = Checkpointer(str(tmp_path)).save(src.model, opt, {"epoch": 1, "iter": 2})
    else:
        path = str(tmp_path / "sd.pth")
        torch.save(src.model.state_dict(), path)
    handle = init_detector({"model": cfg["model"]}, checkpoint=path, device="cpu", seed=7)
    assert set(handle.checkpoint_report["loaded"]) == set(src.model.state_dict())
    img = torch.from_numpy(np.random.RandomState(2).normal(0, 1, (1, 3, 64, 96)).astype(
        np.float32))
    b = {"img": img, "img_shape": torch.tensor([[64.0, 96.0]]), "scale_factor": torch.ones(1, 4)}
    for g, w in zip(handle.test(b), src.test(b)):
        assert torch.equal(g, w)
    ckpt = torch.load(path, weights_only=True)
    sd = ckpt["state_dict"] if layout == "epoch_pth" else ckpt
    del sd["roi_head.bbox_head.fc_cls.weight"]
    torch.save(ckpt, path)
    with pytest.raises(KeyError, match="roi_head.bbox_head.fc_cls.weight"):
        init_detector({"model": cfg["model"]}, checkpoint=path, device="cpu", seed=7)
