"""The port's training entry point against the JAX package, on the CPU.

The tiny flagship OA-DG config (``torch_data_cases.tiny_train_cfg``: the
tiny model, the flagship's train pipeline with ``Resize`` in range mode onto
a 64x96 canvas, ``RandomFlip``, ``OAMix``, ``Normalize`` skipped, ``Pad``,
``DefaultFormatBundle``, ``Collect``; 4 PNGs of about 64x96) goes through:

- the train pipeline and the shuffled loader of both packages, one loader
  thread (``Resize`` and ``RandomFlip`` draw from numpy's global generator,
  seeded alike before each side): samples and batches equal key by key, bit
  for bit, over two epochs, the batch order included;
- the first loader batch through JAX's ``make_oadg_preprocess`` and
  ``forward_train`` (fixed sampling keys, a shared OA-Mix draw table) and
  through the port runner's upload and step (the same table, the uniforms
  JAX draws from those keys): losses within rtol 1e-4, as in
  ``test_torch_train_step.py``;
- the runner itself: its LR at each iteration against JAX's
  ``build_lr_schedule`` (rtol 1e-6), a run resumed from its epoch-1
  checkpoint (``resume_from`` and ``auto_resume``) against the straight
  run (parameters, momentum, ``iter`` and LR bit for bit; the pipeline
  draws nothing: one scale, ``flip_ratio=0``), ``load_from`` (weights only),
  the backbone's ``init_cfg`` from a checkpoint file (equal tensors), a
  model-zoo name (raises);
- the hooks: the NaN guard and ``CheckLossHook`` raise, ``NumClassCheckHook``
  rejects a class mismatch, the EMA hooks give the numbers of
  ``tests/test_hooks.py``'s cases (rtol 1e-6), and each of the eight
  further hooks does on a runner stub what the JAX hook does;
- ``tools/torch_train.py --device cpu`` as a subprocess for 1 epoch, whose
  ``epoch_1.pth`` scores through ``tools/torch_test.py`` with the runner's
  own numbers (equal).
"""
import copy
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_data_cases as cases
from oadg_tpu.engine import preprocess as jax_preprocess_mod
from oadg_tpu.engine.optim import build_lr_schedule as jax_build_lr_schedule
from oadg_tpu.engine.preprocess import make_oadg_preprocess as jax_make_preprocess
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu_torch.apis import init_detector, train_detector
from oadg_tpu_torch.apis.train import build_runner
from oadg_tpu_torch.engine import preprocess as preprocess_mod
from oadg_tpu_torch.engine import train_step as train_step_mod
from oadg_tpu_torch.engine.runner import step_generator
from oadg_tpu_torch.engine.train_step import upload_train_batch
from oadg_tpu_torch.ops.oamix_device import MAX_FG
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from test_torch_oamix import _jax_table, _stack, _table, jax_production_path  # noqa: F401
from test_torch_train_step import KEYS, _jax_draws, _randomize

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_KEYS = ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox", "loss_cont"]


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_plain(v) for v in o)
    return o


def _loaders(cfg):
    """The train dataset and shuffled loader of each package, from ``cfg``."""
    from oadg_tpu.data import build_dataloader as jax_build_dataloader
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataloader, build_dataset, static_hw_from_pipeline
    train = _plain(cfg.data.train)
    static = static_hw_from_pipeline(train["dataset"]["pipeline"])
    kw = dict(samples_per_gpu=2, workers_per_gpu=1, seed=0, static_hw=static,
              max_gt=cfg.max_gt)
    jds, ds = jax_build_dataset(train), build_dataset(train)
    return (jds, jax_build_dataloader(jds, rank=0, world_size=1, **kw),
            ds, build_dataloader(ds, **kw))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    cfg = cases.tiny_train_cfg(tmp_path_factory.mktemp("train"))
    return cfg, _loaders(cfg)


def test_train_samples_equal_jax(data):
    cfg, (jds, _, ds, _) = data
    assert len(ds) == len(jds) == 4
    np.testing.assert_array_equal(ds.flag, jds.flag)
    resized = []
    for i in range(len(ds)):
        np.random.seed(10 + i)
        want = jds[i]
        np.random.seed(10 + i)
        got = ds[i]
        assert got["img_raw"].dtype == np.uint8 and got["img"].dtype == np.uint8
        assert got["norm_on_device"] is True
        cases.assert_equal_nested(got, want)
        resized.append(float(got["img_metas"]["scale_factor"][0]) != 1.0)
    assert any(resized)


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batches_equal_jax_over_two_shuffled_epochs(data, epoch):
    cfg, (_, jloader, _, loader) = data
    assert len(loader) == len(jloader) == 2
    orders, batches = [], []
    for e in range(epoch + 1):          # the loaders' shuffle streams advance per epoch
        for ld in (jloader, loader):
            np.random.seed(20 + e)
            batches.append(list(ld))
            orders.append([tuple(m["ori_filename"] for m in b["metas"]) for b in batches[-1]])
    want, got = batches[-2:]
    assert orders[-1] == orders[-2]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"img_raw", "img_shape", "scale_factor", "gt_bboxes",
                                    "gt_labels", "gt_valid", "metas"}
        assert g["img_raw"].dtype == np.uint8 and g["img_raw"].shape == (2, 64, 96, 3)
        cases.assert_equal_nested(g, w)


def test_set_epoch_replays_the_shuffle_stream(data):
    """``set_epoch(e)`` gives draw ``e`` of the seed's stream, whatever came
    before: a resumed run sees the straight run's order."""
    _, (_, _, ds, _) = data
    from oadg_tpu_torch.data import build_dataloader

    def orders(ld, epochs):
        out = []
        for e in epochs:
            if e is not None:
                ld.set_epoch(e)
            out.append(ld._epoch_batches())
        return [[tuple(b) for b in bs] for bs in out]

    many = build_dataloader(RepeatN(ds, 4), samples_per_gpu=2, seed=3)
    straight = orders(many, [None] * 4)
    assert len({tuple(o) for o in straight}) > 1
    again = build_dataloader(RepeatN(ds, 4), samples_per_gpu=2, seed=3)
    assert orders(again, [2, 0, 3, 1]) == [straight[2], straight[0], straight[3], straight[1]]


class RepeatN:
    def __init__(self, ds, n):
        self.ds, self.n, self.flag = ds, n, np.tile(ds.flag, n)

    def __len__(self):
        return self.n * len(self.ds)


# ------------------------------------------------------------- the slice ----

@pytest.fixture(scope="module")
def slice_run(data, tmp_path_factory):
    """The first loader batch: JAX's preprocess + forward_train against the
    port runner's upload + step, on one table and the same draws."""
    cfg, (_, jloader, ds, loader) = data
    np.random.seed(30)
    jbatch = next(iter(jloader))
    np.random.seed(30)
    batch = next(iter(loader))
    oamix_cfg = {k: v for k, v in _plain(cfg.oamix_config).items() if k != "type"}
    tables = [_table(40 + i, oamix_cfg["version"], h=int(hw[0]), w=int(hw[1]))
              for i, hw in enumerate(batch["img_shape"])]
    jt = _stack([_jax_table(t, im, g, v, dict(oamix_cfg, score_thresh=10))
                 for t, im, g, v in zip(tables, jbatch["img_raw"], jbatch["gt_bboxes"],
                                        jbatch["gt_valid"])])

    model = _plain(cfg.model)
    h, w = batch["img_raw"].shape[1:3]
    jdet = jax_build_detector(model, num_views=2)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jnp.zeros((4, h, w, 3)), "img_shape": jnp.asarray([[h, w]] * 4, jnp.float32)}))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 3]

    real = jax_preprocess_mod.oamix_batch
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_preprocess_mod, "oamix_batch",
               lambda *a, **k: real(*a, **k, draws=jax.tree_util.tree_map(jnp.asarray, jt)))
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        pre = jax_make_preprocess(oamix_cfg, _plain(cfg.img_norm_cfg))
        losses = jax.jit(lambda v, b: jdet.apply(v, pre(b, jax.random.PRNGKey(0)), "train"))(
            variables, {k: jnp.asarray(v) for k, v in jbatch.items() if k != "metas"})
        jlog = {k: float(v) for k, v in losses.items()}
    finally:
        mp.undo()

    det = init_detector({"model": model}, device="cpu", num_views=2).model
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    runner = build_runner(det, ds, cfg, work_dir=str(tmp_path_factory.mktemp("slice")))
    with torch.no_grad():
        feats = det.extract_feat(torch.zeros((1, 3, h, w)))
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    given = _jax_draws(num_anchors, MAX_FG + model["train_cfg"]["rpn_proposal"]["max_per_img"],
                       10)
    port_real = preprocess_mod.oamix_batch
    mp = pytest.MonkeyPatch()
    mp.setattr(preprocess_mod, "oamix_batch",
               lambda *a, **k: port_real(*a, **dict(k, draws=_stack(tables))))
    mp.setattr(train_step_mod, "UniformDraws", lambda g: UniformDraws(given=given))
    try:
        arrs = upload_train_batch(batch, torch.device("cpu"))
        log = runner.step(arrs, step_generator(runner.seed, runner.iter, "cpu"))
    finally:
        mp.undo()
    return jlog, {k: float(v) for k, v in log.items()}, arrs


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_first_batch_losses_through_the_runner_match_jax(slice_run, key):
    jlog, log, _ = slice_run
    np.testing.assert_allclose(log[key], jlog[key], rtol=1e-4)
    if key == "loss_cont":
        assert log[key] > 0


def test_upload_keeps_img_shape_on_the_host_and_uint8_pixels(slice_run):
    _, _, arrs = slice_run
    assert arrs["img_raw"].dtype == torch.uint8 and arrs["img_raw"].shape == (2, 64, 96, 3)
    assert arrs["img_shape"].device.type == "cpu" and arrs["scale_factor"].shape == (2, 4)
    assert "img" not in arrs


# ------------------------------------------------------- runs of the runner ----

def _model(cfg):
    return init_detector(cfg, device="cpu", seed=0, num_views=2).model


def _run(cfg, work_dir, **options):
    from oadg_tpu_torch.data import build_dataset
    run_cfg = copy.deepcopy(cfg)
    run_cfg.merge_from_dict(options)
    return train_detector(_model(run_cfg), build_dataset(_plain(run_cfg.data.train)), run_cfg,
                          work_dir=str(work_dir))


def _state(runner):
    params = {k: p.detach().clone() for k, p in runner.model.named_parameters()}
    momentum = {i: s["momentum_buffer"].clone()
                for i, s in enumerate(runner.optimizer.state.values())}
    return params, momentum, runner.iter, runner.optimizer.param_groups[0]["lr"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A straight 2-epoch run; 1 epoch, then ``resume_from`` its checkpoint;
    the same with ``auto_resume``; ``load_from`` with no epoch to run."""
    root = tmp_path_factory.mktemp("runs")
    cfg = cases.tiny_train_cfg(root / "data", flip_ratio=0.0, scales=[(96, 56)])
    straight = _run(cfg, root / "straight")
    first = _run(cfg, root / "split", **{"runner.max_epochs": 1})
    ckpt = str(root / "split" / "epoch_1.pth")
    os.makedirs(root / "auto")
    os.symlink(ckpt, root / "auto" / "epoch_1.pth")
    resumed = _run(cfg, root / "split", resume_from=ckpt)
    auto = _run(cfg, root / "auto", auto_resume=True)
    loaded = _run(cfg, root / "loaded", load_from=ckpt, **{"runner.max_epochs": 0})
    return dict(root=root, straight=straight, first=first, resumed=resumed, auto=auto,
                loaded=loaded, ckpt=ckpt)


@pytest.mark.parametrize("how", ["resumed", "auto"])
def test_resumed_run_equals_the_straight_run(runs, how):
    want_p, want_m, want_it, want_lr = _state(runs["straight"])
    got_p, got_m, got_it, got_lr = _state(runs[how])
    assert got_it == want_it == 4 and runs[how].step.t == 4 and runs[how].epoch == 2
    assert got_lr == want_lr
    assert sorted(got_m) == sorted(want_m) and len(got_m) > 50
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    first = _state(runs["first"])
    assert any(not torch.equal(first[0][k], want_p[k]) for k in want_p)


def test_checkpoint_holds_mmcv_layout(runs):
    ckpt = torch.load(runs["ckpt"], map_location="cpu", weights_only=True)
    assert set(ckpt) == {"meta", "state_dict", "optimizer"}
    assert ckpt["meta"] == {"epoch": 1, "iter": 2, "seed": 0}
    assert set(ckpt["state_dict"]) == set(runs["first"].model.state_dict())
    momentum = [s["momentum_buffer"] for s in ckpt["optimizer"]["state"].values()]
    assert len(momentum) == len(runs["first"].optimizer.state) and all(
        m.device.type == "cpu" for m in momentum)
    latest = runs["root"] / "straight" / "latest.pth"
    assert os.path.realpath(latest) == str(runs["root"] / "straight" / "epoch_2.pth")


def test_load_from_sets_weights_only(runs):
    loaded, first = runs["loaded"], runs["first"]
    assert loaded.epoch == 0 and loaded.iter == 0 and loaded.step.t == 0
    assert len(loaded.optimizer.state) == 0
    want = dict(first.model.named_parameters())
    for k, p in loaded.model.named_parameters():
        assert torch.equal(p, want[k]), k


def test_runner_lr_matches_jax_schedule_at_each_iteration(runs):
    """The LR each step ran with (logged every iteration) against JAX's
    schedule: a 3-iteration warmup and the step boundary at iteration 2
    (epoch 1 of 2 iterations)."""
    with open(runs["root"] / "straight" / "log.json") as f:
        lines = [json.loads(line) for line in f]
    train = [ln for ln in lines if ln["mode"] == "train"]
    assert [ln["iter"] for ln in train] == [1, 2, 3, 4]
    assert [ln["epoch"] for ln in train] == [1, 1, 2, 2]
    cfg = runs["straight"].cfg
    want = jax_build_lr_schedule(_plain(cfg.lr_config), cfg.optimizer["lr"], steps_per_epoch=2)
    for t, ln in enumerate(train):
        np.testing.assert_allclose(ln["lr"], float(want(jnp.asarray(t))), rtol=1e-6)
        assert math.isfinite(ln["loss"]) and ln["time"] > 0 and ln["data_time"] >= 0
        assert set(LOSS_KEYS) <= set(ln)
    assert train[0]["lr"] < train[1]["lr"] and train[2]["lr"] < train[1]["lr"]


@pytest.mark.parametrize("prefixed", [True, False])
def test_backbone_init_cfg_loads_a_checkpoint_file(runs, tmp_path, prefixed):
    """``model.backbone.init_cfg=dict(type='Pretrained', checkpoint=FILE)``:
    the file's backbone tensors (keys with or without ``backbone.``) go into
    the backbone; the rest of the model keeps its seeded weights."""
    from oadg_tpu_torch.data import build_dataset
    source = runs["straight"].model.state_dict()
    sd = {k if prefixed else k[len("backbone."):]: v for k, v in source.items()
          if k.startswith("backbone.")}
    torch.save({"state_dict": sd}, tmp_path / "backbone.pth")
    cfg = copy.deepcopy(runs["straight"].cfg)
    cfg.merge_from_dict({"model.backbone.init_cfg": dict(
        type="Pretrained", checkpoint=str(tmp_path / "backbone.pth"))})
    model = _model(cfg)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    build_runner(model, build_dataset(_plain(cfg.data.train)), cfg, work_dir=str(tmp_path))
    got = model.state_dict()
    for k, v in got.items():
        want = source[k] if k.startswith("backbone.") else seeded[k]
        assert torch.equal(v, want), k
    assert any(not torch.equal(source[k], seeded[k]) for k in got if k.startswith("backbone."))


@pytest.mark.parametrize("key", ["model.backbone.init_cfg", "load_from", "resume_from"])
def test_model_zoo_names_raise(runs, tmp_path, key):
    from oadg_tpu_torch.data import build_dataset
    cfg = copy.deepcopy(runs["straight"].cfg)
    name = "open-mmlab://detectron2/resnet50_caffe"
    cfg.merge_from_dict({key: dict(type="Pretrained", checkpoint=name)
                         if key.endswith("init_cfg") else name})
    with pytest.raises(NotImplementedError, match="Long tail"):
        build_runner(_model(cfg), build_dataset(_plain(cfg.data.train)), cfg,
                     work_dir=str(tmp_path))


# ------------------------------------------------------------------ hooks ----

def _stub_runner(**kw):
    return types.SimpleNamespace(**kw)


def test_nan_loss_raises_in_the_runner(runs, tmp_path):
    from oadg_tpu_torch.data import build_dataset
    cfg = runs["straight"].cfg
    runner = build_runner(_model(cfg), build_dataset(_plain(cfg.data.train)), cfg,
                          work_dir=str(tmp_path))
    real = runner.step

    def nan_step(batch, generator):
        return dict(real(batch, generator), loss=torch.tensor(float("nan")))

    nan_step.t = real.t
    runner.step = nan_step
    with pytest.raises(FloatingPointError, match="non-finite loss at iter 1"):
        runner.train_epoch()


def test_check_loss_hook_raises_on_nan_at_interval():
    from oadg_tpu_torch.core.hook import CheckLossHook
    hook = CheckLossHook(interval=10)
    hook.after_train_iter(_stub_runner(iter=5), {"loss": float("nan")})   # off-interval
    with pytest.raises(FloatingPointError):
        hook.after_train_iter(_stub_runner(iter=10), {"loss": float("nan")})
    hook.after_train_iter(_stub_runner(iter=20), {"loss": 1.0})


def test_num_class_check_hook_rejects_a_mismatch(runs):
    from oadg_tpu_torch.core.hook import NumClassCheckHook
    cfg = runs["straight"].cfg
    ds = types.SimpleNamespace(CLASSES=cases.CLASSES)
    NumClassCheckHook().before_run(_stub_runner(cfg=cfg, loader=types.SimpleNamespace(dataset=ds)))
    ds.CLASSES = cases.CLASSES[:5]
    with pytest.raises(ValueError, match="num_classes=8"):
        NumClassCheckHook().before_run(
            _stub_runner(cfg=cfg, loader=types.SimpleNamespace(dataset=ds)))


class _W(torch.nn.Module):
    def __init__(self, v):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(np.atleast_1d(np.float32(v))))

    def set(self, v):
        with torch.no_grad():
            self.w.copy_(torch.as_tensor(np.float32(v)))


def test_ema_update_and_swap():
    """``tests/test_hooks.py::test_ema_update_and_swap``'s numbers."""
    from oadg_tpu_torch.core.hook import EMAHook
    hook = EMAHook(momentum=0.1, interval=1)
    r = _stub_runner(iter=0, model=_W(1.0))
    hook.after_train_iter(r, {})
    np.testing.assert_allclose(hook.ema[0].numpy(), [1.0])
    for it, v, want in ((1, 2.0, 1.1), (2, 3.0, 1.29)):
        r.iter = it
        r.model.set(v)
        hook.after_train_iter(r, {})
        np.testing.assert_allclose(hook.ema[0].numpy(), [want], rtol=1e-6)
    hook.swap(r)
    np.testing.assert_allclose(r.model.w.detach().numpy(), [1.29], rtol=1e-6)
    hook.swap(r)
    np.testing.assert_allclose(r.model.w.detach().numpy(), [3.0])


def test_ema_interval_skips():
    from oadg_tpu_torch.core.hook import EMAHook
    hook = EMAHook(momentum=0.5, interval=2)
    r = _stub_runner(iter=0, model=_W(1.0))
    hook.after_train_iter(r, {})
    r.iter = 1
    r.model.set(100.0)
    hook.after_train_iter(r, {})
    np.testing.assert_allclose(hook.ema[0].numpy(), [1.0])
    r.iter = 2
    hook.after_train_iter(r, {})
    np.testing.assert_allclose(hook.ema[0].numpy(), [50.5])


def test_ema_lifecycle_swaps_for_eval_and_back():
    from oadg_tpu_torch.core.hook import EMAHook
    hook = EMAHook(momentum=0.5, interval=1)
    r = _stub_runner(iter=0, model=_W(1.0))
    hook.after_train_iter(r, {})
    r.iter = 1
    r.model.set(3.0)
    hook.after_train_iter(r, {})
    hook.after_train_epoch(r)
    np.testing.assert_allclose(r.model.w.detach().numpy(), [2.0])
    hook.before_train_epoch(r)
    np.testing.assert_allclose(r.model.w.detach().numpy(), [3.0])
    hook.before_train_epoch(r)
    np.testing.assert_allclose(r.model.w.detach().numpy(), [3.0])


def test_exp_and_linear_momentum_ema():
    from oadg_tpu_torch.core.hook import ExpMomentumEMAHook, LinearMomentumEMAHook
    for hook, m in ((ExpMomentumEMAHook(momentum=0.1, gamma=10, interval=1),
                     (1 - 0.1) * math.exp(-2 / 10) + 0.1),
                    (LinearMomentumEMAHook(momentum=0.5, gamma=10, interval=1),
                     min(0.5, 2 / 11))):
        r = _stub_runner(iter=0, model=_W(0.0))
        hook.after_train_iter(r, {})
        r.iter = 1
        r.model.set(1.0)
        hook.after_train_iter(r, {})
        np.testing.assert_allclose(hook.ema[0].numpy(), [m], rtol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("EMAHook", dict(momentum=0.1, interval=1)),
    ("EMAHook", dict(momentum=0.5, interval=2)),
    ("ExpMomentumEMAHook", dict(momentum=0.1, gamma=10, interval=1)),
    ("LinearMomentumEMAHook", dict(momentum=0.5, gamma=10, interval=1)),
])
def test_ema_hooks_equal_the_jax_hooks(name, kw):
    """The JAX package's hook (on a runner whose ``params`` are ``{"w": ...}``)
    and the port's (on a module whose one parameter is ``w``) through the same
    seeded sequence of ``w`` over 9 iterations, with an epoch's end (swap in,
    then back) after iterations 3 and 6 and the run's end after 8: the
    averages after every call, the swapped weights and the weights left at the
    end agree within rtol 1e-6."""
    from oadg_tpu.core.hook import hooks as jax_hooks
    from oadg_tpu_torch.core import hook as torch_hooks
    values = np.random.RandomState(3).randn(9, 4).astype(np.float32) * 10
    jax_hook, hook = getattr(jax_hooks, name)(**kw), getattr(torch_hooks, name)(**kw)
    jr = _stub_runner(iter=0, params={"w": jnp.asarray(values[0])})
    r = _stub_runner(iter=0, model=_W(values[0]))

    def same():
        np.testing.assert_allclose(r.model.w.detach().numpy(), np.asarray(jr.params["w"]),
                                   rtol=1e-6)
        if jax_hook.ema_params is None:
            assert hook.ema is None
        else:
            np.testing.assert_allclose(hook.ema[0].numpy(),
                                       np.asarray(jax_hook.ema_params["w"]), rtol=1e-6)

    for it, v in enumerate(values):
        jr.iter = r.iter = it
        jr.params = {"w": jnp.asarray(v)}
        r.model.set(v)
        jax_hook.after_train_iter(jr, {})
        hook.after_train_iter(r, {})
        same()
        if it in (3, 6):
            jax_hook.after_train_epoch(jr)
            hook.after_train_epoch(r)
            same()
            jax_hook.before_train_epoch(jr)
            hook.before_train_epoch(r)
            same()
    jax_hook.after_train_epoch(jr)
    hook.after_train_epoch(r)
    jax_hook.after_run(jr)
    hook.after_run(r)
    same()
    assert not np.allclose(r.model.w.detach().numpy(), values[-1])


def test_text_log_follows_the_work_dir(tmp_path):
    """Two runs in one process each write ``train.log`` into their own work
    dir, and naming the same work dir twice keeps one file handler."""
    import logging
    from oadg_tpu_torch.engine.runner import get_root_logger
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    get_root_logger(str(a)).info("first run")
    logger = get_root_logger(str(a))
    assert sum(isinstance(h, logging.FileHandler) for h in logger.handlers) == 1
    get_root_logger(str(b)).info("second run")
    assert "first run" in (a / "train.log").read_text()
    assert "second run" not in (a / "train.log").read_text()
    assert "second run" in (b / "train.log").read_text()
    assert sum(isinstance(h, logging.FileHandler) for h in logger.handlers) == 1


class _Recorder(types.SimpleNamespace):
    """A runner stub that records the calls the hooks make on it."""

    def __init__(self, **kw):
        super().__init__(calls=[], **kw)
        self.logger = types.SimpleNamespace(info=lambda *a: self.calls.append(("info",) + a),
                                            warning=lambda *a: self.calls.append(("warn",) + a))

    def enable_head_l1(self):
        self.calls.append(("l1", self.epoch))


def _yolox_mode_switch(hook, tmp, jax_result=None):
    ds = types.SimpleNamespace(keys=[])
    ds.update_skip_type_keys = lambda k: ds.keys.append((r.epoch, tuple(k)))
    r = _Recorder(epoch=0, max_epochs=6, loader=types.SimpleNamespace(dataset=ds))
    for r.epoch in range(6):
        hook.before_train_epoch(r)
    return ds.keys, r.calls


def _sync_random_size(hook, tmp, jax_result=None):
    batcher = types.SimpleNamespace(static_hw=(640, 960))
    r = _Recorder(iter=0, loader=types.SimpleNamespace(batcher=batcher))
    seen = []
    for r.iter in range(1, 31):
        hook.after_train_iter(r, {})
        seen.append(batcher.static_hw)
    return seen


def _all_stages(hook, tmp, jax_result=None):
    r = _Recorder(epoch=0, iter=0, max_epochs=2, model=None, loader=None)
    hook.before_run(r)
    for r.epoch in range(2):
        hook.before_train_epoch(r)
        for r.iter in range(r.epoch * 2 + 1, r.epoch * 2 + 3):
            hook.after_train_iter(r, {"loss": 1.0})
        hook.after_train_epoch(r)
        hook.after_val_epoch(r, {"bbox_mAP": 0.5})
    hook.after_run(r)
    return sorted(vars(r)), r.calls


class _ToyNeck(torch.nn.Module):
    """``simple_test`` through a linear ``neck``: the port's side of a flax
    module whose ``neck`` is a Dense layer."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.neck = torch.nn.Linear(*kernel.shape)
        with torch.no_grad():
            self.neck.weight.copy_(torch.from_numpy(np.array(kernel.T)))
            self.neck.bias.copy_(torch.from_numpy(np.array(bias)))

    def simple_test(self, batch):
        return self.neck(batch["x"]).relu()


def _feature_hook(hook, tmp, jax_result=None):
    import flax.linen as fnn
    x = np.random.RandomState(0).normal(0, 1, (2, 5)).astype(np.float32)
    if jax_result is None:
        class Toy(fnn.Module):
            @fnn.compact
            def __call__(self, batch, mode):
                return jax.nn.relu(fnn.Dense(3, name="neck")(batch["x"]))

        det = Toy()
        variables = det.init(jax.random.PRNGKey(0), {"x": jnp.asarray(x)}, "test")
        feats = hook.capture(types.SimpleNamespace(det=det, params=variables["params"],
                                                   batch_stats=None), {"x": jnp.asarray(x)})
        out = np.asarray(feats["neck"]["__call__"][0])
        return hook.layer_list, out, {k: np.asarray(v) for k, v in
                                      variables["params"]["neck"].items()}
    _, _, w = jax_result
    model = _ToyNeck(w["kernel"], w["bias"])
    feats = hook.capture(types.SimpleNamespace(model=model), {"x": torch.from_numpy(x)})
    return hook.layer_list, feats["neck"].numpy(), w


def _wandb(hook, tmp, jax_result=None):
    from test_wandb_logger import FakeCkpt, FakeDS, FakeLogger, make_fake_wandb
    hook.wandb = make_fake_wandb()
    feats = types.SimpleNamespace(features={"neck": np.arange(6.0)})
    r = types.SimpleNamespace(
        logger=FakeLogger(), iter=10, epoch=1, cfg=dict(a=1), lr_fn=lambda it: 0.02,
        hooks=[feats], ckpt=FakeCkpt(str(tmp)), val_dataset=FakeDS(), val_domain="night",
        last_val_results=[[np.array([[1, 2, 3, 4, 0.9]], np.float32), np.zeros((0, 5))],
                          [np.zeros((0, 5)), np.array([[5, 6, 7, 8, 0.2]], np.float32)]])
    hook.before_run(r)
    hook.after_train_iter(r, dict(loss=1.5, acc=90.0))
    hook.after_train_epoch(r)
    hook.after_val_epoch(r, dict(bbox_mAP=0.5, bbox_mAP_50=0.7))
    hook.after_run(r)

    def plain(o):
        if isinstance(o, dict):
            return {k: plain(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [plain(v) for v in o]
        if isinstance(o, np.ndarray):
            return o.tolist()
        if hasattr(o, "__dict__"):
            return (type(o).__name__, plain(vars(o)))
        return o

    return (plain(hook.wandb.inited), plain(hook.wandb.logged),
            [plain(a) for a in hook.wandb.artifacts])


def _profiler(hook, tmp, jax_result=None):
    r = _Recorder(iter=0, work_dir=str(tmp))
    window = []
    if jax_result is None:
        mp = pytest.MonkeyPatch()
        mp.setattr(jax.profiler, "start_trace", lambda d: window.append(("start", r.iter)))
        mp.setattr(jax.profiler, "stop_trace", lambda: window.append(("stop", r.iter)))
        try:
            for r.iter in range(1, 8):
                hook.after_train_iter(r, {})
        finally:
            mp.undo()
        return window
    for r.iter in range(1, 8):
        torch.ones(4).sum()
        hook.after_train_iter(r, {})
        if hook.prof is not None and not window:
            window.append(("start", r.iter))
        if hook.trace_path and len(window) == 1:
            window.append(("stop", r.iter))
    assert os.path.basename(hook.trace_path) == "trace_iter2-4.json"
    with open(hook.trace_path) as f:
        assert json.load(f)["traceEvents"]
    return window


HOOK_CASES = {
    "YOLOXModeSwitchHook": (dict(num_last_epochs=2), _yolox_mode_switch),
    "SyncRandomSizeHook": (dict(ratio_range=(10, 20), img_scale=(640, 960), interval=3),
                           _sync_random_size),
    "SetEpochInfoHook": ({}, _all_stages),
    "SyncNormHook": (dict(num_last_epochs=15, interval=1), _all_stages),
    "FeatureHook": (dict(layer_list=["neck"]), _feature_hook),
    "WandbLogger": (dict(interval=1, log_checkpoint=True, num_eval_images=2,
                         bbox_score_thr=0.5), _wandb),
    "WandbLoggerMulti": (dict(interval=1, num_eval_images=2), _wandb),
    "ProfilerHook": (dict(start_iter=2, num_iters=2), _profiler),
}


@pytest.mark.parametrize("name", ["YOLOXModeSwitchHook", "SyncRandomSizeHook",
                                  "SetEpochInfoHook", "SyncNormHook", "FeatureHook",
                                  "WandbLogger", "WandbLoggerMulti", "ProfilerHook"])
def test_a_hook_the_port_lacks_raises(name, tmp_path):
    """Each of the JAX package's eight further hooks builds in the port from
    a config and does on one runner stub what the JAX hook does:
    ``YOLOXModeSwitchHook`` switches once at ``max_epochs - num_last_epochs``;
    ``SyncRandomSizeHook`` sets the same canvases; ``SetEpochInfoHook`` and
    ``SyncNormHook`` do nothing at one process; ``FeatureHook`` captures
    the same ``neck`` output (within 1e-6); ``WandbLogger`` and
    ``WandbLoggerMulti`` (the fake wandb module of
    ``tests/test_wandb_logger.py``) log the same entries; ``ProfilerHook``
    traces the same window of iterations."""
    from oadg_tpu.utils.registry import HOOKS as JAX_HOOKS
    from oadg_tpu.utils.registry import build_from_cfg as jax_build_from_cfg
    from oadg_tpu_torch.core.hook import Hook  # noqa: F401  (registers the hooks)
    from oadg_tpu_torch.utils.registry import HOOKS, build_from_cfg
    kw, scenario = HOOK_CASES[name]
    jax_hook = jax_build_from_cfg(dict(type=name, **kw), JAX_HOOKS)
    hook = build_from_cfg(dict(type=name, **kw), HOOKS)
    assert type(hook).__module__.startswith("oadg_tpu_torch.")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = scenario(jax_hook, tmp_path / "jax")
    got = scenario(hook, tmp_path / "port", want)
    if scenario is _feature_hook:
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
        return
    if scenario is _wandb:
        got, want = (json.loads(json.dumps(x).replace(str(tmp_path / "port"), "D").replace(
            str(tmp_path / "jax"), "D")) for x in (got, want))
        assert got[1] and got[2 if name == "WandbLogger" else 1]
    assert got == want


def test_collate_refuses_img_raw_without_norm_on_device():
    from oadg_tpu_torch.data.builder import StaticBatcher
    img = np.zeros((4, 6, 3), np.uint8)
    sample = dict(img=img, img_raw=img, img_metas=dict(img_shape=(4, 6, 3)))
    with pytest.raises(NotImplementedError, match="Data layer leftovers"):
        StaticBatcher((32, 32))([sample])
    batch = StaticBatcher((32, 32))([dict(sample, norm_on_device=True)])
    assert "img" not in batch and batch["img_raw"].dtype == np.uint8


def test_oamix_op_on_host_raises():
    from oadg_tpu_torch.data.pipelines import OAMix
    with pytest.raises(NotImplementedError, match="Data layer leftovers"):
        OAMix(on_device=False)


def test_oamix_op_refuses_keep_orig_false():
    """``keep_orig=False`` (the YOLOv3 OA-DG config's) augments the first
    view too: the op no longer refuses it, and records it in the sample's
    ``oamix_cfg`` for the preprocess, beside the ``keep_orig=True`` default."""
    from oadg_tpu_torch.data.pipelines import OAMix
    img = np.zeros((4, 6, 3), np.uint8)
    for keep in (False, True):
        op = OAMix(keep_orig=keep)
        out = op(dict(img=img, gt_bboxes=np.zeros((1, 4), np.float32)))
        assert op.keep_orig is keep and out["oamix_cfg"]["keep_orig"] is keep
        assert out["norm_on_device"] and out["img_raw"].dtype == np.uint8


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_collate_keeps_the_img_raw_dtype_as_jax(dtype):
    """``norm_on_device`` samples: the ``img_raw`` canvas in the samples'
    dtype equals the JAX ``StaticBatcher``'s (float32 values in [-20, 280],
    as ``PhotoMetricDistortion`` leaves them, are not wrapped), and the
    preprocess takes either: its clean view is ``(raw[..., ::-1] - mean) /
    std`` of the unclamped raw image, as the JAX preprocess computes it."""
    from oadg_tpu.data.builder import StaticBatcher as JaxBatcher
    from oadg_tpu_torch.data.builder import StaticBatcher
    from oadg_tpu_torch.engine.preprocess import make_oadg_preprocess
    rng = np.random.RandomState(4)
    samples = []
    for h, w in ((30, 40), (28, 36)):
        raw = (rng.uniform(-20, 280, (h, w, 3)).astype(np.float32) if dtype == "float32"
               else rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        samples.append(dict(img=raw, img_raw=raw, norm_on_device=True,
                            img_metas=dict(img_shape=(h, w, 3)),
                            gt_bboxes=np.array([[2, 3, 20, 25]], np.float32),
                            gt_labels=np.array([1], np.int64)))
    got, want = StaticBatcher((32, 64))(samples), JaxBatcher((32, 64))(samples)
    assert got["img_raw"].dtype == want["img_raw"].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got["img_raw"], want["img_raw"])
    if dtype == "float32":
        assert got["img_raw"].min() < 0 and got["img_raw"].max() > 255
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)
    pre = make_oadg_preprocess(dict(num_views=2), norm)
    batch = {k: torch.from_numpy(got[k]) for k in ("img_raw", "gt_bboxes", "gt_labels",
                                                   "gt_valid")}
    batch["img_shape"] = got["img_shape"]
    out = pre(batch, torch.Generator().manual_seed(0))
    raw = got["img_raw"].astype(np.float32)
    clean = (raw[..., ::-1] - np.float32(norm["mean"])) / np.float32(norm["std"])
    np.testing.assert_array_equal(out["img"][:2].permute(0, 2, 3, 1).numpy(), clean)
    assert out["img"].shape == (4, 3, 32, 64) and torch.isfinite(out["img"]).all()


# ------------------------------------------------------------------ the tool ----

def test_train_tool_checkpoint_scores_as_the_runner_evaluated(tmp_path):
    """``tools/torch_train.py --device cpu`` for 1 epoch with evaluation, as
    a subprocess; its ``epoch_1.pth`` through ``tools/torch_test.py``."""
    cfg = cases.tiny_train_cfg(tmp_path / "data", **{"runner.max_epochs": 1})
    config = str(tmp_path / "tiny_oadg.py")
    cfg.dump(config)
    work = tmp_path / "work"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_train.py"), config,
                          "--device", "cpu", "--work-dir", str(work), "--seed", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert sorted(os.listdir(work)) == ["epoch_1.pth", "latest.pth", "log.json",
                                        "tiny_oadg.py", "train.log"]
    assert "Set random seed to 0" in (work / "train.log").read_text()
    with open(work / "log.json") as f:
        lines = [json.loads(line) for line in f]
    assert [ln["mode"] for ln in lines] == ["train", "train", "val"]
    val = {k: v for k, v in lines[-1].items() if k not in ("mode", "epoch")}
    assert len(val) == 12 and val["bbox_mAP"] > 0

    spec = importlib.util.spec_from_file_location("torch_test_tool",
                                                  os.path.join(ROOT, "tools", "torch_test.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    metrics = tool.main([config, str(work / "epoch_1.pth"), "--device", "cpu",
                         "--eval", "bbox"])
    assert metrics == val


def test_train_tool_defaults_to_the_card_and_refuses_launchers(tmp_path, monkeypatch):
    """The tool trains on the card in one process by default; ``--launcher``
    without its launcher's environment refuses to start (data parallel:
    ``tests/test_torch_dist_data.py`` runs it under a launcher)."""
    spec = importlib.util.spec_from_file_location("torch_train_tool",
                                                  os.path.join(ROOT, "tools", "torch_train.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = tool.parse_args(["c.py"])
    assert args.device == "cuda" and args.launcher == "none" and not args.auto_resume
    for k in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for launcher in ("pytorch", "slurm", "mpi"):
        with pytest.raises(RuntimeError, match="no launcher environment"):
            tool.main(["c.py", "--launcher", launcher, "--device", "cpu"])
