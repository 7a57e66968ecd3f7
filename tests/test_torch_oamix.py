"""The port's on-device OA-Mix, preprocess and training step against the
JAX package, on the CPU, on shared draw tables.

Each table is made with numpy and handed to both packages (the JAX
package's ``oamix_batch(draws=...)`` layout, leading (B, V-1) dims). JAX runs
with ``OAMIX_GEO_PW=force``, the piecewise-shift semantics of its
production path. The JAX table carries the JAX saliency scores and the
object-aware boxes' validity masked by the count of low-saliency gts; the
port's table carries neither, so the port computes both itself.

Tolerances:
- augmented views: at least 99.5% of pixels equal and none more than
  ``MAX_DIFF`` apart. The port rounds as XLA compiles the JAX chain (fused
  multiply-adds, folded constants, XLA's erf), but XLA's fusion choices
  move with the program around them (even one image alone against the same
  image in a batch of three: 96% of pixels equal for a per-box rotate), so
  a value can land on the other side of a floor or round and flip by 1;
  a later autocontrast or equalize LUT of that chain can stretch a flip to
  a few levels, so up to 4 are allowed. Measured on these tables: at least
  99.86% equal, largest difference 1;
- OA-Mix boxes and validity: equal;
- the preprocessed batch on the same augmented views: within 1e-5 after
  normalization, tiled keys equal;
- one training step with OA-Mix: losses rtol 1e-3 (augmented views as
  above; convolutions reassociate).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.engine import preprocess as jax_preprocess_mod
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.engine.preprocess import make_oadg_preprocess as jax_make_preprocess
from oadg_tpu.engine.train_step import make_train_step as jax_make_train_step
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.ops import oamix_device as jax_oamix_mod
from oadg_tpu.ops import pallas_warp as jax_pallas_warp
from oadg_tpu.ops.oamix_device import oamix_batch as jax_oamix_batch
from oadg_tpu.ops.saliency import saliency_score as jax_saliency_score
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                   make_oadg_preprocess, make_train_step)
from oadg_tpu_torch.engine import preprocess as preprocess_mod
from oadg_tpu_torch.engine import train_step as train_step_mod
from oadg_tpu_torch.ops.oamix_device import (MAX_DEPTH, MAX_FG, MAX_ML, MAX_OA, N_SLOTS,
                                             draw_table, oamix_batch)
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws, host_generator
from test_torch_train_step import KEYS, _jax_draws, _randomize

torch.set_num_threads(2)
H, W = 96, 128
MAX_DIFF = 4
CFG = dict(num_views=2, severity=10, mixture_width=3, mixture_depth=-1,
           sigma_ratio=0.3, spatial_ratio=4, score_thresh=10,
           random_box_ratio=(3, 1 / 3), random_box_scale=(0.01, 0.1),
           oa_random_box_scale=(0.005, 0.1), oa_random_box_ratio=(3, 1 / 3))
FLAGSHIP = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"


def _image(seed, h=H, w=W):
    """Gradients, flat and saturated blocks and noise, uint8 BGR."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 255 / (h + w)], -1)
    img = img + rng.randint(0, 32, (h, w, 3))
    img[h // 8:h // 3, w // 6:w // 2] = [200, 60, 30]
    img[h // 2:h - 8, w // 2:w - 10, 1] = 220
    return np.clip(img, 0, 255).astype(np.uint8)


def _gts(seed, h=H, w=W, n=5):
    """``n`` valid gts (two overlapping, one tiny) padded to MAX_FG."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((MAX_FG, 4), np.float32)
    x1 = rng.uniform(0, w * 0.7, n)
    y1 = rng.uniform(0, h * 0.7, n)
    gt[:n] = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.4, n),
                       y1 + rng.uniform(8, h * 0.4, n)], -1)
    gt[1] = gt[0] + [6, 4, 10, 8]
    gt[n - 1] = [w - 3, h - 3, w - 2.5, h - 1]
    valid = np.zeros((MAX_FG,), bool)
    valid[:n] = True
    return np.minimum(gt, [w, h, w, h]).astype(np.float32), valid


def _table(seed, version, force_op=None, h=H, w=W):
    """One view's draw table (port layout, with ``oa_valid0``): random
    boxes, levels, signs, coins and mixing draws from numpy; op indices
    over every op of ``version`` (or all ``force_op``)."""
    rng = np.random.RandomState(seed)
    n_ops = (4 if version == "augmix" else 9) + 6
    ml = np.array([[0.1 * w, 0.1 * h, 0.45 * w, 0.5 * h],
                   [0.55 * w, 0.45 * h, 0.95 * w, 0.9 * h]], np.float32)
    oa = np.zeros((MAX_OA, 4), np.float32)
    oa[:3] = [[0.05 * w, 0.6 * h, 0.3 * w, 0.9 * h], [0.5 * w, 0.05 * h, 0.8 * w, 0.3 * h],
              [0.2 * w, 0.2 * h, 0.5 * w, 0.55 * h]]
    op_idx = rng.randint(0, n_ops, (3, MAX_DEPTH, N_SLOTS))
    if force_op is not None:
        op_idx[:] = force_op
    return dict(
        ml_boxes=np.floor(ml), ml_valid=np.array([True, seed % 3 != 0]),
        ws=rng.dirichlet([1.0] * 3).astype(np.float32),
        depth=np.array([2, 3, 1] if force_op is None else [1, 1, 1], np.int32),
        op_idx=op_idx.astype(np.int32),
        op_level=(0.1 + rng.rand(3, MAX_DEPTH, N_SLOTS, MAX_FG) * 9.9).astype(np.float32),
        op_sign=np.where(rng.rand(3, MAX_DEPTH, N_SLOTS, MAX_FG) > 0.5, -1.0,
                         1.0).astype(np.float32),
        op_coin=rng.rand(3, MAX_DEPTH, N_SLOTS).astype(np.float32),
        oa_boxes=oa, oa_valid0=np.array([1, 1, 1, 0, 0], bool),
        mix_us=rng.rand(MAX_FG + MAX_OA).astype(np.float32),
        m_global=np.float32(rng.rand()))


def _jax_table(t, img, gt, gv, cfg):
    """The JAX package's table for the same draws: its own saliency scores
    and the oa validity the port computes on the device."""
    scores = np.asarray(jax.vmap(lambda b: jax_saliency_score(
        jnp.asarray(img, jnp.float32), b, min_size=cfg["spatial_ratio"]))(jnp.asarray(gt)))
    scores = np.where(gv, scores, -1.0).astype(np.float32)
    n_low = int(np.clip(np.sum(gv & (scores <= cfg["score_thresh"])), 1, MAX_OA))
    jt = {k: v for k, v in t.items() if k != "oa_valid0"}
    jt["fg_scores"] = scores
    jt["oa_valid"] = t["oa_valid0"] & (np.arange(MAX_OA) < n_low)
    return jt


def _stack(tables):
    """Per-image tables -> one batch table with leading (B, 1) dims."""
    return {k: np.stack([t[k] for t in tables])[:, None] for k in tables[0]}


def _rotate_op_by_op(img, rad, cx, cy, max_shift_x, max_shift_y):
    """The JAX package's ``warp_rotate`` run op by op on the host inside the
    compiled chain. XLA's CPU compile of its three passes, with only the
    result kept, moves a band of pixels by up to 220 levels against the same
    function run op by op (jax 0.9.0; recorded in ROADMAP.md C); the port
    is held to the op-by-op values."""
    def host(i, r):
        return np.asarray(jax_pallas_warp.warp_rotate(
            jnp.asarray(i), jnp.asarray(r), cx, cy, max_shift_x, max_shift_y), np.float32)

    return jax.pure_callback(host, jax.ShapeDtypeStruct(img.shape, jnp.float32), img, rad)


@pytest.fixture(scope="module", autouse=True)
def jax_production_path():
    """OAMIX_GEO_PW=force (the production per-box warps) and the op-by-op
    rotate, for every JAX trace of this module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OAMIX_GEO_PW", "force")
    mp.setattr(jax_oamix_mod, "warp_rotate", _rotate_op_by_op)
    yield
    mp.undo()


_JAX_OAMIX = {}


def _jax_oamix(tables, images, gts, cfg):
    """JAX ``oamix_batch`` on the tables, one jitted function per config and
    shape (traced once, called for every table)."""
    h, w = images[0].shape[:2]
    key = (tuple(sorted((k, str(v)) for k, v in cfg.items())), len(images), h, w)
    if key not in _JAX_OAMIX:
        _JAX_OAMIX[key] = jax.jit(lambda im, gt, gv, shape, dr: jax_oamix_batch(
            im, gt, gv, shape, jax.random.PRNGKey(0), cfg, draws=dr))
    jt = _stack([_jax_table(t, im, g, v, cfg) for t, im, (g, v) in zip(tables, images, gts)])
    out = _JAX_OAMIX[key](jnp.asarray(np.stack(images), jnp.float32),
                          jnp.asarray(np.stack([g for g, _ in gts])),
                          jnp.asarray(np.stack([v for _, v in gts])),
                          jnp.asarray([[h, w]] * len(images), jnp.float32),
                          jax.tree_util.tree_map(jnp.asarray, jt))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_both(tables, images, gts, cfg):
    """The port on the batch, JAX one image per call: XLA fuses the JAX
    chain differently for another batch size, and its results move by the
    same +-1 flips (96% of pixels equal between one image alone and in a
    batch of three, for a per-box rotate)."""
    h, w = images[0].shape[:2]
    got = oamix_batch(torch.from_numpy(np.stack(images)),
                      torch.from_numpy(np.stack([g for g, _ in gts])),
                      torch.from_numpy(np.stack([v for _, v in gts])),
                      np.array([[h, w]] * len(images), np.float32), cfg, draws=_stack(tables))
    want = [_jax_oamix([t], [im], [g], cfg) for t, im, g in zip(tables, images, gts)]
    return {k: np.concatenate([o[k] for o in want]) for k in want[0]}, got


def _check_view(got, want):
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.float32).astype(np.int32))
    assert float(np.mean(diff == 0)) >= 0.995, f"equal: {np.mean(diff == 0):.5f}"
    assert diff.max() <= MAX_DIFF, diff.max()


@pytest.fixture(scope="module", params=["augmix", "augmix.all"])
def composed(request):
    version = request.param
    cfg = dict(CFG, version=version)
    seeds = (1, 2, 3)
    tables = [_table(s, version) for s in seeds]
    images = [_image(s) for s in seeds]
    gts = [_gts(s) for s in seeds]
    want, got = _run_both(tables, images, gts, cfg)
    return tables, want, got


@pytest.mark.parametrize("i", [0, 1, 2])
def test_aug_view_matches_jax(composed, i):
    tables, want, got = composed
    assert np.isin(tables[i]["op_idx"], np.arange(4, 15)).any()        # geometric ops drawn
    _check_view(got["aug"][i, 0], want["aug"][i, 0])


@pytest.mark.parametrize("key", ["multilevel_boxes", "multilevel_valid", "oamix_boxes",
                                 "oamix_valid"])
def test_oamix_boxes_match_jax(composed, key):
    _, want, got = composed
    np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert got["oamix_valid"].any()


@pytest.fixture(scope="module")
def forced():
    """augmix.all with every op index forced in turn: one image per op."""
    cfg = dict(CFG, version="augmix.all")
    tables = [_table(20 + k, "augmix.all", force_op=k) for k in range(15)]
    images = [_image(4)] * 15
    gts = [_gts(4)] * 15
    return _run_both(tables, images, gts, cfg)


@pytest.mark.parametrize("op", range(15))
def test_forced_op_matches_jax(forced, op):
    want, got = forced
    _check_view(got["aug"][op, 0], want["aug"][op, 0])


def test_draw_table_is_well_formed():
    """Host draws from a CPU generator: boxes inside the image and apart,
    Dirichlet weights summing to 1, depths 1..3, op indices in range; the
    same seed gives the same table."""
    shapes = np.array([[H, W], [80, 100]], np.float32)
    t = draw_table(shapes, dict(CFG, version="augmix"), torch.Generator().manual_seed(3))
    again = draw_table(shapes, dict(CFG, version="augmix"), torch.Generator().manual_seed(3))
    for k in t:
        np.testing.assert_array_equal(t[k], again[k])
    assert t["op_idx"].shape == (2, 1, 3, MAX_DEPTH, N_SLOTS) and t["op_idx"].max() < 10
    assert set(np.unique(t["depth"])) <= {1, 2, 3}
    np.testing.assert_allclose(t["ws"].sum(-1), 1.0, rtol=1e-6)
    for b, (h, w) in enumerate(shapes):
        for key, n in (("ml", MAX_ML), ("oa", MAX_OA)):
            boxes = t[f"{key}_boxes"][b, 0]
            valid = t["ml_valid" if key == "ml" else "oa_valid0"][b, 0]
            assert valid.sum() >= 1
            for i in np.nonzero(valid)[0]:
                x1, y1, x2, y2 = boxes[i]
                assert 0 <= x1 < x2 <= w and 0 <= y1 < y2 <= h
                for j in np.nonzero(valid)[0][:list(np.nonzero(valid)[0]).index(i)]:
                    iw = min(x2, boxes[j, 2]) - max(x1, boxes[j, 0])
                    ih = min(y2, boxes[j, 3]) - max(y1, boxes[j, 1])
                    assert iw <= 0 or ih <= 0


def test_generated_table_drives_the_same_path():
    """``draws=None`` draws a table from the generator and runs on it: the
    same output as handing that table back."""
    cfg = dict(CFG, version="augmix.all")
    img = torch.from_numpy(np.stack([_image(5), _image(6)]))
    gt, gv = (torch.from_numpy(np.stack(a)) for a in zip(_gts(5), _gts(6)))
    shapes = np.array([[H, W]] * 2, np.float32)
    a = oamix_batch(img, gt, gv, shapes, cfg, generator=torch.Generator().manual_seed(9))
    b = oamix_batch(img, gt, gv, shapes, cfg, draws=a["draws"])
    assert a["aug"].shape == (2, 1, H, W, 3)
    for k in ("aug", "multilevel_boxes", "multilevel_valid", "oamix_boxes", "oamix_valid"):
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        oamix_batch(img, gt, gv, shapes, cfg)
    g = torch.Generator().manual_seed(1)
    assert host_generator(g) is g


# ------------------------------------------------------------ preprocess ----

def _raw_batch(seed, h=H, w=W, b=2):
    images = [_image(seed + i, h, w) for i in range(b)]
    gts = [_gts(seed + i, h, w) for i in range(b)]
    labels = np.random.RandomState(seed).randint(0, 8, (b, MAX_FG)).astype(np.int32)
    return images, gts, labels


def _jax_preprocess(images, gts, labels, tables, cfg, norm):
    h, w = images[0].shape[:2]
    jt = _stack([_jax_table(t, im, g, v, cfg) for t, im, (g, v) in zip(tables, images, gts)])
    real = jax_preprocess_mod.oamix_batch
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_preprocess_mod, "oamix_batch",
               lambda *a, **k: real(*a, **k, draws=jax.tree_util.tree_map(jnp.asarray, jt)))
    try:
        out = jax_make_preprocess(cfg, norm)(
            {"img_raw": jnp.asarray(np.stack(images)),
             "gt_bboxes": jnp.asarray(np.stack([g for g, _ in gts])),
             "gt_labels": jnp.asarray(labels),
             "gt_valid": jnp.asarray(np.stack([v for _, v in gts])),
             "img_shape": jnp.asarray([[h, w]] * len(images), jnp.float32)},
            jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_raw_batch(images, gts, labels):
    h, w = images[0].shape[:2]
    return {"img_raw": torch.from_numpy(np.stack(images)),
            "gt_bboxes": torch.from_numpy(np.stack([g for g, _ in gts])),
            "gt_labels": torch.from_numpy(labels),
            "gt_valid": torch.from_numpy(np.stack([v for _, v in gts])),
            "img_shape": torch.tensor([[h, w]] * len(images), dtype=torch.float32)}


@pytest.fixture(scope="module")
def preprocessed():
    cfg = load_config(FLAGSHIP)
    oamix_cfg = dict(cfg["oamix_config"], score_thresh=10)
    oamix_cfg.pop("type")
    images, gts, labels = _raw_batch(30)
    tables = [_table(30 + i, oamix_cfg["version"]) for i in range(2)]
    want = _jax_preprocess(images, gts, labels, tables, oamix_cfg, cfg["img_norm_cfg"])
    pre = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"])
    got = pre(_torch_raw_batch(images, gts, labels), torch.Generator(), draws=_stack(tables))
    # the port's preprocess on the JAX package's augmented views: its own
    # arithmetic (normalization, views-major layout, tiling) alone
    aug = torch.from_numpy(_jax_oamix(tables, images, gts, oamix_cfg)["aug"].astype(np.uint8))
    real = preprocess_mod.oamix_batch
    mp = pytest.MonkeyPatch()
    mp.setattr(preprocess_mod, "oamix_batch", lambda *a, **k: dict(real(*a, **k), aug=aug))
    try:
        on_jax_views = pre(_torch_raw_batch(images, gts, labels), torch.Generator(),
                           draws=_stack(tables))
    finally:
        mp.undo()
    return want, got, on_jax_views


def test_preprocess_matches_jax_on_the_same_views(preprocessed):
    want, _, got = preprocessed
    assert set(got) == set(want)
    img = got["img"]
    assert img.shape == (4, 3, H, W) and img.dtype == torch.float32
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), want["img"], rtol=0, atol=1e-5)
    for k in want:
        if k != "img":
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_preprocess_matches_jax(preprocessed):
    """The whole preprocess, the port's own OA-Mix included: clean views
    within 1e-5, augmented views to the composed tolerance, tiled keys
    equal."""
    want, got, _ = preprocessed
    img = got["img"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(img[:2], want["img"][:2], rtol=0, atol=1e-5)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    for i in (2, 3):
        raw = np.rint(img[i] * std + mean)[..., ::-1]
        _check_view(torch.from_numpy(raw.astype(np.uint8)),
                    np.rint(want["img"][i] * std + mean)[..., ::-1])
    for k in want:
        if k != "img":
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# ---------------------------------------------------------- training step ----

def run_train_step(chain="slots"):
    """One step of the tiny flagship with OA-Mix on ``chain``: JAX
    ``make_train_step(..., preprocess=...)`` on a table (traced with
    ``OAMIX_CHAIN=chain``), the port's ``make_train_step(..., preprocess=...)``
    on the same table and the JAX sampling draws. -> (JAX log, port log)."""
    cfg = load_config(FLAGSHIP)
    oamix_cfg = dict(cfg["oamix_config"], score_thresh=10)
    oamix_cfg.pop("type")
    _, model = _flagship_model_cfg(tiny=True)
    h, w = 64, 96
    images, gts, labels = _raw_batch(40, h, w)
    tables = [_table(40 + i, oamix_cfg["version"], h=h, w=w) for i in range(2)]
    jbatch = {"img_raw": jnp.asarray(np.stack(images)),
              "gt_bboxes": jnp.asarray(np.stack([g for g, _ in gts])),
              "gt_labels": jnp.asarray(labels),
              "gt_valid": jnp.asarray(np.stack([v for _, v in gts])),
              "img_shape": jnp.asarray([[h, w]] * 2, jnp.float32)}
    jdet = jax_build_detector(model, num_views=2)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jnp.zeros((4, h, w, 3)), "img_shape": jnp.asarray([[h, w]] * 4, jnp.float32)}))
    jt = _stack([_jax_table(t, im, g, v, oamix_cfg)
                 for t, im, (g, v) in zip(tables, images, gts)])
    real = jax_preprocess_mod.oamix_batch
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 3]

    mp = pytest.MonkeyPatch()
    mp.setenv("OAMIX_CHAIN", chain)
    mp.setattr(jax_preprocess_mod, "oamix_batch",
               lambda *a, **k: real(*a, **k, draws=jax.tree_util.tree_map(jnp.asarray, jt)))
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        params = variables["params"]
        tx = jax_build_optimizer(params, cfg.optimizer, lambda t: cfg.optimizer["lr"],
                                 model_cfg=model)
        jstep = jax_make_train_step(jdet, tx, donate=False,
                                    preprocess=jax_make_preprocess(oamix_cfg,
                                                                   cfg["img_norm_cfg"]))
        _, _, _, jlog = jstep(params, variables["batch_stats"], tx.init(params), jbatch,
                              jax.random.PRNGKey(2))
        jlog = {k: float(v) for k, v in jlog.items()}
    finally:
        mp.undo()

    handle = init_detector({"model": model}, device="cpu", num_views=2)
    det = handle.model
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    with torch.no_grad():
        feats = det.extract_feat(torch.zeros((1, 3, h, w)))
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    given = _jax_draws(num_anchors, MAX_FG + rp, 10)
    pre = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"], chain=chain)
    step = make_train_step(det, build_optimizer(det, cfg.optimizer),
                           build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100),
                           preprocess=lambda b, g: pre(b, g, draws=_stack(tables)))
    mp = pytest.MonkeyPatch()
    mp.setattr(train_step_mod, "UniformDraws", lambda g: UniformDraws(given=given))
    try:
        log = step(_torch_raw_batch(images, gts, labels), torch.Generator())
    finally:
        mp.undo()
    return jlog, {k: float(v) for k, v in log.items()}


@pytest.fixture(scope="module")
def train_run():
    return run_train_step()


LOSS_KEYS = ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox", "loss_cont"]


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_train_step_with_oamix_matches_jax(train_run, key):
    jlog, log = train_run
    np.testing.assert_allclose(log[key], jlog[key], rtol=1e-3)
    if key == "loss_cont":
        assert log[key] > 0
