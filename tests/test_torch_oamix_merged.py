"""The port's merged OA-Mix chain, the gather path of its per-box warps and
the ``oamix_batch`` knobs against the JAX package, on the CPU, on shared draw
tables (made with numpy, as in ``test_torch_oamix.py``, whose helpers these
tests use).

The JAX package picks its chain and its per-box warp route from environment
variables that it reads while tracing; each JAX function here is jitted once
per set of variables (``OAMIX_CHAIN=merged`` with ``OAMIX_GEO_PW=force``;
``OAMIX_GEO_PW=0`` for the gather path) and called for every table, one image
per call.

Tolerances:
- merged chain against the JAX merged chain: at least 99.8% of values equal
  per view and none more than 1 apart (composed views of ``augmix`` and
  ``augmix.all`` and each of the 15 forced ops; measured: 100% on all but the
  forced background rotate, 99.997% with a largest difference of 1, where
  XLA's fusion of the shift table moves one value across a rounding);
- the port's merged chain against its slots chain on the same table: differ
  by at most 1 on at most 1e-4 of values (the JAX package's own bound for its
  two chains; measured: equal);
- gather path (``geo_pw=False``) against JAX with ``OAMIX_GEO_PW=0`` on forced
  tables of the three bboxes_only ops: at least 99% of values equal and the
  rest within 2 levels (the gather path divides by the matrix entry ``e`` and
  chains products per pixel, which XLA may fuse otherwise; measured: equal);
  its helper functions within 1e-4 relative;
- one tiny-flagship training step on the merged chain: losses rtol 1e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.ops import oamix_device as jod
from oadg_tpu_torch.engine import make_oadg_preprocess
from oadg_tpu_torch.engine import preprocess as preprocess_mod
from oadg_tpu_torch.ops import oamix_device as od
from oadg_tpu_torch.ops.oamix_device import N_SLOTS, oamix_batch
from test_torch_oamix import (CFG, H, LOSS_KEYS, W, _gts, _image, _jax_table, _raw_batch,
                              _stack, _table, _torch_raw_batch, run_train_step)

torch.set_num_threads(2)
MERGED_ENV = {"OAMIX_CHAIN": "merged", "OAMIX_GEO_PW": "force"}
GATHER_ENV = {"OAMIX_CHAIN": "slots", "OAMIX_GEO_PW": "0"}
_JAX = {}
_TRACED = set()          # which of the JAX package's routes the traces went through


def _jax_oamix(table, image, gt, cfg, env):
    """JAX ``oamix_batch`` on one image and table under ``env``: one jitted
    function per config and environment, traced at its first call."""
    key = (tuple(sorted((k, str(v)) for k, v in cfg.items())), tuple(sorted(env.items())))
    if key not in _JAX:
        _JAX[key] = jax.jit(lambda im, g, gv, shape, dr: jod.oamix_batch(
            im, g, gv, shape, jax.random.PRNGKey(0), cfg, draws=dr))
    h, w = image.shape[:2]
    jt = _stack([_jax_table(table, image, gt[0], gt[1], cfg)])
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    for name in ("_depth_step_merged", "_apply_geo_bboxes_only"):
        real = getattr(jod, name)
        mp.setattr(jod, name, lambda *a, _n=name, _f=real, **kw: _TRACED.add(_n) or _f(*a, **kw))
    try:
        out = _JAX[key](jnp.asarray(image[None], jnp.float32), jnp.asarray(gt[0][None]),
                        jnp.asarray(gt[1][None]), jnp.asarray([[h, w]], jnp.float32),
                        jax.tree_util.tree_map(jnp.asarray, jt))
    finally:
        mp.undo()
    return {k: np.asarray(v)[0] for k, v in out.items()}


def _port(tables, images, gts, cfg, **knobs):
    h, w = images[0].shape[:2]
    return oamix_batch(torch.from_numpy(np.stack(images)),
                       torch.from_numpy(np.stack([g for g, _ in gts])),
                       torch.from_numpy(np.stack([v for _, v in gts])),
                       np.array([[h, w]] * len(images), np.float32), cfg,
                       draws=_stack(tables), **knobs)


def _diff(got, want):
    return np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.float32).astype(np.int32))


def _check_merged_view(got, want):
    assert got.dtype == torch.uint8
    d = _diff(got, want)
    assert float(np.mean(d == 0)) >= 0.998, f"equal: {np.mean(d == 0):.5f}"
    assert d.max() <= 1, d.max()


def _check_chains_agree(merged, slots):
    d = _diff(merged, slots.numpy())
    assert d.max() <= 1, d.max()
    assert float(np.mean(d > 0)) <= 1e-4, f"differ: {np.mean(d > 0):.6f}"


@pytest.fixture(scope="module", params=["augmix", "augmix.all"])
def composed(request):
    """Three composed views per version: JAX merged, port merged, port slots."""
    cfg = dict(CFG, version=request.param)
    seeds = (1, 2, 3)
    tables = [_table(s, request.param) for s in seeds]
    images = [_image(s) for s in seeds]
    gts = [_gts(s) for s in seeds]
    want = [_jax_oamix(t, im, g, cfg, MERGED_ENV) for t, im, g in zip(tables, images, gts)]
    return tables, want, _port(tables, images, gts, cfg, chain="merged"), \
        _port(tables, images, gts, cfg, chain="slots")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_merged_view_matches_jax(composed, i):
    tables, want, got, _ = composed
    assert "_depth_step_merged" in _TRACED                             # JAX ran its merged chain
    assert np.isin(tables[i]["op_idx"], np.arange(4, 15)).any()        # geometric ops drawn
    _check_merged_view(got["aug"][i, 0], want[i]["aug"][0])


@pytest.mark.parametrize("key", ["multilevel_boxes", "multilevel_valid", "oamix_boxes",
                                 "oamix_valid"])
def test_merged_boxes_match_jax(composed, key):
    _, want, got, _ = composed
    np.testing.assert_array_equal(got[key].numpy(), np.stack([w[key] for w in want]))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_merged_view_equals_slots_view(composed, i):
    _, _, merged, slots = composed
    _check_chains_agree(merged["aug"][i, 0], slots["aug"][i, 0])


@pytest.fixture(scope="module")
def forced():
    """augmix.all with every op index forced in turn: one image per op."""
    cfg = dict(CFG, version="augmix.all")
    tables = [_table(20 + k, "augmix.all", force_op=k) for k in range(15)]
    images, gts = [_image(4)] * 15, [_gts(4)] * 15
    want = [_jax_oamix(t, im, g, cfg, MERGED_ENV) for t, im, g in zip(tables, images, gts)]
    return want, _port(tables, images, gts, cfg, chain="merged"), \
        _port(tables, images, gts, cfg, chain="slots")


@pytest.mark.parametrize("op", range(15))
def test_merged_forced_op_matches_jax(forced, op):
    want, got, _ = forced
    _check_merged_view(got["aug"][op, 0], want[op]["aug"][0])


@pytest.mark.parametrize("op", range(15))
def test_merged_forced_op_equals_slots(forced, op):
    _, merged, slots = forced
    _check_chains_agree(merged["aug"][op, 0], slots["aug"][op, 0])
    if op not in (0, 1):        # autocontrast and equalize keep this image's full range
        assert not torch.equal(merged["aug"][op, 0], torch.from_numpy(_image(4)))


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(kwargs.get("axis", None))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("version", ["augmix", "augmix.all"])
def test_merged_chain_runs_what_the_table_implies(monkeypatch, version):
    """The merged chain runs B7's function three times per active slot that
    drew a rotate and once per shear or translate, takes ONE histogram per
    depth step in which any active slot drew equalize, and never runs the
    slots chain's warps."""
    n_photo = od.num_photometric(version)
    t = _table(2, version)
    t["op_idx"][0, 0] = [1, 1, 1]                       # three slots draw equalize: one histogram
    shifts = _count_calls(monkeypatch, od, "merged_shift_rows")
    hists = _count_calls(monkeypatch, od, "equalize")
    for name in ("piecewise_shift_rows", "warp_rotate", "warp_shear_x", "warp_shear_y",
                 "warp_translate_x", "warp_translate_y"):
        monkeypatch.setattr(od, name, lambda *a, **k: pytest.fail("a slots-chain warp ran"))
    _port([t], [_image(2)], [_gts(2)], dict(CFG, version=version), chain="merged")
    active = list(t["ml_valid"]) + [True]
    want_shifts = want_hists = 0
    for c in range(3):
        for d in range(int(t["depth"][c])):
            ops = [int(t["op_idx"][c, d, s]) for s in range(N_SLOTS) if active[s]]
            want_hists += 1 in ops
            want_shifts += sum(3 if op in (n_photo, n_photo + 3) else 1
                               for op in ops if op >= n_photo)
    assert want_shifts > 0 and want_hists > 0
    assert (len(shifts), len(hists)) == (want_shifts, want_hists)
    assert set(shifts) == {0, 1}                         # row and column passes


# ------------------------------------------------------------ gather path ----

@pytest.mark.parametrize("op", [9, 10, 11])
def test_gather_path_matches_jax(op):
    """bboxes_only rotate, shear and translate on the per-pixel gather path
    against the JAX package's CPU default (``OAMIX_GEO_PW=0``); the gather
    path is another resampling than the piecewise shifts, so the two differ
    where boxes rotate or shear."""
    cfg = dict(CFG, version="augmix.all")
    table, img, gt = _table(60 + op, "augmix.all", force_op=op), _image(op % 5), _gts(op % 3 + 1)
    want = _jax_oamix(table, img, gt, cfg, GATHER_ENV)
    got = _port([table], [img], [gt], cfg, geo_pw=False)
    assert "_apply_geo_bboxes_only" in _TRACED                         # JAX ran its gather path
    d = _diff(got["aug"][0, 0], want["aug"][0])
    assert float(np.mean(d == 0)) >= 0.99, f"equal: {np.mean(d == 0):.5f}"
    assert d.max() <= 2, d.max()
    if op != 11:
        piecewise = _port([table], [img], [gt], cfg, geo_pw=True)
        assert not torch.equal(got["aug"], piecewise["aug"])


def _boxes(seed, g=6):
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, W * 0.6, g), rng.uniform(0, H * 0.6, g)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, W * 0.4, g), y1 + rng.uniform(4, H * 0.4, g)],
                     -1).astype(np.float32)
    level = rng.uniform(0.1, 10, g).astype(np.float32)
    sign = np.where(rng.rand(g) > 0.5, -1.0, 1.0).astype(np.float32)
    return boxes, level, sign


@pytest.mark.parametrize("is_bg", [False, True])
@pytest.mark.parametrize("coin", [0.2, 0.8])
@pytest.mark.parametrize("family", [0, 1, 2])
def test_op_matrices_and_inverse_match_jax(family, coin, is_bg):
    boxes, level, sign = _boxes(family)
    want = jod._op_matrices(None, family, jnp.asarray(boxes), None, (H, W), 10.0, is_bg,
                            inj=(jnp.asarray(level), jnp.asarray(sign), jnp.float32(coin)))
    got = od._op_matrices(family, torch.from_numpy(boxes), (H, W), torch.from_numpy(level),
                          torch.from_numpy(sign), coin < 0.5, is_bg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(od._invert_2x3(got).numpy(),
                               np.asarray(jax.vmap(jod._invert_2x3)(want)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", [0, 1, 2])
def test_two_pass_and_per_pixel_warps_match_jax(family):
    """``_warp_affine_2pass`` and ``_warp_by_pixel_matrices`` on one inverse
    affine; sources fall outside the image on two sides."""
    boxes, level, sign = _boxes(10 + family, g=1)
    boxes[0] = [20, 10, 90, 70]
    inv = od._invert_2x3(od._op_matrices(family, torch.from_numpy(boxes), (H, W),
                                         torch.from_numpy(level), torch.from_numpy(sign),
                                         True))[0]
    img = _image(7).astype(np.float32)
    want = jod._warp_affine_2pass(jnp.asarray(img), jnp.asarray(inv.numpy()))
    got = od._warp_affine_2pass(torch.from_numpy(img), inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-2)
    inv_map = inv.reshape(1, 1, 6).expand(H, W, 6)
    want = jod._warp_by_pixel_matrices(jnp.asarray(img), jnp.asarray(inv_map.numpy()))
    got = od._warp_by_pixel_matrices(torch.from_numpy(img), inv_map)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-2)
    assert (got == 0).any() and (got != 0).any()


# ------------------------------------------------------------------ knobs ----

def _one(seed=5, version="augmix.all"):
    return [_table(seed, version)], [_image(seed)], [_gts(seed)], dict(CFG, version=version)


@pytest.mark.parametrize("op", [3, 12])
def test_force_op_fills_the_table(monkeypatch, op):
    tables, images, gts, cfg = _one()
    forced_table = dict(tables[0], op_idx=np.full_like(tables[0]["op_idx"], op))
    want = _port([forced_table], images, gts, cfg)
    got = _port(tables, images, gts, cfg, force_op=op)
    assert (got["draws"]["op_idx"] == op).all() and (tables[0]["op_idx"] != op).any()
    assert torch.equal(got["aug"], want["aug"])
    monkeypatch.setenv("OAMIX_FORCE_OP", str(op))
    assert torch.equal(_port(tables, images, gts, cfg)["aug"], want["aug"])
    with pytest.raises(ValueError, match="force_op"):
        _port(tables, images, gts, cfg, force_op=15)


def test_skip_knobs_match_jax(monkeypatch):
    """``OAMIX_SKIP_CHAIN`` and ``OAMIX_SKIP_MIX`` together: no op runs, the
    chain's result is ``img * 1.0000001`` and only the global mix is left."""
    tables, images, gts, cfg = _one(6)
    env = {"OAMIX_SKIP_CHAIN": "1", "OAMIX_SKIP_MIX": "1", "OAMIX_GEO_PW": "force"}
    want = _jax_oamix(tables[0], images[0], gts[0], cfg, env)
    monkeypatch.setattr(od, "_aug_once", lambda *a, **k: pytest.fail("the chain ran"))
    got = _port(tables, images, gts, cfg, skip_chain=True, skip_mix=True)
    d = _diff(got["aug"][0, 0], want["aug"][0])
    assert d.max() <= 1 and float(np.mean(d == 0)) >= 0.998
    img = torch.from_numpy(images[0]).int()
    assert (got["aug"][0, 0].int() - img).abs().max() <= 1
    for k in ("OAMIX_SKIP_CHAIN", "OAMIX_SKIP_MIX"):
        monkeypatch.setenv(k, "1")
    assert torch.equal(_port(tables, images, gts, cfg)["aug"], got["aug"])


def test_skip_knobs_apart():
    """``skip_chain`` alone keeps the object-aware regions, ``skip_mix``
    alone keeps the chain."""
    tables, images, gts, cfg = _one(6)
    full = _port(tables, images, gts, cfg)["aug"]
    no_chain = _port(tables, images, gts, cfg, skip_chain=True)["aug"]
    no_mix = _port(tables, images, gts, cfg, skip_mix=True)["aug"]
    both = _port(tables, images, gts, cfg, skip_chain=True, skip_mix=True)["aug"]
    img = torch.from_numpy(images[0])[None, None].int()
    assert (no_chain.int() - img).abs().max() <= 1
    assert (no_mix.int() - img).abs().max() > 1
    assert not torch.equal(no_mix, full) and not torch.equal(no_mix, both)


def test_chain_and_route_defaults_come_from_the_environment(monkeypatch):
    tables, images, gts, cfg = _one(7)
    merged = _port(tables, images, gts, cfg, chain="merged")
    shifts = _count_calls(monkeypatch, od, "merged_shift_rows")
    monkeypatch.setenv("OAMIX_CHAIN", "merged")
    assert torch.equal(_port(tables, images, gts, cfg)["aug"], merged["aug"]) and shifts
    del shifts[:]
    _port(tables, images, gts, cfg, chain="slots")         # the argument wins
    assert not shifts
    monkeypatch.setenv("OAMIX_CHAIN", "slots")
    gathers = _count_calls(monkeypatch, od, "_apply_geo_bboxes_only")
    _port(tables, images, gts, cfg)
    assert not gathers
    monkeypatch.setenv("OAMIX_GEO_PW", "0")
    _port(tables, images, gts, cfg)
    assert gathers
    n = len(gathers)
    _port(tables, images, gts, cfg, chain="merged")        # the merged chain ignores it
    assert len(gathers) == n
    with pytest.raises(ValueError, match="chain must be"):
        _port(tables, images, gts, cfg, chain="fused")


def test_preprocess_passes_the_chain_on(monkeypatch):
    images, gts, labels = _raw_batch(30)
    tables = [_table(30 + i, "augmix") for i in range(2)]
    seen = []
    real = preprocess_mod.oamix_batch
    monkeypatch.setattr(preprocess_mod, "oamix_batch",
                        lambda *a, **k: seen.append(k.get("chain")) or real(*a, **k))
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)
    for chain in ("merged", None):
        pre = make_oadg_preprocess(dict(CFG, version="augmix"), norm, chain=chain)
        out = pre(_torch_raw_batch(images, gts, labels), torch.Generator(), draws=_stack(tables))
        assert out["img"].shape == (4, 3, H, W)
    assert seen == ["merged", None]


# ---------------------------------------------------------- training step ----

@pytest.fixture(scope="module")
def merged_train_run():
    mp = pytest.MonkeyPatch()
    mp.setenv("OAMIX_GEO_PW", "force")
    try:
        return run_train_step(chain="merged")
    finally:
        mp.undo()


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_train_step_on_the_merged_chain_matches_jax(merged_train_run, key):
    jlog, log = merged_train_run
    np.testing.assert_allclose(log[key], jlog[key], rtol=1e-3)
    if key == "loss_cont":
        assert log[key] > 0
