"""Port RoIAlign (oadg_tpu_torch/ops/roi_align.py) against the JAX package.

The port's plain version (what a CPU tensor runs, and what the CUDA kernel is
held to on the card) is compared with ``_roi_align_multilevel_impl`` and with
the TPU window kernel ``roi_fwd_window_pallas`` run in interpret mode through
``_roi_align_forward``, as ``tests/test_pallas_roi.py`` runs it. Rois cover
both window classes, an extreme-aspect violator, a box partly outside the
map, a tiny box and every level; one level set has levels smaller than the
TPU window.

Tolerances: rtol=1e-5, atol=1e-6 against the impl (tap indices and weights
agree bit for bit, only the sum order differs); rtol=1e-4, atol=1e-5
against the interpreted kernel, which reassociates the sum
(tests/test_pallas_roi.py holds the same limits).

The plain backward is held to ``jax.grad`` of the JAX op, both through its
XLA tap scatter and through the TPU backward kernel ``roi_bwd_window_pallas``
in interpret mode (``OADG_ROI_BWD=pallas``), on maps of at least 32x40 as
``tests/test_pallas_roi.py:49`` runs it, at rtol=1e-5, atol=2e-6; and to
torch autograd of the plain forward.

Each comparison runs at the box head's 7x7 bins and at the mask head's
14x14 (the TPU kernels take any ``out``; the CUDA kernels take these two);
a case's id is its old one at 7x7 and ends in ``-out14`` at 14x14. The tap
geometry (rows and weights of every sample's four taps) equals the jitted
JAX package's bit for bit at both: f32(1/7) and f32(1/14) are rounded
reciprocals, and both sides multiply by the same one.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.ops.roi_align import (_roi_align_forward,
                                    _roi_align_multilevel_impl,
                                    map_roi_levels as jax_map_roi_levels)
from oadg_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD, _CHUNK,
                                          _Pyramid, _geometry, _tap_extent,
                                          map_roi_levels, roi_align_multilevel,
                                          roi_align_multilevel_ref,
                                          roi_align_multilevel_ref_backward)

torch.set_num_threads(2)

# (batch, image h, image w, strides): image size / stride gives each level
LEVEL_SETS = {
    "two_levels": (2, 256, 384, (4, 8)),               # 64x96, 32x48
    "four_levels": (1, 256, 640, (4, 8, 16, 32)),      # down to 8x20
    "small_coarse": (1, 256, 384, (4, 32)),            # 64x96, 8x12
}
SPECIAL_ROIS = [
    [0, 10, 10, 40, 40],        # small window class
    [0, 4, 8, 150, 160],        # full window class
    [0, 0, 0, 370, 20],         # extreme aspect -> violator pass
    [0, -5, 3, 190, 120],       # partly outside the map
    [0, 100, 100, 108, 108],    # tiny
    [0, 20, 30, 20.5, 30],      # zero area
    [0, 0, 0, 250, 250],        # coarse level
    [0, 300, 200, 383, 255],    # beyond the right edge
]


def _inputs(name, n_random, seed=0):
    b, h, w, strides = LEVEL_SETS[name]
    rng = np.random.RandomState(seed)
    feats = [rng.rand(b, h // s, w // s, 8).astype(np.float32) for s in strides]
    bw = np.exp(rng.uniform(np.log(2), np.log(600), n_random))
    bh = np.exp(rng.uniform(np.log(2), np.log(600), n_random))
    cx, cy = rng.uniform(-20, w + 20, n_random), rng.uniform(-20, h + 20, n_random)
    rand = np.stack([rng.randint(0, b, n_random), cx - bw / 2, cy - bh / 2,
                     cx + bw / 2, cy + bh / 2], 1)
    special = np.asarray(SPECIAL_ROIS, np.float64)
    special[:, 0] = np.arange(len(special)) % b
    rois = np.concatenate([special, rand]).astype(np.float32)
    return feats, rois, strides


def _port(feats, rois, strides, out=7):
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    res = roi_align_multilevel(tf, torch.from_numpy(rois), out, strides, 2, 56)
    return res.numpy().transpose(0, 2, 3, 1)            # -> (R, out, out, C)


def _with_out(cases):
    """Each case at 7x7 bins (its old id) and at 14x14 (id ``...-out14``)."""
    return [pytest.param(*c, 7, id=cid) for c, cid in cases] + [
        pytest.param(*c, 14, id=f"{cid}-out14") for c, cid in cases]


LEVEL_CASES = _with_out([((name,), name) for name in sorted(LEVEL_SETS)])


@pytest.mark.parametrize("name,out", LEVEL_CASES)
def test_roi_align_matches_jax_impl(name, out):
    feats, rois, strides = _inputs(name, 120)
    want = _roi_align_multilevel_impl(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), output_size=out,
        featmap_strides=strides, sampling_ratio=2, finest_scale=56, chunk=256)
    got = _port(feats, rois, strides, out)
    assert got.shape == want.shape == (len(rois), out, out, 8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,out", LEVEL_CASES)
def test_roi_align_matches_interpreted_tpu_kernel(name, out, monkeypatch):
    feats, rois, strides = _inputs(name, 8, seed=1)
    monkeypatch.setenv("OADG_ROI_FWD", "pallas")
    want = jax.jit(lambda fs: _roi_align_forward(
        fs, jnp.asarray(rois), out, strides, 2, 56, 256))(
        [jnp.asarray(f) for f in feats])
    got = _port(feats, rois, strides, out)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out", [7, 14])
def test_tap_geometry_equals_jitted_jax(out):
    """Every sample's four tap rows and weights at ``out`` x ``out`` bins
    equal the jitted JAX ``_ml_tap_geometry`` bit for bit, on the flagship's
    rois (edges, out of range, extreme aspect, tiny, zero, whole image)."""
    from oadg_tpu.ops.roi_align import _ml_tap_geometry
    rois, b, strides, shapes = _flagship_special_rois()
    pyr = _Pyramid(shapes, strides, "cpu")
    hs, ws, off = (t.numpy() for t in (pyr.hs, pyr.ws, pyr.level_off))
    want = jax.jit(lambda r: _ml_tap_geometry(r, out, strides, 56, 2, hs, ws, off, b))(
        jnp.asarray(rois))
    g = _geometry(pyr, torch.from_numpy(rois), out, 2, 56)
    okf = g.ok.float()
    got = ((g.rows(g.y0, g.x0), okf * (1 - g.wy) * (1 - g.wx)),
           (g.rows(g.y0, g.x1), okf * (1 - g.wy) * g.wx),
           (g.rows(g.y1, g.x0), okf * g.wy * (1 - g.wx)),
           (g.rows(g.y1, g.x1), okf * g.wy * g.wx))
    for (gr, gw), (wr, ww) in zip(got, want):
        assert gr.shape == (len(rois), 2 * out, 2 * out)
        ok = g.ok.numpy()
        np.testing.assert_array_equal(gr.numpy()[ok], np.asarray(wr)[ok])
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


def test_map_roi_levels_equal():
    rng = np.random.RandomState(2)
    side = np.exp(rng.uniform(np.log(1), np.log(2000), (4000, 2)))
    x1 = rng.uniform(0, 100, 4000)
    rois = np.stack([np.zeros(4000), x1, x1, x1 + side[:, 0], x1 + side[:, 1]],
                    1).astype(np.float32)
    # boxes whose sqrt(area) / 56 sits on a level boundary
    edge = np.array([[0, 0, 0, 56, 56], [0, 0, 0, 112, 112], [0, 0, 0, 224, 224],
                     [0, 0, 0, 448, 448], [0, 5, 5, 5, 5]], np.float32)
    rois = np.concatenate([rois, edge])
    want = np.asarray(jax.jit(lambda r: jax_map_roi_levels(r, 4, 56))(
        jnp.asarray(rois)))
    got = map_roi_levels(torch.from_numpy(rois), 4, 56).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}


def test_cpu_tensors_take_the_plain_version():
    feats, rois, strides = _inputs("two_levels", 4)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    before = ROI_ALIGN_FWD.launches
    a = roi_align_multilevel(tf, torch.from_numpy(rois), 7, strides, 2, 56)
    b = roi_align_multilevel_ref(tf, torch.from_numpy(rois), 7, strides, 2, 56)
    assert ROI_ALIGN_FWD.launches == before
    assert a.shape == (len(rois), 8, 7, 7) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    feats, rois, strides = _inputs("two_levels", 4)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with pytest.raises(ValueError, match="CUDA"):
        ROI_ALIGN_FWD(tf, torch.from_numpy(rois), 7, strides, 2, 56)


def _grad_inputs(name, seed, out=7):
    feats, rois, strides = _inputs(name, 40, seed=seed)
    dy = np.random.RandomState(seed + 10).randn(len(rois), 8, out, out).astype(np.float32)
    return feats, rois, strides, dy


# the TPU window kernel needs levels of at least 32x40: two_levels only
@pytest.mark.parametrize("name,mode,out", _with_out([
    (("two_levels", "xla"), "two_levels-xla"), (("two_levels", "pallas"), "two_levels-pallas"),
    (("four_levels", "xla"), "four_levels-xla")]))
def test_plain_backward_matches_jax_grad(name, mode, out, monkeypatch):
    feats, rois, strides, dy = _grad_inputs(name, 3, out)
    monkeypatch.setenv("OADG_ROI_BWD", mode)
    monkeypatch.setenv("OADG_ROI_FWD", "impl")
    g_nhwc = jnp.asarray(dy.transpose(0, 2, 3, 1))
    # jitted, as the train step runs it: XLA then rounds the tap geometry
    # with fused multiply-adds, as the port does
    want = jax.jit(jax.grad(lambda fs: jnp.sum(jax_roi_align_multilevel(
        fs, jnp.asarray(rois), out, strides, 2, 56) * g_nhwc)))(
        [jnp.asarray(f) for f in feats])
    got = roi_align_multilevel_ref_backward(
        torch.from_numpy(dy), [(f.shape[0], f.shape[3], f.shape[1], f.shape[2])
                               for f in feats], torch.from_numpy(rois), out, strides, 2, 56)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   rtol=1e-5, atol=2e-6)
    assert sum(float(np.abs(np.asarray(w)).max() > 0) for w in want) >= 2


def test_plain_backward_matches_autograd_of_plain_forward():
    feats, rois, strides, dy = _grad_inputs("four_levels", 4)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True) for f in feats]
    troi = torch.from_numpy(rois).requires_grad_(True)
    (roi_align_multilevel_ref(tf, troi, 7, strides, 2, 56)
     * torch.from_numpy(dy)).sum().backward()
    got = roi_align_multilevel_ref_backward(torch.from_numpy(dy),
                                            [f.shape for f in tf], troi.detach(),
                                            7, strides, 2, 56)
    for g, f in zip(got, tf):
        torch.testing.assert_close(g, f.grad, rtol=1e-5, atol=2e-6)


def test_op_gradient_reaches_maps_not_rois():
    feats, rois, strides, dy = _grad_inputs("two_levels", 5)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True) for f in feats]
    troi = torch.from_numpy(rois).requires_grad_(True)
    before = ROI_ALIGN_BWD.launches
    out = roi_align_multilevel(tf, troi, 7, strides, 2, 56)
    (out * torch.from_numpy(dy)).sum().backward()
    assert ROI_ALIGN_BWD.launches == before            # CPU: the plain version
    assert troi.grad is None
    want = roi_align_multilevel_ref_backward(torch.from_numpy(dy),
                                             [f.shape for f in tf], troi.detach(),
                                             7, strides, 2, 56)
    for f, w in zip(tf, want):
        torch.testing.assert_close(f.grad, w, rtol=0, atol=0)
    bf = [f.detach().bfloat16().requires_grad_(True) for f in tf]
    roi_align_multilevel(bf, troi, 7, strides, 2, 56).sum().backward()
    assert all(f.grad.dtype == torch.bfloat16 for f in bf)


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    feats, rois, strides, dy = _grad_inputs("two_levels", 6)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    with pytest.raises(ValueError, match="CUDA"):
        ROI_ALIGN_BWD(tf, torch.from_numpy(rois), torch.from_numpy(dy), 7, strides, 2, 56)


def _flagship_special_rois():
    """``chip_smoke.flagship_rois``'s rois on 4 images of 1024x2048: its
    edge, out-of-range, extreme-aspect, tiny and zero boxes among ordinary
    ones, plus boxes over the whole image (level 3) and one wholly outside."""
    import chip_smoke
    rng = np.random.RandomState(7)
    rois = np.concatenate([chip_smoke.flagship_rois(rng, 500, b) for b in range(4)])
    whole = np.array([[3, 0, 0, 2048, 1024], [1, -100, -60, 2200, 1100],
                      [2, -300, -300, -200, -250]], np.float32)
    return np.concatenate([rois, whole]), 4, (4, 8, 16, 32), [(4, 4, 1024 // s, 2048 // s)
                                                             for s in (4, 8, 16, 32)]


@pytest.mark.parametrize("name,out", _with_out([((n,), n) for n in sorted(LEVEL_SETS)
                                                + ["flagship"]]))
def test_tap_extent_holds_every_in_range_tap(name, out):
    """Every in-range tap of ``_geometry`` lies inside ``_tap_extent`` (the
    plain twin of the rectangle by which the backward kernel bins rois into
    tiles): a tap outside it would lose its gradient. The extent is tight:
    its corners are taps."""
    if name == "flagship":
        rois, _, strides, shapes = _flagship_special_rois()
    else:
        feats, rois, strides = _inputs(name, 400, seed=8)
        shapes = [(f.shape[0], f.shape[3], f.shape[1], f.shape[2]) for f in feats]
    rois = torch.from_numpy(rois)
    pyr = _Pyramid(shapes, strides, "cpu")
    empty = 0
    for i in range(0, rois.shape[0], _CHUNK):
        rc = rois[i:i + _CHUNK]
        g = _geometry(pyr, rc, out, 2, 56)
        ext = _tap_extent(pyr, rc, out, 2, 56)
        lvl = map_roi_levels(rc, len(shapes), 56)
        ok = g.ok
        for yi in (g.y0, g.y1):
            inside = (yi >= ext[:, :1]) & (yi <= ext[:, 1:2])         # (Rc, S)
            assert bool((inside[:, :, None] | ~ok).all())
        for xi in (g.x0, g.x1):
            inside = (xi >= ext[:, 2:3]) & (xi <= ext[:, 3:4])
            assert bool((inside[:, None, :] | ~ok).all())
        has = ok.any(2).any(1)
        assert bool(((ext[:, 0] <= ext[:, 1]) & (ext[:, 2] <= ext[:, 3]) == has).all())
        empty += int((~has).sum())
        taps_y = torch.cat([g.y0, g.y1], 1).masked_fill(~torch.cat([ok.any(2)] * 2, 1), -1)
        taps_x = torch.cat([g.x0, g.x1], 1).masked_fill(~torch.cat([ok.any(1)] * 2, 1), -1)
        assert torch.equal(taps_y.amax(1)[has], ext[has, 1])
        assert torch.equal(taps_x.amax(1)[has], ext[has, 3])
        big = taps_y.masked_fill(taps_y < 0, 1 << 30).amin(1)
        assert torch.equal(big[has], ext[has, 0])
        h = pyr.hs[lvl]
        assert bool((ext[has, 1] < h[has]).all() and (ext[has, 0] >= 0).all())
    assert empty > 0
