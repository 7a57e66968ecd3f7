"""The port's OA-Mix ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages; JAX runs the paths it
takes on the CPU (``fg_maps_xla``, ``shear_rows_xla`` through the jitted
``shear_rows_v3``, the CPU branch of ``piecewise_shift_rows``, the CPU
branch of ``hist256``).

Tolerances:
- photometric ops, histograms and foreground maps: bit-equal (integer
  arithmetic, or the same float32 operations in the same order);
  autocontrast is held to the jitted JAX op, whose multiply-subtract XLA
  rounds once as in the jitted OA-Mix chain (op by op JAX rounds twice);
- warps: float32 within 1e-4 intensity (values up to 255; the port rounds
  each lerp as XLA compiles it, one fused multiply-add, so they agree to
  the bit in practice);
- saliency scores: within 0.05 (the FFT and the bilinear crop sum in other
  orders; the score is a mean of 4096 floored values), and the OA-Mix gate
  ``score <= 10`` agrees on every box away from it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.ops import photometric as jphoto
from oadg_tpu.ops import pallas_warp as jwarp
from oadg_tpu.ops.pallas_fg import fg_maps_xla
from oadg_tpu.ops.pallas_hist import hist256 as jax_hist256
from oadg_tpu.ops.saliency import saliency_score as jax_saliency_score
from oadg_tpu_torch.ops import photometric as photo
from oadg_tpu_torch.ops import warp
from oadg_tpu_torch.ops.fg_maps import FG_MAPS, fg_maps
from oadg_tpu_torch.ops.hist import HIST256, hist256, image_hist256
from oadg_tpu_torch.ops.saliency import saliency_score

H, W = 96, 128


def _image(seed=0, c=3):
    """Gradients, a flat block, a saturated block and noise: autocontrast
    and equalize see non-trivial histograms, blends see exact integers."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255 / W, yy * 255 / H, (xx + yy) * 255 / (H + W),
                     255 - xx * 255 / W][:c], -1)
    img = base + rng.randint(0, 40, (H, W, c))
    img[10:40, 20:70] = 200
    img[60:90, 90:120] = 255
    return np.floor(np.clip(img, 0, 255)).astype(np.float32)


PHOTO_OPS = [
    ("autocontrast", lambda m, x: m.autocontrast(x)),
    ("equalize", lambda m, x: m.equalize(x)),
    ("posterize1", lambda m, x: m.posterize(x, 1)),
    ("posterize4", lambda m, x: m.posterize(x, 4)),
    ("solarize", lambda m, x: m.solarize(x, 128)),
    ("solarize_all", lambda m, x: m.solarize(x, 0)),
    ("invert", lambda m, x: m.invert(x)),
    ("grayscale_l", lambda m, x: m.grayscale_l(x)),
    ("color", lambda m, x: m.enhance_color(x, np.float32(0.37))),
    ("color_up", lambda m, x: m.enhance_color(x, np.float32(1.81))),
    ("contrast", lambda m, x: m.enhance_contrast(x, np.float32(0.55))),
    ("contrast_up", lambda m, x: m.enhance_contrast(x, np.float32(1.33))),
    ("brightness", lambda m, x: m.enhance_brightness(x, np.float32(0.1))),
    ("brightness_up", lambda m, x: m.enhance_brightness(x, np.float32(1.9))),
    ("sharpness", lambda m, x: m.enhance_sharpness(x, np.float32(0.28))),
    ("sharpness_up", lambda m, x: m.enhance_sharpness(x, np.float32(1.64))),
]


@pytest.mark.parametrize("name,op", PHOTO_OPS, ids=[n for n, _ in PHOTO_OPS])
@pytest.mark.parametrize("flat", [False, True])
def test_photometric_op_is_bit_equal(name, op, flat):
    """Bit-equal to the JAX op; ``flat`` gives one channel a single value
    (autocontrast and equalize keep it as it is)."""
    img = _image(1)
    if flat:
        img[..., 2] = 77.0
    jop = jax.jit(lambda x: op(jphoto, x)) if name == "autocontrast" else \
        (lambda x: op(jphoto, x))
    want = np.asarray(jop(jnp.asarray(img)), np.float32)
    got = op(photo, torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got_u8 = op(photo, torch.from_numpy(img.astype(np.uint8)))
    np.testing.assert_array_equal(got_u8.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(7, 201), (0, 254), (30, 31)])
def test_autocontrast_rounds_as_the_compiled_chain(lo, hi):
    """A channel whose range is not the full 255 has a scale that is not 1:
    there the jitted JAX op (one rounding of ``i * scale - lo * scale``, as
    in the jitted chain) and the same op run primitive by primitive differ
    by one level on about a tenth of the values; the port follows the jitted
    one."""
    img = _image(3)
    img[..., 0] = np.clip(img[..., 0], lo, hi)
    want = np.asarray(jax.jit(jphoto.autocontrast)(jnp.asarray(img)), np.float32)
    got = photo.autocontrast(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[..., 0].min() == 0 and got[..., 0].max() == 255


def test_equalize_lut_matches_jax():
    rng = np.random.RandomState(2)
    hist = rng.randint(0, 50, (3, 256)).astype(np.int32)
    hist[1] = 0
    hist[1, 17] = 1000                             # one value: identity
    hist[2, :250] = 0                              # few values, large last bin
    want = np.asarray(jphoto.equalize_lut_from_hist(jnp.asarray(hist)))
    got = photo.equalize_lut_from_hist(torch.from_numpy(hist))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float_unclipped"])
def test_hist256_matches_jax(dtype):
    """``hist256`` counts values truncated to integers in [0, 255]; the CPU
    path launches no kernel."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (H, W)).astype(np.float32)
    if dtype == "float_unclipped":
        x = x + rng.uniform(-0.9, 0.9, x.shape).astype(np.float32)
        x[:3] = [-20.0], [300.0], [255.7]
    want = np.asarray(jax_hist256(jnp.asarray(x), interpret=True))
    t = torch.from_numpy(x.astype(np.uint8) if dtype == "uint8" else x)
    before = HIST256.launches
    got = hist256(t)
    assert got.dtype == torch.int32 and HIST256.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_image_hist256_counts_each_channel():
    img = _image(4)
    got = image_hist256(torch.from_numpy(img.astype(np.uint8)))
    want = np.stack([np.asarray(jax_hist256(jnp.asarray(img[..., c]), interpret=True))
                     for c in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)


def _profiles(seed, g=16, ties=True):
    rng = np.random.RandomState(seed)
    fx = rng.rand(g, W).astype(np.float32)
    fy = (rng.rand(g, H) * (rng.rand(g, 1) > 0.3)).astype(np.float32)
    fy[:, :5] *= 1e-6                              # rows below BID_EPS: sentinel
    if ties:
        fx[3], fy[3] = fx[5], fy[5]                # exact ties: lowest index
    return fx, fy


@pytest.mark.parametrize("seed", [0, 1])
def test_fg_maps_match_jax(seed):
    fx, fy = _profiles(seed)
    want = fg_maps_xla(jnp.asarray(fx), jnp.asarray(fy), H, W)
    before = FG_MAPS.launches
    best_id, cover, union = fg_maps(torch.from_numpy(fx), torch.from_numpy(fy), H, W)
    assert FG_MAPS.launches == before
    assert best_id.dtype == torch.int8 and cover.dtype == union.dtype == torch.bfloat16
    np.testing.assert_array_equal(best_id.numpy(), np.asarray(want[0]))
    assert (best_id == 16).any() and (best_id == 3).any() and not (best_id == 5).any()
    np.testing.assert_array_equal(cover.float().numpy(),
                                  np.asarray(want[1].astype(jnp.float32)))
    np.testing.assert_array_equal(union.float().numpy(),
                                  np.asarray(want[2].astype(jnp.float32)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-4)


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("c", [3, 4])
def test_shear_rows_matches_jax(axis, c):
    """B4's plain version against ``shear_rows_xla`` (through the jitted
    ``shear_rows_v3``); axis 0 against the JAX package's transposed pass.
    Shifts reach past the image on both sides."""
    rng = np.random.RandomState(5 + c)
    img = _image(c, c)
    n = H if axis == 1 else W
    shifts = rng.randint(-150, 151, n).astype(np.int32)
    fracs = rng.rand(n).astype(np.float32)
    fracs[:4] = 0.0
    ji = jnp.asarray(img) if axis == 1 else jnp.transpose(jnp.asarray(img), (1, 0, 2))
    want = jwarp.shear_rows_v3(ji, jnp.asarray(shifts), jnp.asarray(fracs), 150)
    want = want if axis == 1 else jnp.transpose(want, (1, 0, 2))
    got = warp.shear_rows(torch.from_numpy(img), torch.from_numpy(shifts),
                          torch.from_numpy(fracs), 150, axis=axis)
    assert got.dtype == torch.float32
    _close(got, want)
    got_u8 = warp.shear_rows(torch.from_numpy(img.astype(np.uint8)),
                             torch.from_numpy(shifts), torch.from_numpy(fracs), 150,
                             axis=axis)
    _close(got_u8, want)


def test_shear_rows_clamps_shifts():
    rng = np.random.RandomState(8)
    img = torch.from_numpy(_image(8))
    shifts = torch.from_numpy(rng.randint(-300, 301, H).astype(np.int32))
    fracs = torch.from_numpy(rng.rand(H).astype(np.float32))
    np.testing.assert_array_equal(warp.shear_rows(img, shifts, fracs, 40).numpy(),
                                  warp.shear_rows(img, shifts.clamp(-40, 40), fracs,
                                                  40).numpy())


WRAPPERS = [
    ("shear_x", lambda m, x, s: m.warp_shear_x(x, s, 0.0, 40.0, 30)),
    ("shear_y", lambda m, x, s: m.warp_shear_y(x, -s, 50.0, 0.0, 42)),
    ("translate_x", lambda m, x, s: m.warp_translate_x(x, np.float32(-17.0), 46)),
    ("translate_y", lambda m, x, s: m.warp_translate_y(x, np.float32(9.0), 36)),
    ("rotate", lambda m, x, s: m.warp_rotate(x, np.float32(0.52), 64.0, 48.0, 16, 36)),
    ("rotate_neg", lambda m, x, s: m.warp_rotate(x, np.float32(-0.3), 60.0, 40.0, 16, 36)),
]


@pytest.mark.parametrize("name,fn", WRAPPERS, ids=[n for n, _ in WRAPPERS])
def test_warp_wrappers_match_jax(name, fn):
    """The five wrappers on a 4-channel image (the bg ops' image + alpha)."""
    img = _image(9, 4)
    s = np.float32(0.23)
    want = fn(jwarp, jnp.asarray(img), jnp.float32(s))
    _close(fn(warp, torch.from_numpy(img), s), want)


@pytest.mark.parametrize("axis", [1, 0])
def test_piecewise_shift_rows_matches_jax(axis):
    """B5's plain version against the CPU branch of the JAX kernel
    (axis 0 through its transposes): box ids with the sentinel G, shifts
    past the clamp."""
    rng = np.random.RandomState(10 + axis)
    img = _image(10)
    g = 6
    bid = rng.randint(0, g + 1, (H, W)).astype(np.int8)          # g: sentinel
    n = H if axis == 1 else W
    shifts = (rng.randn(n, g) * 40).astype(np.float32)
    jb = jnp.asarray(bid.astype(np.int32))
    if axis == 1:
        want = jwarp.piecewise_shift_rows(jnp.asarray(img), jb, jnp.asarray(shifts), 50)
    else:
        want = jnp.transpose(jwarp.piecewise_shift_rows(
            jnp.transpose(jnp.asarray(img), (1, 0, 2)), jb.T, jnp.asarray(shifts), 50),
            (1, 0, 2))
    got = warp.piecewise_shift_rows(torch.from_numpy(img.astype(np.uint8)),
                                    torch.from_numpy(bid), torch.from_numpy(shifts), 50,
                                    axis=axis)
    _close(got, want)
    keep = bid == g
    np.testing.assert_array_equal(got.numpy()[keep], img[keep])


def test_saliency_score_matches_jax():
    img = _image(11)
    rng = np.random.RandomState(11)
    x1 = rng.uniform(0, W - 20, 12)
    y1 = rng.uniform(0, H - 20, 12)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 60, 12),
                      y1 + rng.uniform(2, 50, 12)], -1).astype(np.float32)
    boxes[0] = [0, 0, W, H]
    boxes[1] = [5, 5, 7, 40]                                     # too small: -1
    want = np.asarray(jax.vmap(lambda b: jax_saliency_score(jnp.asarray(img), b))(
        jnp.asarray(boxes)))
    got = saliency_score(torch.from_numpy(img), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    assert got[1] == -1.0
    away = np.abs(want - 10.0) > 0.05
    np.testing.assert_array_equal((got <= 10)[away], (want <= 10)[away])
