"""``merged_shift_rows`` (kernel B7's plain version) against the JAX package
on the CPU.

The JAX side is ``jax.jit`` of ``pallas_warp.merged_shift_rows``, whose CPU
branch is a per-pixel gather with the lerp ``a * (1 - f) + b * f``; for
``axis=0`` it runs on the transposed image, ids and output, as the JAX
package's merged chain calls it. Inputs come from numpy seeds.

Tolerance: max abs error <= 1e-4 on values up to 255. The port rounds the
lerp as XLA compiles it (one fused multiply-add over the rounded second
product), emulated in float64, which differs from one rounding only where
the float64 sum ties in float32 (one ulp, 1.5e-5 at 255); in practice the
results are equal. Pixels whose shift is zero are exactly the source.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.ops import pallas_warp as jwarp
from oadg_tpu_torch.ops import warp

H, W = 48, 80
G = 16
_JAX = jax.jit(jwarp.merged_shift_rows)


def _image(seed, c, integer):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (H, W, c)).astype(np.float32)
    return img if integer else img + rng.rand(H, W, c).astype(np.float32) * 0.5


def _inputs(seed, s, axis, far=False):
    """Composite ids over every (slot, box) and the sentinel ``s * G``, and
    shift tables; ``far`` makes some shifts leave the image entirely."""
    rng = np.random.RandomState(seed)
    cid = rng.randint(0, s * G + 1, (H, W))
    cid[:6, :10] = s * G                                       # a sentinel block
    n = H if axis == 1 else W
    scale = 400.0 if far else 12.0
    p_bb = (rng.randn(n, s * G) * scale).astype(np.float32)
    p_sl = (rng.randn(n, s) * scale).astype(np.float32)
    p_bb[:, 3] = np.floor(p_bb[:, 3])                          # integer shifts: no lerp
    p_bb[:, 5] = 0.0
    return cid.astype(np.int32), p_bb, p_sl


def _jax(img, cid, p_bb, p_sl, is_bb, is_bg, axis):
    ji, jc = jnp.asarray(img), jnp.asarray(cid)
    if axis == 0:
        ji, jc = jnp.transpose(ji, (1, 0, 2)), jc.T
    out = _JAX(ji, jc, jnp.asarray(p_bb), jnp.asarray(p_sl), jnp.asarray(is_bb),
               jnp.asarray(is_bg))
    return np.asarray(out if axis == 1 else jnp.transpose(out, (1, 0, 2)), np.float32)


def _port(img, cid, p_bb, p_sl, is_bb, is_bg, axis):
    before = warp.MERGED_SHIFT_ROWS.launches
    out = warp.merged_shift_rows(torch.from_numpy(img), torch.from_numpy(cid.astype(np.int8)),
                                 torch.from_numpy(p_bb), torch.from_numpy(p_sl), is_bb, is_bg,
                                 axis=axis)
    assert warp.MERGED_SHIFT_ROWS.launches == before           # a CPU tensor launches nothing
    assert out.dtype == torch.float32 and out.shape == img.shape
    return out.numpy()


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("flags", ["bb", "bg", "neither"])
@pytest.mark.parametrize("kind", ["f32x4", "u8x3"])
def test_merged_shift_rows_one_slot_matches_jax(kind, flags, axis):
    """S = 1, G = 16, as the merged chain calls it: the 4-channel float32
    image (rgb + alpha) and a 3-channel image of uint8 values (given to the
    port as uint8)."""
    c, integer = (4, False) if kind == "f32x4" else (3, True)
    img = _image(1, c, integer)
    cid, p_bb, p_sl = _inputs(2 + axis, 1, axis)
    is_bb, is_bg = np.array([flags == "bb"]), np.array([flags == "bg"])
    want = _jax(img, cid, p_bb, p_sl, is_bb, is_bg, axis)
    got = _port(img.astype(np.uint8) if integer else img, cid, p_bb, p_sl, is_bb, is_bg, axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if flags == "neither":
        np.testing.assert_array_equal(got, img)
    if flags == "bb":                                          # sentinel pixels stay
        np.testing.assert_array_equal(got[cid == G], img[cid == G])
        assert (got != img).any()
    if flags == "bg":                                          # sentinel pixels move too
        assert (got[cid == G] != img[cid == G]).any()


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("is_bb,is_bg", [
    ((True, False, False), (False, True, False)),
    ((False, False, True), (True, False, False)),
    ((False, True, False), (False, False, True)),
    ((True, True, True), (True, True, True)),                   # bb wins where both are set
], ids=["bb-bg-none", "bg-none-bb", "none-bb-bg", "all"])
def test_merged_shift_rows_three_slots_matches_jax(is_bb, is_bg, axis):
    """S = 3 with mixed flags. Sentinel pixels follow the LAST slot's
    background flag, as the JAX package's CPU branch sends them there
    (``min(cid // G, S - 1)``)."""
    img = _image(3, 4, False)
    cid, p_bb, p_sl = _inputs(5 + axis, 3, axis)
    want = _jax(img, cid, p_bb, p_sl, np.array(is_bb), np.array(is_bg), axis)
    got = _port(img, cid, p_bb, p_sl, list(is_bb), torch.tensor(is_bg), axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    sentinel = cid == 3 * G
    if is_bg[2]:
        assert (got[sentinel] != img[sentinel]).any()
    else:
        np.testing.assert_array_equal(got[sentinel], img[sentinel])


@pytest.mark.parametrize("axis", [1, 0])
def test_merged_shift_rows_shifts_leave_the_image(axis):
    """No clamp inside: shifts of several image widths read zeros."""
    img = _image(4, 3, True)
    cid, p_bb, p_sl = _inputs(7 + axis, 1, axis, far=True)
    want = _jax(img, cid, p_bb, p_sl, np.array([True]), np.array([False]), axis)
    got = _port(img, cid, p_bb, p_sl, [True], [False], axis)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got == 0).mean() > 0.5


def test_merged_shift_rows_flags_are_host_values():
    img = torch.from_numpy(_image(5, 3, True))
    cid, p_bb, p_sl = _inputs(9, 1, 1)
    with pytest.raises(ValueError, match="must hold 1 flags"):
        warp.merged_shift_rows(img, torch.from_numpy(cid), torch.from_numpy(p_bb),
                               torch.from_numpy(p_sl), [True, False], [False])
    with pytest.raises(ValueError, match="no path for device"):
        warp.merged_shift_rows(img.to("meta"), torch.from_numpy(cid), torch.from_numpy(p_bb),
                               torch.from_numpy(p_sl), [True], [False])
