"""The plain versions of the per-box row-shift warps (kernels B5 and B7)
against the JAX package on the CPU, over the shape grid that the CUDA
kernels' fast route splits on (``torch_warp_cases.py``): widths that are and
are not multiples of 4, C = 1, 3, 4, uint8 and float32, both axes, box edges
inside a group of 4 pixels, shifts beyond the image, fractions of exactly 0.
The card tests (``test_torch_cuda.py``) hold the kernels to these plain
versions on the same grid.

The JAX side is the CPU branch of ``pallas_warp.piecewise_shift_rows``
(``:662-675``) and of ``pallas_warp.merged_shift_rows`` (``:580-601``), both
per-pixel gathers; for ``axis=0`` they run on the transposed image and ids,
as the JAX package calls them. JAX takes the uint8 images as float32, the
port as uint8.

Tolerance: max abs error <= 1e-4 on values up to 255.5. The port rounds the
lerp as XLA compiles it (one fused multiply-add over the rounded second
product), emulated in float64, which differs from one rounding only where
the float64 sum ties in float32 (one ulp, 1.5e-5 at 255).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.ops import pallas_warp as jwarp
from oadg_tpu_torch.ops import warp

import torch_warp_cases as cases

_JAX_MERGED = jax.jit(jwarp.merged_shift_rows)
FLAGS = {"bb": ([True], [False]), "bg": ([False], [True]),
         "mixed3": ([True, False, False], [False, True, True])}


def _on_axis(fn, img, ids, axis):
    """The JAX function on (img, ids), through transposes for ``axis=0``."""
    ji, jd = jnp.asarray(img, jnp.float32), jnp.asarray(ids.astype(np.int32))
    if axis == 0:
        ji, jd = jnp.transpose(ji, (1, 0, 2)), jd.T
    out = fn(ji, jd)
    return np.asarray(out if axis == 1 else jnp.transpose(out, (1, 0, 2)), np.float32)


@pytest.mark.parametrize("case", cases.GRID, ids=cases.grid_id)
def test_piecewise_shift_rows_grid_matches_jax(case):
    kind, c, axis, w = case
    img, ids, shifts = cases.piecewise_case(case)
    want = _on_axis(lambda i, d: jwarp.piecewise_shift_rows(
        i, d, jnp.asarray(shifts), int(cases.MAX_SHIFT)), img, ids, axis)
    before = warp.PIECEWISE_SHIFT_ROWS.launches
    got = warp.piecewise_shift_rows(torch.from_numpy(img), torch.from_numpy(ids),
                                    torch.from_numpy(shifts), cases.MAX_SHIFT, axis=axis)
    assert warp.PIECEWISE_SHIFT_ROWS.launches == before       # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    keep = ids == cases.G                                     # the sentinel keeps the source
    np.testing.assert_array_equal(got.numpy()[keep], img.astype(np.float32)[keep])
    still = ids == 1                                          # zero shifts too
    np.testing.assert_array_equal(got.numpy()[still], img.astype(np.float32)[still])
    assert (got.numpy()[ids == 2] == 0).all()                 # read beyond the image


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("case", cases.GRID, ids=cases.grid_id)
def test_merged_shift_rows_grid_matches_jax(case, flags):
    kind, c, axis, w = case
    is_bb, is_bg = FLAGS[flags]
    slots = len(is_bb)
    img, ids, p_bb, p_sl = cases.merged_case(case, slots)
    want = _on_axis(lambda i, d: _JAX_MERGED(
        i, d, jnp.asarray(p_bb), jnp.asarray(p_sl), jnp.asarray(is_bb), jnp.asarray(is_bg)),
        img, ids, axis)
    before = warp.MERGED_SHIFT_ROWS.launches
    got = warp.merged_shift_rows(torch.from_numpy(img), torch.from_numpy(ids),
                                 torch.from_numpy(p_bb), torch.from_numpy(p_sl), is_bb, is_bg,
                                 axis=axis)
    assert warp.MERGED_SHIFT_ROWS.launches == before
    assert got.dtype == torch.float32 and got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    if flags == "bb":                                         # sentinel and zero shifts stay
        for k in (slots * cases.G, 1):
            np.testing.assert_array_equal(got.numpy()[ids == k],
                                          img.astype(np.float32)[ids == k])
        assert (got.numpy()[ids == 2] == 0).all()


def test_grid_cases_hold_what_the_fast_route_splits_on():
    assert {w % 4 for w in cases.WIDTHS} == {0, 1}
    for w in cases.WIDTHS:
        ids = cases.box_ids(1, w, cases.G)
        quads = ids[:, :w // 4 * 4].reshape(cases.H, -1, 4)
        mixed = (quads != quads[..., :1]).any(-1)
        assert mixed.any() and (~mixed).any()                 # edges inside and outside quads
        assert (ids == cases.G).any() and set(range(cases.G)) <= set(ids.ravel().tolist())
        t = cases.shift_table(2, cases.H, cases.G, w)
        assert (t[:, 0] == np.floor(t[:, 0])).all() and (t[:, 1] == 0).all()
        assert (np.abs(t[:, 2]) > 2 * w).all() and (np.abs(t[:, 3]) > cases.MAX_SHIFT).any()


@pytest.mark.parametrize("flags", [[True], (False,), [True, False, True], np.array([0, 1]),
                                   torch.tensor([True, True])],
                         ids=["list", "tuple", "three", "numpy", "tensor"])
def test_flag_bits_match_the_flags(flags):
    """The wrapper's bit masks, with and without the numpy round trip."""
    n = len(flags)
    want = sum(1 << i for i in range(n) if bool(flags[i]))
    assert warp._flag_bits(flags, n, "is_bb") == want
    with pytest.raises(ValueError, match="must hold"):
        warp._flag_bits(flags, n + 1, "is_bb")


def test_as_keeps_a_tensor_that_needs_no_conversion():
    t = torch.zeros((4, 6), dtype=torch.float32)
    assert warp._as(t, torch.float32) is t
    assert warp._as(t.T, torch.float32).is_contiguous()
    assert warp._as(t, torch.int32).dtype == torch.int32
