"""Seeded inputs for the shape grid of the per-box row-shift warps (kernels
B5 and B7 of ``oadg_tpu_torch/ops/csrc/shift_rows.cu``).

The grid is what the kernels' fast route splits on: widths that are and are
not multiples of 4, C = 1, 3, 4, uint8 and float32, both axes; every case
holds box edges that fall inside a group of 4 pixels and on its borders,
ids that change from pixel to pixel, the sentinel, shifts whose fraction is
exactly 0, zero shifts, shifts beyond the image and shifts past B5's clamp.

The CPU tests hold the plain versions to the JAX functions on this grid
(``test_torch_warp_shapes.py``); the card tests hold the kernels to the
plain versions on the same grid (``test_torch_cuda.py``). numpy only: the
machine with the card has no JAX.
"""
import itertools

import numpy as np

H = 24
WIDTHS = (64, 61)
G = 6
MAX_SHIFT = 100.0            # B5's clamp
GRID = [(kind, c, axis, w) for kind, c, axis, w in
        itertools.product(("u8", "f32"), (1, 3, 4), (1, 0), WIDTHS)]


def grid_id(case):
    kind, c, axis, w = case
    return f"{kind}-c{c}-axis{axis}-w{w}"


def image(seed, w, c, kind):
    """(H, w, c) image: uint8, or float32 with fractional values up to 255.5."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (H, w, c))
    if kind == "u8":
        return img.astype(np.uint8)
    return (img + rng.rand(H, w, c) * 0.5).astype(np.float32)


def box_ids(seed, w, n_ids):
    """(H, w) int8 ids in [0, n_ids], ``n_ids`` being the sentinel: a
    sentinel background, rectangles whose edges fall inside groups of 4
    pixels (x = 5, 23, 18, 41), on their borders (40, 52) and on the image's
    borders, and rows whose ids change from pixel to pixel."""
    rng = np.random.RandomState(seed)
    ids = np.full((H, w), n_ids, np.int64)
    ids[2:10, 5:23] = 0
    ids[6:16, 18:41] = 1
    ids[12:20, 40:52] = 2
    ids[3:9, w - 7:w] = 3
    ids[H - 5:H, 0:9] = 4
    ids[16:22, 28:36] = n_ids - 1
    ids[10:12, :] = rng.randint(0, n_ids + 1, (2, w))
    ids[20:22, 8:24] = rng.randint(0, n_ids, (2, 16))
    return ids.astype(np.int8)


def shift_table(seed, n, cols, extent):
    """(n, cols) float32 shifts, ``cols`` a multiple of ``G``; per group of
    ``G`` columns: 0 whole numbers (a fraction of exactly 0), 1 zeros, 2
    beyond an image of ``extent`` pixels on either side, 3 mostly past
    +-``MAX_SHIFT``, 4 a shear's slope of 0.58, 5 a few pixels."""
    rng = np.random.RandomState(seed)
    t = rng.randn(n, cols) * 6.0
    for k in range(0, cols, G):
        t[:, k] = np.floor(t[:, k])
        t[:, k + 1] = 0.0
        t[:, k + 2] = rng.choice([-3.0, 3.0], n) * extent + rng.randn(n)
        t[:, k + 3] *= 40.0
        t[:, k + 4] = 0.58 * (np.arange(n) - n / 2.0)
    return t.astype(np.float32)


def piecewise_case(case, seed=0):
    """B5's inputs for one grid case: image, ids (H, w) with sentinel ``G``,
    shifts (keys, G)."""
    kind, c, axis, w = case
    n, extent = (H, w) if axis == 1 else (w, H)
    return (image(seed, w, c, kind), box_ids(seed + 1, w, G),
            shift_table(seed + 2, n, G, extent))


def merged_case(case, slots, seed=0):
    """B7's inputs for one grid case and ``slots`` slots: image, composite
    ids (H, w) with sentinel ``slots * G``, ``p_bb`` (keys, slots * G) and
    ``p_sl`` (keys, slots). No clamp in B7: the shifts of column 3 reach far
    beyond the image."""
    kind, c, axis, w = case
    n, extent = (H, w) if axis == 1 else (w, H)
    rng = np.random.RandomState(seed + 3)
    p_sl = (rng.randn(n, slots) * 5.0).astype(np.float32)
    return (image(seed, w, c, kind), box_ids(seed + 1, w, slots * G),
            shift_table(seed + 2, n, slots * G, extent), p_sl)
