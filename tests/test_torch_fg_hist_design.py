"""The index logic of the CUDA kernels B3 (foreground maps) and B6 (equalize
histogram), held on the CPU through their plain twins, and the plain
versions against the JAX package on the inputs those designs depend on.

- B3 culls boxes per tile: ``fg_maps._live_boxes`` is the twin of the
  kernel's test (a box is live in a tile where its fy is non-zero on one of
  the tile's rows and its fx on one of its columns; the kernel's tile is 16
  rows x 256 columns, and it culls again per row and per lane's 8 pixels). Running the plain
  version tile by tile over the live boxes alone must give the plain
  version's maps over all boxes, bit for bit (a zero may only change sign):
  a culled box has m = 0 over the tile, so it multiplies the coverage
  product by exactly 1, never reaches BID_EPS and never raises the union.
  The inputs are ``chip_smoke.py``'s blurred, gated profiles at a small,
  ragged size.
- B6 splits the values into an unaligned head, 8-byte words and a tail;
  thread t of the grid reads words t, t + S, ... and gives byte j of each
  the channel (head + 8 (t % c) + j) % c, which holds because S is a
  multiple of 3: ``hist._hist_split`` and ``hist._hist_channels`` are the
  twins. Each value must land in channel ``i % c`` for every start offset
  0..15.
- ``fg_maps_ref`` against ``fg_maps_xla`` on the sparse blurred profiles,
  and ``hist256_ref`` against JAX's ``hist256`` (interpret mode, its CPU
  branch) on a flat and on a constant image: bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from oadg_tpu.ops.pallas_fg import fg_maps_xla
from oadg_tpu.ops.pallas_hist import hist256 as jax_hist256
from oadg_tpu_torch.ops import fg_maps as fgm
from oadg_tpu_torch.ops import hist

H, W = 60, 204           # ragged against every tile below


def _blurred(seed, h=H, w=W, g=16, right_empty=False):
    """The gated blurred profiles of ``g`` seeded gts as OA-Mix makes them
    for B3 (``chip_smoke.fg_inputs``), (g, W) and (g, H)."""
    rng = np.random.RandomState(seed)
    gt = chip_smoke.seeded_gts(rng, 1, h, w)[0][0]
    if right_empty:                  # boxes in the top-left ninth: empty tiles elsewhere
        gt[:, [0, 2]] = np.minimum(gt[:, [0, 2]], w / 3)
        gt[:, [1, 3]] = np.minimum(gt[:, [1, 3]], h / 3)
    fx, fy = chip_smoke.fg_inputs(torch.from_numpy(gt), h, w)
    return fx[:g].contiguous(), fy[:g].contiguous()


def _culled_maps(fx, fy, tile_h, tile_w):
    """The plain version run tile by tile over each tile's live boxes only;
    a tile with none gets (G, 0, 0)."""
    g, w = fx.shape
    h = fy.shape[1]
    live = fgm._live_boxes(fx, fy, tile_h, tile_w)
    best_id = torch.full((h, w), g, dtype=torch.int8)
    cover = torch.zeros((h, w), dtype=torch.bfloat16)
    union = torch.zeros((h, w), dtype=torch.bfloat16)
    for ty in range(live.shape[0]):
        ys = slice(ty * tile_h, min(h, (ty + 1) * tile_h))
        for tx in range(live.shape[1]):
            idx = live[ty, tx].nonzero()[:, 0]
            if idx.numel() == 0:
                continue
            xs = slice(tx * tile_w, min(w, (tx + 1) * tile_w))
            b, c, u = fgm.fg_maps_ref(fx[idx][:, xs], fy[idx][:, ys],
                                      ys.stop - ys.start, xs.stop - xs.start)
            k = idx.numel()
            best_id[ys, xs] = torch.where(b.long() < k, idx[b.long().clamp(max=k - 1)],
                                          torch.full_like(b.long(), g)).to(torch.int8)
            cover[ys, xs], union[ys, xs] = c, u
    return live, (best_id, cover, union)


def _assert_same_maps(got, want):
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.float(), b.float())         # -0 == +0


def _case(name):
    if name == "blurred G=16":
        return _blurred(0)
    if name == "blurred G=16, empty tiles":
        return _blurred(1, right_empty=True)
    if name == "G=1":
        return _blurred(2, g=1)
    if name == "gated boxes":
        fx, fy = _blurred(3)
        fy[[1, 4, 9]] = 0.0                               # invalid or small gts
        return fx, fy
    if name == "exact ties":
        fx, fy = _blurred(4)
        fx[7], fy[7] = fx[2], fy[2]
        fx[12], fy[12] = fx[2], fy[2]
        return fx, fy
    raise KeyError(name)


CASES = ["blurred G=16", "blurred G=16, empty tiles", "G=1", "gated boxes", "exact ties"]
TILES = [(1, 8), (1, 256), (16, 256), (7, 48)]      # a lane, a row, the kernel's tile; odd


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("name", CASES)
def test_live_boxes_culling_is_exact(name, tile):
    fx, fy = _case(name)
    want = fgm.fg_maps_ref(fx, fy, H, W)
    live, got = _culled_maps(fx, fy, *tile)
    _assert_same_maps(got, want)
    n_tiles = live.shape[0] * live.shape[1]
    assert live.shape == (-(-H // tile[0]), -(-W // tile[1]), fx.shape[0])
    # culling skips work: fewer live (tile, box) pairs than all of them
    assert int(live.sum()) < n_tiles * fx.shape[0] or name == "G=1"
    if name == "blurred G=16, empty tiles":
        assert bool((~live.any(-1)).any())                # a tile with no live box
        assert bool((want[0] == fx.shape[0]).any())       # ... writes the sentinel
    if name == "exact ties":
        assert not bool((want[0] == 7).any()) and not bool((want[0] == 12).any())
        assert bool((want[0] == 2).any())


def test_live_boxes_is_the_kernels_set():
    """The boxes a lane of the kernel computes: a row loops over the boxes
    whose fy is non-zero on it and whose fx is non-zero on the 16 x 256
    tile, ``_live_boxes(fx, fy, 1, 256)``, and the lane skips those whose 8
    fx values are 0; what is left is ``_live_boxes(fx, fy, 1, 8)``, a subset
    of the row's and of the tile's lists."""
    fx, fy = _case("gated boxes")
    g = fx.shape[0]
    lane = fgm._live_boxes(fx, fy, 1, 8)
    fx_pad = torch.zeros((g, -(-W // 8) * 8))
    fx_pad[:, :W] = fx
    want = (fy.T[:, None, :] != 0) & (fx_pad.reshape(g, -1, 8) != 0).any(2).T[None]
    assert torch.equal(lane, want)
    row = fgm._live_boxes(fx, fy, 1, 256)
    tile = fgm._live_boxes(fx, fy, 16, 256)
    cols = torch.arange(lane.shape[1]) * 8 // 256
    assert not bool((lane & ~row[:, cols]).any())
    assert not bool((row & ~tile[torch.arange(H) // 16]).any())
    assert int(lane.sum()) < int(row.sum()) * (256 // 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_fg_maps_ref_matches_jax_on_blurred_profiles(seed):
    fx, fy = _blurred(seed + 10)
    assert float((fx * 0 == 0).float().mean()) == 1.0 and float((fx == 0).float().mean()) > 0.2
    want = fg_maps_xla(jnp.asarray(fx.numpy()), jnp.asarray(fy.numpy()), H, W)
    got = fgm.fg_maps_ref(fx, fy, H, W)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_hist_channel_map(c, offset):
    """Head, 8-byte words and tail: on a grid whose thread count is a
    multiple of 3 (the kernel's), every value is counted in channel i % c,
    and counting by the twin's channels reproduces ``hist256_ref``. Grids of
    6 and 96 threads make the words wrap around the grid at these sizes, as
    132 x 1024 threads do at 1024 x 2048 x 3."""
    rng = np.random.RandomState(16 * c + offset)
    for n in (0, c, 5 * c, 16 * c, 47 * c, 49 * c, 1000 * c):
        head, words, tail = hist._hist_split(offset, n)
        assert 0 <= tail < 8 and head == min(n, (-offset) % 16)
        assert head + 8 * words + tail == n
        x = torch.from_numpy(rng.randint(0, 256, n).astype(np.uint8))
        for threads in (6, 96, 132 * 1024):
            channels = hist._hist_channels(offset, n, c, threads)
            assert torch.equal(channels, torch.arange(n) % c)
            counts = torch.zeros(c * 256, dtype=torch.int64)
            counts.index_add_(0, channels * 256 + x.long(), torch.ones(n, dtype=torch.int64))
            assert torch.equal(counts.reshape(c, 256).to(torch.int32), hist.hist256_ref(x, c))
    if c == 3:      # a grid of 4 threads: 8 x 4 is no multiple of 3, words past it go astray
        n = 300
        assert not torch.equal(hist._hist_channels(offset, n, c, 4), torch.arange(n) % c)


@pytest.mark.parametrize("kind", ["flat", "constant"])
def test_hist256_ref_matches_jax(kind):
    if kind == "flat":
        img = chip_smoke.chain_like_image(np.random.RandomState(5), 128, 192)
    else:
        img = np.broadcast_to(np.array([17, 200, 93], np.uint8), (64, 96, 3)).copy()
    got = hist.hist256_ref(torch.from_numpy(img), 3)
    want = np.stack([np.asarray(jax_hist256(jnp.asarray(img[..., k]), interpret=True))
                     for k in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got > 0).sum()) == (3 if kind == "constant" else int(
        sum(len(np.unique(img[..., k])) for k in range(3))))
