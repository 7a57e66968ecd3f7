"""The parts of YOLOF, YOLOX-S, SSD300, SOLO and YOLACT in the port against
the JAX package, on the CPU, on seeded inputs:

- the box coder's centre clamp (YOLOF's ``add_ctr_clamp``) and its default
  path, against jitted JAX's decode;
- SSD300's anchors, bit-equal: 8,732 at 300x300;
- ``simota_assign`` on tied costs, exactly (stable ranks, least-cost
  conflicts, ``dynamic_k`` truncated);
- the heads' assignments read from JAX's jitted losses (a recording
  stand-in for a loss or a ``jnp`` call, ``jax.debug.callback``) against
  the port's, exactly: YOLOF's uniform matching (labels, class weights,
  positives, targets) and its candidates (the 5 anchors of the nearest
  cell, where mmdet's ``topk`` takes 4), YOLOX's SimOTA, SSD's positives
  and hard negatives (a tied block of negatives at the cut), SOLO's cells
  per level, YOLACT's labels, weights and 32 mask positives;
- ``mask_matrix_nms`` (gaussian and linear) and ``fast_nms`` with padded
  rows and tied scores: selections exact, scores rtol 1e-5;
- ``paste_crop_masks`` within 1e-6;
- the narrowed CSPDarknet with its PAFPN, and the DilatedEncoder, in train
  mode against jitted JAX (``mutable=['batch_stats']``): outputs and the
  moved running statistics within 1e-4 of each tensor's largest;
- the Focus stem's channel order: mmdet's ``Focus`` with mmdet's weights
  equals the port's stem after ``load_mmdet_checkpoint``;
- the SOLO stride fact: the JAX head's level-0 mask map sits at stride 2
  (P2 upsampled), and its cells are placed as if at stride 4, at half the
  true scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_onestage_cases as cases
from oadg_tpu.core.anchor import SSDAnchorGenerator as JSSDAnchors
from oadg_tpu.core.bbox.coder import DeltaXYWHBBoxCoder as JCoder
from oadg_tpu.core.post_processing import matrix_nms as jax_mnms
from oadg_tpu.models.backbones.csp_darknet import CSPDarknet as JCSPDarknet
from oadg_tpu.models.dense_heads import instance_seg_heads as jax_inst
from oadg_tpu.models.dense_heads import ssd_head as jax_ssd
from oadg_tpu.models.dense_heads import yolox_head as jax_yolox
from oadg_tpu.models.dense_heads.yolof_head import YOLOFHead as JYOLOFHead
from oadg_tpu.models.losses import common as jax_losses
from oadg_tpu.models.necks.extra_necks import DilatedEncoder as JDilatedEncoder
from oadg_tpu.models.necks.yolox_pafpn import YOLOXPAFPN as JPAFPN
from oadg_tpu_torch.core.anchor import SSDAnchorGenerator
from oadg_tpu_torch.core.bbox.coder import DeltaXYWHBBoxCoder
from oadg_tpu_torch.core.bbox.geometry import bbox_overlaps
from oadg_tpu_torch.core.post_processing import fast_nms, mask_matrix_nms
from oadg_tpu_torch.models.backbones.csp_darknet import CSPDarknet, focus_mmdet_order
from oadg_tpu_torch.models.dense_heads.instance_seg_heads import (SOLOHead, YOLACTHead,
                                                                  paste_crop_masks)
from oadg_tpu_torch.models.dense_heads.ssd_head import SSDHead
from oadg_tpu_torch.models.dense_heads.yolof_head import YOLOFHead
from oadg_tpu_torch.models.dense_heads.yolox_head import YOLOXHead, simota_assign
from oadg_tpu_torch.models.necks.extra_necks import DilatedEncoder
from oadg_tpu_torch.models.necks.yolox_pafpn import YOLOXPAFPN
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)
T = torch.from_numpy


def _np(x):
    return np.asarray(x)


def _per_image(fn, *args):
    """``fn`` on each image of the batched numpy ``args`` alone (a callback
    under the JAX heads' ``vmap`` runs per image, in no set order)."""
    for i in range(args[1].shape[0]):
        fn(*(jax.tree_util.tree_map(lambda a: a[i:i + 1], x) for x in args))
        jax.effects_barrier()


def _record(seen, kind, *vals):
    jax.debug.callback(lambda *a: seen.append((kind,) + tuple(np.asarray(v) for v in a)), *vals)


def _recording_call(monkeypatch, cls, seen, kind, pick):
    """``cls.__call__`` recording ``pick(*args, **kw)`` before it runs."""
    orig = cls.__call__

    def call(self, *a, **kw):
        _record(seen, kind, *pick(*a, **kw))
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, "__call__", call)


def _gts():
    """Two images' gts on a 128x192 canvas: image 0's first centred on the
    anchors of the stride-32 cell (2, 3), at (96, 64) (the anchors sit on
    the cell's corner, ``center_offset`` 0); image 1's last padding."""
    gt = np.array([[[76, 44, 116, 84], [10, 12, 70, 60], [100, 30, 180, 120], [20, 70, 60, 126]],
                   [[30, 40, 90, 110], [120, 10, 170, 60], [5, 5, 40, 30], [0, 0, 0, 0]]],
                  np.float32)
    return gt, gt[..., 2] > 0, np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int32)


@pytest.mark.parametrize("clamp", [False, True])
def test_centre_clamp_matches_jax(clamp):
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(0, 100, (64, 2)), rng.uniform(110, 300, (64, 2))],
                           -1).astype(np.float32)
    deltas = rng.normal(0, 2.5, (64, 4)).astype(np.float32)
    deltas[:4, 2:] = [[6, -7], [-9, 5], [8, 8], [-8, -8]]           # beyond log(1000 / 16)
    kw = dict(add_ctr_clamp=True, ctr_clamp=32) if clamp else {}
    want = jax.jit(lambda b, d: JCoder(**kw).decode(b, d, max_shape=(400, 500)))(boxes, deltas)
    got = DeltaXYWHBBoxCoder(**kw).decode(T(boxes), T(deltas), max_shape=(400, 500))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-4)
    free = DeltaXYWHBBoxCoder(**kw).decode(T(boxes), T(deltas))          # unclipped
    shift = (free[:, :2] + free[:, 2:]) / 2 - (T(boxes)[:, :2] + T(boxes)[:, 2:]) / 2
    if clamp:
        assert float(shift.abs().max()) <= 32 + 1e-3
    else:
        assert float(shift.abs().max()) > 32


def test_ssd_anchors_match_jax():
    kw = dict(strides=[8, 16, 32, 64, 100, 300], ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
              input_size=300, basesize_ratio_range=(0.15, 0.9))
    sizes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    gen = SSDAnchorGenerator(**kw)
    assert gen.num_base_anchors == [4, 6, 6, 6, 4, 4]
    got = gen.grid_priors_cat(sizes)
    assert got.shape == (8732, 4)
    np.testing.assert_array_equal(got.numpy(), _np(JSSDAnchors(**kw).grid_priors_cat(sizes)))


def test_simota_assign_on_tied_costs_matches_jax():
    """Integer costs (many ties, 1e9 outside the centre prior), IoUs whose
    top-10 sums straddle integers, a padded gt, a point two gts select."""
    rng = np.random.RandomState(5)
    p, g = 60, 4
    cost = rng.randint(0, 6, (2, p, g)).astype(np.float32)
    ious = rng.choice([0.0, 0.25, 0.5, 0.3, 0.7], (2, p, g)).astype(np.float32)
    cand = rng.uniform(0, 1, (2, p, g)) < 0.7
    gv = np.array([[True, True, True, False], [True, True, True, True]])
    want = jax.jit(jax.vmap(jax_yolox.simota_assign))(cost, ious, cand, gv)
    got = simota_assign(T(cost), T(ious), T(cand), T(gv))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert (got == 0).any() and (got > 0).sum() > 8


def test_yolof_assignment_matches_jax(monkeypatch):
    gt, gv, gl = _gts()
    rng = np.random.RandomState(7)
    cls = rng.normal(0, 1, (2, 4, 6, 5 * 4)).astype(np.float32)
    reg = rng.normal(0, 0.4, (2, 4, 6, 5 * 4)).astype(np.float32)
    seen = []
    _recording_call(monkeypatch, jax_losses.FocalLoss, seen, "cls", lambda p, t, w, **k: (t, w))
    _recording_call(monkeypatch, jax_losses.GIoULoss, seen, "box",
                    lambda p, t, weight=None, **k: (t, weight))
    jhead = JYOLOFHead(num_classes=4, in_channels=8)
    jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a, method=lambda m, *b: m.loss(*b)))(
        ([cls], [reg]), gt, gv, gl)
    jax.effects_barrier()
    (want_labels, want_cw), (want_tgt, want_pos) = ({k: v for k, *v in seen}[k]
                                                     for k in ("cls", "box"))

    head = YOLOFHead(num_classes=4, in_channels=8)
    anchors = head.prior_generator.grid_priors_cat([(4, 6)])
    decoded = head.bbox_coder.decode(anchors[None], T(reg).reshape(2, -1, 4))
    labels, pos, cw, tgt = head.targets(anchors, decoded, T(gt), T(gv), T(gl))
    np.testing.assert_array_equal(labels.reshape(-1).numpy(), want_labels)
    np.testing.assert_array_equal(cw.reshape(-1).numpy(), want_cw)
    np.testing.assert_array_equal(pos.float().reshape(-1).numpy(), want_pos)
    np.testing.assert_array_equal(tgt.reshape(-1, 4).numpy(), want_tgt)
    assert pos.sum() > 4 and (cw == 0).any()
    # on the anchors themselves, the gt centred on cell (2, 3) takes its
    # cell's 5 anchors (distance 0 at or below the 4th smallest): mmdet's
    # topk(4) takes 4
    cand = head.candidates(anchors, anchors[None].expand(2, -1, 4), T(gt), T(gv))
    cell = (2 * 6 + 3) * 5
    assert cand[0, :, 0].nonzero()[:, 0].tolist() == list(range(cell, cell + 5))


def test_yolox_simota_matches_jax(monkeypatch):
    gt, gv, gl = _gts()
    gt, gl = gt / 2, gl
    rng = np.random.RandomState(8)
    sizes = [(8, 12), (4, 6), (2, 3)]
    outs = tuple([rng.normal(0, s, (2, h, w, c)).astype(np.float32) for h, w in sizes]
                 for c, s in ((4, 1.0), (4, 0.5), (1, 1.0)))
    seen = []
    orig = jax_yolox.simota_assign

    def recording(*a, **kw):
        out = orig(*a, **kw)
        _record(seen, "assign", out)
        return out

    monkeypatch.setattr(jax_yolox, "simota_assign", recording)
    jhead = jax_yolox.YOLOXHead(num_classes=4, in_channels=8, feat_channels=8)
    _per_image(jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a,
                                                 method=lambda m, *b: m.loss(*b))),
               outs, gt, gv, gl)
    want = np.stack([v for _, v in seen])

    head = YOLOXHead(num_classes=4, in_channels=8, feat_channels=8)
    nchw = [[T(x).permute(0, 3, 1, 2) for x in o] for o in outs]
    pts, strides, cls, reg, obj = head._flat(nchw)
    boxes = head.decode(reg, pts, strides)
    got = head.assign(cls, obj, bbox_overlaps(boxes, T(gt)), pts, strides, T(gt), T(gv), T(gl))
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    assert (got > 0).sum() >= 6


def _ssd_outs(rng, num_classes=4):
    sizes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    nb = [4, 6, 6, 6, 4, 4]
    cls = [rng.normal(0, 1, (1, h, w, a * (num_classes + 1))).astype(np.float32)
           for (h, w), a in zip(sizes, nb)]
    # a tied block: level 2's negatives all hold one logit vector of high CE
    cls[2][...] = np.tile(np.array([3, 3, 3, 3, -6], np.float32), 6)
    reg = [rng.normal(0, 1, (1, h, w, a * 4)).astype(np.float32) for (h, w), a in zip(sizes, nb)]
    return cls, reg


class _RecordingSums:
    """``jax.numpy`` that records the operand of each ``sum``."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def sum(self, a, *args, **kw):
        _record(self.seen, "sum", a)
        return jnp.sum(a, *args, **kw)


def test_ssd_hard_negatives_match_jax(monkeypatch):
    rng = np.random.RandomState(9)
    cls, reg = _ssd_outs(rng)
    gt = np.array([[[40, 50, 90, 120], [150, 160, 260, 280], [0, 0, 0, 0]]], np.float32)
    gv, gl = gt[..., 2] > 0, np.array([[1, 3, 0]], np.int32)
    seen = []
    monkeypatch.setattr(jax_ssd, "jnp", _RecordingSums(seen))
    jhead = jax_ssd.SSDHead(num_classes=4, in_channels=(8,) * 6)
    jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a, method=lambda m, *b: m.loss(*b)))(
        (cls, reg), gt, gv, gl)
    jax.effects_barrier()
    want = next(v for _, v in seen if v.dtype == np.float32 and v.shape == (8732,))[None]

    head = SSDHead(num_classes=4, in_channels=(8,) * 6)
    anchors, c, _ = head._flat(([T(x).permute(0, 3, 1, 2) for x in cls],
                                [T(x).permute(0, 3, 1, 2) for x in reg]))
    a = head.assigner.assign(anchors, T(gt), T(gv), gt_labels=T(gl))
    pos, neg = a.gt_inds > 0, a.gt_inds == 0
    labels = torch.where(pos, a.labels, torch.full_like(a.labels, 4))
    ce = -torch.gather(torch.log_softmax(c, -1), -1, labels[..., None])[..., 0]
    hard = head.hard_negatives(ce, pos, neg)
    np.testing.assert_array_equal((pos | hard).numpy(), want != 0)
    start = 38 * 38 * 4 + 19 * 19 * 6                               # level 2's anchors
    tied = hard[0, start:start + 600]
    assert 0 < int(hard.sum()) == 3 * int(pos.sum()) and tied.any() and not tied.all()


def test_solo_cells_match_jax(monkeypatch):
    gt, gv, gl = _gts()
    gt = gt / 2                                                      # a 64x96 image
    rng = np.random.RandomState(10)
    grids = cases.SOLO_GRIDS
    maps = [(32, 48), (16, 24), (8, 12), (4, 6), (2, 4)]
    cate = [rng.normal(0, 1, (2, s, s, 4)).astype(np.float32) for s in grids]
    mask = [rng.normal(0, 1, (2, h, w, s * s)).astype(np.float32) for (h, w), s in zip(maps, grids)]
    seen = []
    _recording_call(monkeypatch, jax_losses.FocalLoss, seen, "cls", lambda p, t, **k: (t,))
    jhead = jax_inst.SOLOHead(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1,
                              num_grids=grids, scale_ranges=((1, 24), (12, 48), (24, 96),
                                                             (48, 192), (96, 512)))
    crops = cases.with_masks(dict(gt_labels=gl), m0=16)["gt_masks"]
    jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a, None, crops,
                                      method=lambda m, *b: m.loss(*b)))((cate, mask), gt, gv, gl)
    jax.effects_barrier()
    head = SOLOHead(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1,
                    num_grids=grids, scale_ranges=jhead.scale_ranges)
    npos = 0
    by_size = {v.size: v for _, v in seen}                           # one size a level
    for li in range(len(grids)):
        labels, pos, _ = head.level_targets(li, *maps[li], T(gt), T(gv), T(gl))
        np.testing.assert_array_equal(labels.reshape(-1).numpy(), by_size[labels.numel()])
        npos += int(pos.sum())
    assert npos > 10


def test_yolact_targets_match_jax(monkeypatch):
    gt, gv, gl = _gts()
    gt = gt / 2
    rng = np.random.RandomState(11)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    outs = ([rng.normal(0, 1, (2, h, w, 3 * 5)).astype(np.float32) for h, w in sizes],
            [rng.normal(0, 1, (2, h, w, 12)).astype(np.float32) for h, w in sizes],
            [np.tanh(rng.normal(0, 1, (2, h, w, 3 * 4))).astype(np.float32) for h, w in sizes],
            rng.uniform(0, 2, (2, 16, 24, 4)).astype(np.float32),
            rng.normal(0, 1, (2, 8, 12, 4)).astype(np.float32))
    crops = cases.with_masks(dict(gt_labels=gl), m0=16)["gt_masks"]
    seen = []
    _recording_call(monkeypatch, jax_losses.CrossEntropyLoss, seen, "cls",
                    lambda p, t, w=None, **k: (t, w))

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def top_k(self, x, k):
            out = jax.lax.top_k(x, k)
            _record(seen, "top_k", out[1])
            return out

    class Jax:
        lax = Lax()

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(jax_inst, "jax", Jax())
    jhead = jax_inst.YOLACTHead(num_classes=4, in_channels=8, feat_channels=8, num_protos=4)
    _per_image(jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a[:3], None, a[3],
                                                 method=lambda m, *b: m.loss(*b))),
               outs, gt, gv, gl, crops)
    want = {k: [np.concatenate([v[i] for kk, *v in seen if kk == k]) for i in range(n)]
            for k, n in (("cls", 2), ("top_k", 1))}

    head = YOLACTHead(num_classes=4, in_channels=8, feat_channels=8, num_protos=4)
    anchors, *_ = head._flat([[T(x).permute(0, 3, 1, 2) for x in o] for o in outs[:3]])
    a = head.assigner.assign(anchors, T(gt), T(gv), gt_labels=T(gl))
    pos = a.gt_inds > 0
    labels = torch.where(pos, a.labels, torch.full_like(a.labels, 4))
    np.testing.assert_array_equal(labels.reshape(-1).numpy(), want["cls"][0])
    np.testing.assert_array_equal(((a.gt_inds >= 0).float()).reshape(-1).numpy(), want["cls"][1])
    top, ti = head.mask_positives(pos, a.max_overlaps)
    np.testing.assert_array_equal(ti.numpy(), want["top_k"][0].reshape(ti.shape))
    assert (top > 0).sum() >= 6 and (top < 0).any()


def _blobs(rng, n, h=24, w=32):
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(4, h - 4, n), rng.uniform(4, w - 4, n)
    r = rng.uniform(3, 9, n)
    m = ((yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2) < r[:, None,
                                                                                        None] ** 2
    m[3] = m[2]                                                      # a duplicate mask
    return m


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_mask_matrix_nms_matches_jax(kernel):
    rng = np.random.RandomState(12)
    n = 24
    masks = _blobs(rng, n)
    labels = rng.randint(0, 3, n).astype(np.int32)
    labels[3] = labels[2]
    scores = rng.choice([0.9, 0.8, 0.6, 0.5, 0.3, 0.2], n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-5:] = False                                               # padded rows
    kw = dict(filter_thr=0.05, max_num=n, kernel=kernel, sigma=2.0)
    want = jax_mnms.mask_matrix_nms(masks, labels, scores, valid=valid, **kw)
    got = mask_matrix_nms(T(masks), T(labels).long(), T(scores), valid=T(valid), **kw)
    sc, lb, ms, keep, ok = (_np(w) for w in want)
    np.testing.assert_array_equal(got[4].numpy(), ok)
    np.testing.assert_array_equal(got[3].numpy(), keep)
    np.testing.assert_array_equal(got[1].numpy(), lb)
    np.testing.assert_array_equal(got[2].numpy(), ms)
    np.testing.assert_allclose(got[0].numpy(), sc, rtol=1e-5, atol=0)
    assert ok.sum() > 8 and not ok.all()
    assert got[0][ok].numpy().min() < scores[keep[ok]].min()         # something decayed


def test_fast_nms_matches_jax():
    rng = np.random.RandomState(13)
    n, c = 50, 4
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (n, 2))], -1).astype(np.float32)
    boxes[5] = boxes[4] + 1                                          # overlapping pairs
    scores = rng.dirichlet(np.ones(c + 1), n).astype(np.float32)
    scores[7] = scores[6]                                            # tied scores
    coeffs = rng.normal(0, 1, (n, 8)).astype(np.float32)
    want = [_np(w) for w in jax_mnms.fast_nms(boxes, scores, coeffs, 0.05, 0.5, 20, -1)]
    got = [t.numpy() for t in fast_nms(T(boxes), T(scores), T(coeffs), 0.05, 0.5, 20, -1)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1][got[3]], want[1][want[3]])
    np.testing.assert_array_equal(got[0][..., :4], want[0][..., :4])
    np.testing.assert_allclose(got[0][..., 4], want[0][..., 4], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got[2], want[2])
    assert 0 < got[3].sum() < 80


def test_paste_crop_masks_matches_jax():
    gt, gv, gl = _gts()
    crops = cases.with_masks(dict(gt_labels=gl), m0=28)["gt_masks"]
    want = jax.jit(jax.vmap(lambda c, b: jax_inst.paste_crop_masks(c, b, (32, 48), 4.0)))(crops,
                                                                                           gt)
    got = paste_crop_masks(T(crops), T(gt), (32, 48), 4.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    assert (got > 0.5).sum() > 100


def _load(module, variables, prefix):
    sd = jax_variables_to_state_dict({k: {f"{prefix}_m": v} for k, v in variables.items()})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)


def _train_mode_check(jmods, tmods, x, prefix_of):
    """The JAX modules chained in train mode in one jit against the port's:
    outputs and moved statistics."""
    xs = jnp.asarray(x)
    variables = []
    h = xs
    for i, jm in enumerate(jmods):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), h)
        v = {"params": cases.randomize(shapes["params"], 20 + i),
             "batch_stats": cases.randomize(shapes["batch_stats"], 30 + i)}
        variables.append(v)
        h = jax.eval_shape(lambda v, h: jm.apply(v, h), v, h)
        h = [jnp.zeros(t.shape, t.dtype) for t in h] if isinstance(h, tuple) else \
            jnp.zeros(h.shape, h.dtype)

    def run(vs, x):
        moved, h = [], x
        for jm, v in zip(jmods, vs):
            h, m = jm.apply(v, h, mutable=["batch_stats"])
            moved.append(m["batch_stats"])
        return h, moved

    want, moved = jax.jit(run)(variables, xs)
    h = T(np.asarray(x)).permute(0, 3, 1, 2) if x.ndim == 4 else x
    for tm, v, p in zip(tmods, variables, prefix_of):
        _load(tm, v, p)
        tm.train()
    with torch.no_grad():
        for tm in tmods:
            h = tm((h,)) if isinstance(tm, DilatedEncoder) else tm(h)
    for g, w in zip(h, want):
        w = _np(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    n = 0
    for tm, m, p in zip(tmods, moved, prefix_of):
        ref = _load_stats(m, p)
        for k, v in tm.state_dict().items():
            if ".running_" in k:
                w = ref[k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                           err_msg=k)
                n += 1
    return n


def _load_stats(moved, prefix):
    sd = jax_variables_to_state_dict({"batch_stats": {f"{prefix}_m": jax.tree_util.tree_map(
        np.asarray, moved)}})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def test_csp_darknet_and_pafpn_train_mode_match_jax():
    x = np.random.RandomState(14).normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    n = _train_mode_check(
        [JCSPDarknet(deepen_factor=0.33, widen_factor=0.125),
         JPAFPN(in_channels=(32, 64, 128), out_channels=16, num_csp_blocks=1)],
        [CSPDarknet(deepen_factor=0.33, widen_factor=0.125),
         YOLOXPAFPN(in_channels=(32, 64, 128), out_channels=16, num_csp_blocks=1)], x,
        ["backbone", "neck"])
    assert n == 2 * (35 + 27)


def test_dilated_encoder_train_mode_matches_jax():
    x = np.random.RandomState(15).normal(0, 1, (2, 4, 6, 32)).astype(np.float32)
    jm = JDilatedEncoder(in_channels=32, out_channels=16, block_mid_channels=8)
    tm = DilatedEncoder(in_channels=32, out_channels=16, block_mid_channels=8)
    n = _train_mode_check([_Tupled(jm)], [tm], x, ["neck"])
    assert n == 2 * 14


class _Tupled:
    """A JAX neck that takes a tuple of maps, called on one map."""

    def __init__(self, m):
        self.m = m

    def init(self, rng, x):
        return self.m.init(rng, (x,))

    def apply(self, v, x, **kw):
        return self.m.apply(v, (x,), **kw)


def test_focus_stem_takes_mmdet_weights():
    """mmdet's ``Focus``: ``cat(x[::2, ::2], x[1::2, ::2], x[::2, 1::2],
    x[1::2, 1::2])`` then the conv; its weight loaded into the port's
    backbone through ``load_mmdet_checkpoint`` gives the same stem output."""
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Module()
    model.backbone = CSPDarknet(deepen_factor=0.33, widen_factor=0.125)
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
          for k, v in model.backbone.state_dict().items()}
    sd = {f"backbone.{k}": v.abs() + 0.5 if "running_var" in k else v for k, v in sd.items()}
    load_mmdet_checkpoint(model, {"state_dict": dict(sd)})
    x = torch.randn(1, 3, 32, 48, generator=gen)
    model.eval()
    mm = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1)
    stem = model.backbone.stem.conv
    w = sd["backbone.stem.conv.conv.weight"]
    ref = torch.nn.functional.conv2d(mm, w, padding=1)
    bn = stem.bn
    ref = ref * torch.rsqrt(bn.running_var + bn.eps)[:, None, None] * bn.weight[:, None, None] \
        + (bn.bias - bn.running_mean * bn.weight * torch.rsqrt(bn.running_var + bn.eps))[
            :, None, None]
    with torch.no_grad():
        got = model.backbone.stem(x)
    torch.testing.assert_close(got, ref * torch.sigmoid(ref), rtol=1e-5, atol=1e-5)
    assert not torch.equal(stem.conv.weight, w)
    assert torch.equal(focus_mmdet_order(stem.conv.weight), w)


def test_solo_level0_sits_at_stride_2_and_its_cells_at_half_scale():
    """On a 64x96 image the FPN's P2 is 16x24: the JAX head's level-0 mask
    map is 32x48 (stride 2), and its cells are placed against ``mw *
    strides[0] / 2`` = 192 px, twice the image's width: a gt centred at the
    image's centre takes cell column ``int(48 / 192 * S)`` = S / 4, not S /
    2 (mmdet halves P2 first)."""
    grids = cases.SOLO_GRIDS
    feats = [jnp.zeros((1, h, w, 8)) for h, w in [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]]
    jhead = jax_inst.SOLOHead(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1,
                              num_grids=grids)
    shapes = jax.eval_shape(lambda r, f: jhead.init_with_output(r, f)[0], jax.random.PRNGKey(0),
                            feats)
    assert shapes[1][0].shape == (1, 32, 48, grids[0] ** 2)
    head = SOLOHead(num_classes=4, in_channels=8, feat_channels=8, stacked_convs=1,
                    num_grids=grids, scale_ranges=((1, 96),) * 5)
    with torch.no_grad():
        _, masks = head([torch.zeros(1, 8, h, w) for h, w in [(16, 24), (8, 12), (4, 6), (2, 3),
                                                              (1, 2)]])
    assert masks[0].shape == (1, grids[0] ** 2, 32, 48)
    gt = torch.tensor([[[38.0, 22.0, 58.0, 42.0]]])
    _, pos, _ = head.level_targets(0, 32, 48, gt, torch.tensor([[True]]), torch.tensor([[1]]))
    cols = pos.view(grids[0], grids[0]).nonzero()[:, 1].unique().tolist()
    assert cols == [grids[0] // 4 - 1, grids[0] // 4]


def test_yolox_l1_loss_matches_jax_and_the_mode_switch_adds_it():
    """YOLOX's head with ``use_l1`` against JAX's on seeded outputs (its four
    losses rtol 1e-5), and ``YOLOXModeSwitchHook`` turning ``loss_l1`` on in
    the port's tiny YOLOX step (``EpochBasedRunner.enable_head_l1`` on a runner stub,
    the weights kept)."""
    from types import SimpleNamespace
    from oadg_tpu_torch.core.hook.hooks import YOLOXModeSwitchHook
    from oadg_tpu_torch.engine.runner import EpochBasedRunner
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.utils.draws import UniformDraws
    gt, gv, gl = _gts()
    gt = gt / 2
    rng = np.random.RandomState(16)
    sizes = [(8, 12), (4, 6), (2, 3)]
    outs = tuple([rng.normal(0, s, (2, h, w, c)).astype(np.float32) for h, w in sizes]
                 for c, s in ((4, 1.0), (4, 0.5), (1, 1.0)))
    jhead = jax_yolox.YOLOXHead(num_classes=4, in_channels=8, feat_channels=8, use_l1=True)
    want = jax.jit(lambda o, *a: jhead.apply({"params": {}}, o, *a,
                                             method=lambda m, *b: m.loss(*b)))(outs, gt, gv, gl)
    head = YOLOXHead(num_classes=4, in_channels=8, feat_channels=8, use_l1=True)
    got = head.loss([[T(x).permute(0, 3, 1, 2) for x in o] for o in outs], T(gt), T(gv), T(gl))
    assert sorted(got) == sorted(want) == ["loss_bbox", "loss_cls", "loss_l1", "loss_obj"]
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5, err_msg=k)

    model = build_detector(cases.tiny_model("yolox"), device="cpu")
    b = cases.batch()
    tb = {k: T(v) for k, v in b.items()}
    tb["img"] = tb["img"].permute(0, 3, 1, 2).contiguous()
    assert "loss_l1" not in model.forward_train(tb, UniformDraws())
    runner = SimpleNamespace(model=model, epoch=285, max_epochs=300, loader=None,
                             logger=SimpleNamespace(info=lambda msg: None))
    runner.enable_head_l1 = lambda: EpochBasedRunner.enable_head_l1(runner)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    YOLOXModeSwitchHook(num_last_epochs=15).before_train_epoch(runner)
    losses = model.forward_train(tb, UniformDraws())
    assert model.bbox_head.use_l1 and float(losses["loss_l1"]) > 0
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items()
               if ".running_" not in k)
