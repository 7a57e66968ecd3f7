"""Parts of GA-RetinaNet, SABL-RetinaNet, NAS-FPN and NAS-FCOS against the
JAX package, on the CPU, on seeded numpy inputs:

- NAS-FCOS's level strides: the JAX ``NASFCOS_FPN`` with the config's neck
  arguments (``start_level=0``) on four maps of R50's shape (C = 256 to
  2048, strides 4 to 32) gives five maps at strides 4 to 64, while the
  head lays its points at 8 to 128; with ``start_level=1`` 8 to 128. The
  port's ``NASFCOS`` refuses the config as given, naming both lists and the
  fix, and builds with it (ROADMAP C);
- ``ApproxMaxIoUAssigner``: the assignments, max IoUs and labels exactly,
  on gts aligned with the anchor grid (several locations tie at a gt's
  largest IoU), a duplicated gt (gts tie at a location) and padded gts;
- the necks' resampling: ``_resize_to`` on odd and even sizes, up and down,
  ``_down2`` and ``_up2``, exactly (and ``_resize_to`` equal to torch's
  ``nearest-exact``, not ``nearest``: on a 2x downsample JAX reads the odd
  rows);
- ``NASFPN`` (two stacks) and ``NASFCOS_FPN`` (``start_level`` 1, and 0
  with four laterals) at 16 channels on maps of a 128x160 image (P6 2x2, P7
  1x1: odd resizes), against jitted JAX in eval mode and in train mode
  (``mutable=['batch_stats']``): the outputs and the updated running
  statistics within 1e-5 of each tensor's largest magnitude;
- GA's ``ga_targets`` and SABL's per-side bucket targets exactly (SABL's
  read from JAX's ``loss`` through ``jax.debug.callback`` from a stand-in
  for the module's ``jnp`` that records its ``stack`` calls).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import torch_onestage_cases as cases
from oadg_tpu.core.anchor import AnchorGenerator as JAnchorGenerator
from oadg_tpu.core.bbox.assign_sample import ApproxMaxIoUAssigner as JApprox
from oadg_tpu.models.dense_heads import guided_sabl_heads as jax_ga
from oadg_tpu.models.dense_heads.autoassign_ld_heads import NASFCOSHead as JNASFCOSHead
from oadg_tpu.models.dense_heads.fovea_fsaf_heads import _level_points as jax_level_points
from oadg_tpu.models.necks import more_necks as jax_necks
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.core.bbox.assign_sample import ApproxMaxIoUAssigner
from oadg_tpu_torch.models import build_detector
from oadg_tpu_torch.models.dense_heads.fcos_head import level_points
from oadg_tpu_torch.models.dense_heads.retina_head import gather_rows
from oadg_tpu_torch.models.necks import more_necks
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.registry import HEADS, NECKS, build_from_cfg

torch.set_num_threads(2)
T = torch.from_numpy
NASFCOS_CONFIG = "configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py"


def _jax_strides(neck_args, hw=(256, 384)):
    """The strides of JAX's ``NASFCOS_FPN(**neck_args)`` outputs on four
    seeded maps of R50's shape (shapes only: ``jax.eval_shape``)."""
    rng = np.random.RandomState(0)
    maps = [jnp.asarray(rng.normal(0, 1, (1, hw[0] // s, hw[1] // s, c)).astype(np.float32))
            for s, c in zip((4, 8, 16, 32), (256, 512, 1024, 2048))]
    neck = jax_necks.NASFCOS_FPN(**neck_args)
    variables = jax.eval_shape(lambda r: neck.init(r, maps), jax.random.PRNGKey(0))
    outs = jax.eval_shape(lambda v: neck.apply(v, maps), variables)
    strides = [hw[0] // o.shape[1] for o in outs]
    assert strides == [hw[1] // o.shape[2] for o in outs]
    return strides


def test_nasfcos_neck_strides_differ_from_its_heads():
    model = load_config(f"{cases.ROOT}/{NASFCOS_CONFIG}").model
    neck = {k: v for k, v in model.neck.items() if k != "type"}
    head = {k: v for k, v in model.bbox_head.items() if k != "type"}
    assert neck["start_level"] == 0 and model.backbone.out_indices == (0, 1, 2, 3)
    head_strides = list(JNASFCOSHead(**head).strides)
    assert head_strides == [8, 16, 32, 64, 128]
    assert _jax_strides(neck) == [4, 8, 16, 32, 64]
    assert _jax_strides(dict(neck, start_level=1)) == head_strides
    with pytest.raises(ValueError, match=r"strides \[4, 8, 16, 32, 64\] and the head's points "
                                         r"at \[8, 16, 32, 64, 128\].*model\.neck\.start_level=1"):
        build_detector(model, device="meta")
    model.neck.start_level = 1
    det = build_detector(model, device="meta")
    assert det.neck.out_strides([4, 8, 16, 32]) == head_strides


def test_approx_max_iou_assigner_matches_jax():
    sizes = [(6, 8), (3, 4)]
    approx = JAnchorGenerator(strides=[8, 16], octave_base_scale=4, scales_per_octave=3,
                              ratios=[0.5, 1.0, 2.0])
    square = JAnchorGenerator(strides=[8, 16], ratios=[1.0], scales=[4])
    approxs = np.asarray(approx.grid_priors_cat(sizes))
    squares = np.asarray(square.grid_priors_cat(sizes))
    assert approxs.shape == (9 * squares.shape[0], 4)
    rng = np.random.RandomState(5)
    gt = np.zeros((2, 5, 4), np.float32)
    gt[0, :3] = [[0, 0, 32, 32], [16, 16, 48, 48], [8, 4, 60, 30]]     # on the grid: tied rows
    gt[0, 3] = gt[0, 0]                                                  # a duplicate: tied gts
    x1, y1 = rng.uniform(0, 40, 2), rng.uniform(0, 20, 2)
    gt[1, :2] = np.stack([x1, y1, x1 + rng.uniform(8, 30, 2), y1 + rng.uniform(8, 25, 2)], -1)
    valid = np.zeros((2, 5), bool)
    valid[0, :4] = valid[1, :2] = True
    labels = rng.randint(0, 6, (2, 5)).astype(np.int32)
    jassigner = JApprox(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    want = jax.jit(jax.vmap(lambda g, v, lb: jassigner.assign(
        jnp.asarray(approxs), jnp.asarray(squares), 9, g, v, gt_labels=lb)))(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(labels))
    got = ApproxMaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0).assign(
        T(approxs), T(squares), 9, T(gt), T(valid), gt_labels=T(labels))
    for name in ("gt_inds", "max_overlaps", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    inds = got.gt_inds.numpy()
    assert (inds == -1).any() and (inds == 0).any() and (inds > 0).sum() >= 6
    assert not np.isin(inds[1], [3, 4, 5]).any()            # padded gts match nothing
    assert (inds[0] == 4).any()                     # the duplicate takes its tied rows


@pytest.mark.parametrize("src,dst", [((8, 12), (4, 6)), ((4, 7), (8, 13)), ((5, 5), (3, 2)),
                                     ((2, 3), (7, 9)), ((1, 1), (3, 5)), ((12, 21), (50, 84)),
                                     ((2, 2), (4, 5))])
def test_nearest_resize_matches_jax(src, dst):
    rng = np.random.RandomState(sum(src + dst))
    x = rng.normal(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_necks._resize_to(jnp.asarray(x), dst))
    got = more_necks._resize_to(T(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    exact = F.interpolate(T(x).permute(0, 3, 1, 2), size=dst, mode="nearest-exact")
    np.testing.assert_array_equal(got.numpy(), exact.numpy())


def test_jax_nearest_downsample_reads_the_odd_rows():
    """8 rows to 4: JAX (and ``nearest-exact``) read 1, 3, 5, 7, torch's
    ``nearest`` 0, 2, 4, 6."""
    x = np.arange(8, dtype=np.float32).reshape(1, 8, 1, 1)
    assert np.asarray(jax_necks._resize_to(jnp.asarray(x), (4, 1))).ravel().tolist() == \
        [1, 3, 5, 7]
    plain = F.interpolate(T(x).permute(0, 3, 1, 2), size=(4, 1), mode="nearest")
    assert plain.ravel().tolist() == [0, 2, 4, 6]


@pytest.mark.parametrize("hw", [(8, 12), (7, 9), (5, 4), (4, 13)])
def test_down2_and_up2_match_jax(hw):
    x = np.random.RandomState(hw[0]).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    for jfn, fn in ((jax_necks._down2, more_necks._down2), (jax_necks._up2, more_necks._up2)):
        want = np.asarray(jfn(jnp.asarray(x), 2))
        got = fn(T(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


NECK_HW = (128, 160)
NECKS_CASES = {
    "nas_fpn": dict(type="NASFPN", in_channels=[8, 16, 32], out_channels=16, num_outs=5,
                    stack_times=2, start_level=1),
    "nas_fcos": dict(type="NASFCOS_FPN", in_channels=[8, 16, 32], out_channels=16, num_outs=5,
                     start_level=1),
    "nas_fcos_all_levels": dict(type="NASFCOS_FPN", in_channels=[4, 8, 16, 32],
                                out_channels=16, num_outs=5, start_level=0),
}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", sorted(NECKS_CASES))
def test_nas_neck_matches_jax(name):
    cfg = dict(NECKS_CASES[name])
    kind = cfg.pop("type")
    rng = np.random.RandomState(12)
    maps = [rng.normal(0, 1, (2, NECK_HW[0] // s, NECK_HW[1] // s, c)).astype(np.float32)
            for s, c in zip((4, 8, 16, 32), (4, 8, 16, 32))]
    jneck = getattr(jax_necks, kind)(**cfg)
    jmaps = [jnp.asarray(m) for m in maps]
    shapes = jax.eval_shape(lambda r: jneck.init(r, jmaps), jax.random.PRNGKey(0))
    variables = {"params": cases.randomize(shapes["params"], 7),
                 "batch_stats": cases.randomize(shapes["batch_stats"], 8)}
    jeval = jax.jit(lambda v, x: jneck.apply(v, x))(variables, jmaps)
    jtrain, updated = jax.jit(lambda v, x: jneck.apply(v, x, mutable=["batch_stats"]))(
        variables, jmaps)

    neck = build_from_cfg(dict(cfg, type=kind), NECKS, dict(device="cpu"))
    sd = jax_variables_to_state_dict({k: {"neck_m": v} for k, v in variables.items()})
    neck.load_state_dict({k[len("neck."):]: v for k, v in sd.items()}, strict=True)
    tmaps = [T(m).permute(0, 3, 1, 2) for m in maps]
    for mode, want in (("eval", jeval), ("train", jtrain)):
        neck.train(mode == "train")
        with torch.no_grad():
            outs = neck(tmaps)
        assert len(outs) == len(want) == 5
        for li, (o, w) in enumerate(zip(outs, want)):
            assert o.shape[2:] == w.shape[1:3]
            _close(o.permute(0, 2, 3, 1).numpy(), w, f"{name} {mode} level {li}")
    assert [o.shape[2] for o in outs] == ([16, 8, 4, 2, 1] if name != "nas_fcos_all_levels"
                                          else [32, 16, 8, 4, 2])
    stats = {k: v for k, v in jax_variables_to_state_dict(
        {"params": {"neck_m": variables["params"]},
         "batch_stats": {"neck_m": updated["batch_stats"]}}).items() if ".running_" in k}
    before = dict(neck.state_dict())
    assert len(stats) >= 8
    for k, v in stats.items():
        got = before[k[len("neck."):]].numpy()
        _close(got, v.numpy(), f"{name} {k}")
        assert not np.allclose(v.numpy(), sd[k].numpy()), k          # the statistics moved


GA_HW = (128, 192)


def _ga_case():
    """Points of a 128x192 image at GA's five strides and gts of each
    level, each centred on a point of its level (level 4 beyond the image),
    two of equal area whose centre regions hold the same point, one whose
    centre region holds no point but its ignore region four, one padded."""
    sizes = [(GA_HW[0] // s, GA_HW[1] // s) for s in (8, 16, 32, 64, 128)]
    sizes[-1] = (1, 2)
    gt = np.array([[[26, 26, 46, 46], [27, 27, 47, 47], [52, 20, 92, 60], [40, 8, 120, 88],
                    [16, 16, 176, 176]],
                   [[-86, -86, 214, 214], [58, 26, 102, 70], [100, 60, 180, 126],
                    [4, 4, 60, 68], [0, 0, 0, 0]]], np.float32)
    valid = np.ones((2, 5), bool)
    valid[1, 4] = False
    return sizes, gt, valid


def test_ga_targets_match_jax():
    sizes, gt, valid = _ga_case()
    jhead = jax_ga.GARetinaHead(num_classes=4, in_channels=16, feat_channels=16,
                                stacked_convs=1)
    points, sids = jax_level_points(sizes, jhead.strides)
    strides_pp = jnp.asarray(np.asarray(jhead.strides, np.float32))[sids]
    fn = jax.jit(lambda g, v: jhead.apply({}, points, sids, strides_pp, g, v,
                                          method=lambda m, *a: m.ga_targets(*a)))
    want = [fn(jnp.asarray(gt[i]), jnp.asarray(valid[i])) for i in range(2)]
    head = build_from_cfg(dict(type="GARetinaHead", num_classes=4, in_channels=16,
                               feat_channels=16, stacked_convs=1), HEADS, dict(device="cpu"))
    tp, lvl = level_points(sizes, head.strides)
    got = head.ga_targets(tp, lvl, T(gt), T(valid))
    for i in range(2):
        for name, g, w in zip(("loc_t", "loc_w", "matched gt", "shape_pos"), got, want[i]):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w), err_msg=f"{i} {name}")
    loc_t, loc_w, mgt, shape_pos = got
    assert torch.equal(shape_pos, loc_t > 0) and (loc_w == 0).sum() >= 4
    assert sorted(set(lvl[loc_t[0] > 0].tolist()) | set(lvl[loc_t[1] > 0].tolist())) == \
        [0, 1, 2, 3, 4]
    tied = (tp == torch.tensor([36.0, 36.0])).all(-1) & (lvl == 0)
    assert torch.equal(mgt[0][tied][0], T(gt[0, 0]))        # the first of equal areas


class _RecordingStack:
    """``jax.numpy`` that records, through ``jax.debug.callback``, what each
    ``stack`` of four arrays on the last axis returns (SABL's per-side
    bucket indices and offsets)."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def stack(self, arrays, axis=0):
        out = jnp.stack(arrays, axis)
        if len(arrays) == 4 and axis == -1:
            jax.debug.callback(lambda v: self.seen.append(np.asarray(v)), out)
        return out


def test_sabl_bucket_targets_match_jax(monkeypatch):
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    _, gt, valid = _ga_case()
    labels = np.array([[0, 1, 2, 3, 1], [2, 2, 0, 3, 0]], np.int32)
    rng = np.random.RandomState(9)
    outs = tuple([rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for h, w in sizes]
                 for c in (4, 56, 56))
    seen = []
    monkeypatch.setattr(jax_ga, "jnp", _RecordingStack(seen))
    jhead = jax_ga.SABLRetinaHead(num_classes=4, in_channels=16, feat_channels=16,
                                  stacked_convs=1)
    jax.jit(lambda o, g, v, lb: jhead.apply({}, o, g, v, lb, method=lambda m, *a: m.loss(*a)))(
        outs, jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(labels))
    jax.effects_barrier()
    ints = [s for s in seen if s.dtype.kind == "i"]
    floats = [s for s in seen if s.dtype.kind == "f"]
    k = sum(h * w for h, w in sizes)
    want_b = np.concatenate(ints).reshape(2, k, 4)
    want_o = np.concatenate(floats).reshape(2, k, 4)

    head = build_from_cfg(dict(type="SABLRetinaHead", num_classes=4, in_channels=16,
                               feat_channels=16, stacked_convs=1), HEADS, dict(device="cpu"))
    squares = head.square_gen.grid_priors_cat(sizes)
    assign = head.assigner.assign(head.approx_gen.grid_priors_cat(sizes), squares, 9, T(gt),
                                  T(valid), gt_labels=T(labels))
    tgt = gather_rows(T(gt), (assign.gt_inds - 1).clamp(0, 4))
    bidx, boff = head.bucket_targets(squares, tgt)
    np.testing.assert_array_equal(bidx.numpy(), want_b)
    np.testing.assert_array_equal(boff.numpy(), want_o)
    pos = assign.gt_inds > 0
    assert pos.sum() >= 10 and len(np.unique(bidx[pos].numpy())) >= 8


def test_resize_index_made_in_inference_mode_serves_training():
    """The cached gather index of a size pair first met under
    ``inference_mode`` (a request) is a normal tensor: a training forward
    with the same sizes saves it for the backward."""
    x = torch.randn(1, 2, 7, 5)
    with torch.inference_mode():
        more_necks._resize_to(x, (3, 11))
    y = x.clone().requires_grad_(True)
    more_necks._resize_to(y, (3, 11)).sum().backward()
    assert y.grad.sum() == 2 * 3 * 11                 # each output reads one input


def test_jax_nasfcos_head_towers_are_plain_convs():
    """JAX's ``NASFCOSHead`` (``autoassign_ld_heads.py:117-129``), whose
    docstring says a searched separable tower, holds plain 3x3 convs
    (``cls_sep{i}``, ``reg_sep{i}``) before the same GNs as ``FCOSHead``:
    the port's head is ``FCOSHead`` and loads them as its tower convs."""
    maps = [jnp.zeros((1, s, s, 16)) for s in (8, 4, 2, 1, 1)]
    head = JNASFCOSHead(num_classes=4, in_channels=16, feat_channels=16, stacked_convs=2)
    params = jax.eval_shape(lambda r: head.init(r, maps), jax.random.PRNGKey(0))["params"]
    assert {k for k in params if "_sep" in k or "_gn" in k} == {
        "cls_sep0", "cls_sep1", "reg_sep0", "reg_sep1", "cls_gn0", "cls_gn1", "reg_gn0",
        "reg_gn1"}
    assert params["cls_sep1"]["Conv_0"]["kernel"].shape == (3, 3, 16, 16)
    assert not any(k.startswith(("cls_conv", "reg_conv")) for k in params)
    port = build_from_cfg(dict(type="NASFCOSHead", num_classes=4, in_channels=16,
                               feat_channels=16, stacked_convs=2), HEADS, dict(device="cpu"))
    sd = jax_variables_to_state_dict({"params": {"head": jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), params)}})
    port.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()}, strict=True)
