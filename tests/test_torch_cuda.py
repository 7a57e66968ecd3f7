"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip elsewhere. The machine with the
card has no JAX, so this file imports none, and it is run there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and the plain versions compute bit-identical tap
indices and weights and differ only in the order of the sums (the kernels
contract separably, the plain versions sum tap by tap), so rtol=1e-5,
atol=1e-6 for values of order 1, or 1e-5 of the largest magnitude; a
bfloat16 gradient is the rounding of such an f32 sum, so it is held to one
bfloat16 rounding step. The backward kernel sums in a fixed order, so two
calls give equal bits.
The bfloat16 model on the card against the same on the CPU: see
``TOL_BF16_MAPS`` and ``TOL_BF16_LOSS``. The test loop on the card against
the CPU: per image and class the same number of detections, boxes within
``TOL_HEAD`` of the largest box coordinate and scores within ``TOL_HEAD``
of the largest score (the convolutions and FCs sum in other orders). The
host library's matcher, as the card machine's g++ builds it, equals the
numpy matcher exactly.
The OA-Mix kernels: B3's maps equal (``best_id`` may differ only where two
masks tie exactly), B4, B5 and B7 within 1e-4 of values up to 255 (the kernels
fuse the lerp's multiply-add, the plain versions emulate it in float64 and
may round a tie once more: one float32 ulp, 1.5e-5 at 255), B6's counts
equal, and OA-Mix on the card (either chain) equal to the CPU on 99.5% of
pixels. B4, B5 and B7 are also held to their plain versions over the shape
grid of ``torch_warp_cases.py`` (the grid on which the CPU tests hold the plain
versions to the JAX package), with the route each launch of B5 and B7 took:
the specialised (``fast``) kernel for uint8 or float32 3-channel (B5) and float32
4-channel (B7) images whose width is a multiple of 4 and whose pointers are
aligned, the ``generic`` one-pixel-a-thread kernel for everything else.
"""
import math
import re

import numpy as np
import pytest
import torch

from oadg_tpu_torch.ops import fg_maps as fg_mod
from oadg_tpu_torch.ops import hist as hist_mod
from oadg_tpu_torch.ops import warp as warp_mod
from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD,
                                          roi_align_multilevel,
                                          roi_align_multilevel_ref,
                                          roi_align_multilevel_ref_backward)

import torch_warp_cases as cases

STRIDES = (4, 8, 16, 32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on the card")
    return torch.device("cuda")


def _inputs(dev, dtype, seed=0):
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.rand(2, 24, 256 // s, 384 // s).astype(np.float32))
             .to(dev, dtype).contiguous(memory_format=torch.channels_last)
             for s in STRIDES]
    n = 300
    bw = np.exp(rng.uniform(np.log(1), np.log(700), n))
    bh = np.exp(rng.uniform(np.log(1), np.log(500), n))
    cx, cy = rng.uniform(-30, 414, n), rng.uniform(-30, 286, n)
    rois = np.stack([rng.randint(0, 2, n), cx - bw / 2, cy - bh / 2,
                     cx + bw / 2, cy + bh / 2], 1).astype(np.float32)
    rois[:4] = [[0, 0, 0, 0, 0], [1, 0, 0, 383, 3], [0, -50, -50, 20, 20],
                [1, 380, 250, 400, 300]]       # padding, aspect, outside, edge
    return feats, torch.from_numpy(rois).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain_version(dtype):
    dev = _cuda()
    feats, rois = _inputs(dev, dtype)
    before = ROI_ALIGN_FWD.launches
    got = roi_align_multilevel(feats, rois, 7, STRIDES, 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 7, STRIDES, 2, 56)
    torch.cuda.synchronize()
    assert ROI_ALIGN_FWD.launches == before + 1
    assert got.shape == (300, 24, 7, 7) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_roi_align_kernel_refuses_nchw_memory():
    dev = _cuda()
    feats, rois = _inputs(dev, torch.float32)
    with pytest.raises(ValueError, match="channels-last"):
        ROI_ALIGN_FWD([f.contiguous() for f in feats], rois, 7, STRIDES, 2, 56)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_matches_plain_version(dtype):
    dev = _cuda()
    feats, rois = _inputs(dev, dtype, seed=1)
    feats = [f.requires_grad_(True) for f in feats]
    dy = torch.from_numpy(np.random.RandomState(2).randn(300, 24, 7, 7)
                          .astype(np.float32)).to(dev)
    before = ROI_ALIGN_BWD.launches
    roi_align_multilevel(feats, rois, 7, STRIDES, 2, 56).backward(dy)
    torch.cuda.synchronize()
    assert ROI_ALIGN_BWD.launches == before + 1
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois,
                                             7, STRIDES, 2, 56)
    # The kernel sums in another order than the plain version, so a cell
    # where large contributions cancel can be off by a few ulps of the
    # largest gradient: the absolute limit scales with it.
    scale = max(float(w.abs().max()) for w in want)
    for f, w in zip(feats, want):
        assert f.grad.dtype == dtype and f.grad.shape == f.shape
        if dtype == torch.float32:
            torch.testing.assert_close(f.grad, w, rtol=1e-5, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(f.grad.float(), w, rtol=2 ** -8,
                                       atol=1e-4 * scale)


@pytest.mark.cuda
def test_roi_align_backward_kernel_refuses_bad_layouts():
    dev = _cuda()
    feats, rois = _inputs(dev, torch.float32)
    dy = torch.zeros((300, 24, 7, 7), device=dev)
    with pytest.raises(ValueError, match="channels-last"):
        ROI_ALIGN_BWD([f.contiguous() for f in feats], rois, dy, 7, STRIDES, 2, 56)
    with pytest.raises(ValueError, match="contiguous float32"):
        ROI_ALIGN_BWD(feats, rois, dy.permute(0, 1, 3, 2), 7, STRIDES, 2, 56)


@pytest.mark.cuda
def test_one_training_step_on_the_card():
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    dev = _cuda()
    cfg = load_config("configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py")
    model = cfg.model
    model["backbone"].update(depth=18)
    model["neck"].update(in_channels=[64, 128, 256, 512])
    handle = init_detector({"model": model}, device="cuda", num_views=2)
    opt = build_optimizer(handle.model, cfg.optimizer)
    step = make_train_step(handle.model, opt,
                           build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100))
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 256, 512).astype(np.float32))
    x1 = rng.uniform(0, 300, (2, 8))
    y1 = rng.uniform(0, 150, (2, 8))
    gt = np.stack([x1, y1, x1 + rng.uniform(16, 200, (2, 8)),
                   y1 + rng.uniform(16, 100, (2, 8))], -1).astype(np.float32)
    batch = {"img": torch.cat([img, img.flip(1)]).to(dev)
             .contiguous(memory_format=torch.channels_last),
             "gt_bboxes": torch.from_numpy(gt).repeat(2, 1, 1).to(dev),
             "gt_labels": torch.from_numpy(rng.randint(0, 8, (2, 8))).repeat(2, 1).to(dev),
             "gt_valid": torch.ones((4, 8), dtype=torch.bool, device=dev),
             "img_shape": torch.tensor([[256.0, 512.0]] * 4, device=dev)}
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    log = step(batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert ROI_ALIGN_FWD.launches == fwd + 2 and ROI_ALIGN_BWD.launches == bwd + 2
    assert all(torch.isfinite(v).all() for v in log.values())
    assert float(log["loss_cont"]) >= 0 and float(log["loss"]) > 0


# bfloat16 on the card against bfloat16 on the CPU, relative to the largest
# magnitude: cuDNN / cuBLAS and the CPU sum in float32 in other orders and
# round once, so a value that lands across a rounding boundary differs by one
# bfloat16 step (2**-8 relative) and the difference travels through the
# following layers: feature maps and head outputs 2**-4, losses (the same
# proposals and draws on both) 2**-6 relative, the heads' and layer4's
# gradients 2**-4 of their largest. A gradient summed over few positions of
# both signs cancels (the FPN's coarse levels, 8x16 cells at 256x512): one
# step in its terms is a larger share of the sum, so every gradient is held
# to 2**-3 of its largest (measured up to 1.04e-1, neck.fpn_convs.3).
TOL_BF16_MAPS = 2 ** -4
TOL_BF16_CARD = 2 ** -5         # one bfloat16 module on the card against itself on the CPU
TOL_BF16_LOSS = 2 ** -6
TOL_BF16_GRAD_SUMS = 2 ** -3


def _r18_model():
    from oadg_tpu_torch.config import load_config
    cfg = load_config("configs/OA-DG/cityscapes/"
                      "faster_rcnn_r50_fpn_1x_cityscapes_oadg.py")
    model = cfg.model
    model["backbone"].update(depth=18)
    model["neck"].update(in_channels=[64, 128, 256, 512])
    return cfg, model


def _assert_close_to_largest(got, want, tol, what):
    err = float((got.detach().float().cpu() - want.detach().float()).abs().max())
    assert err <= tol * float(want.detach().float().abs().max()), (what, err)


class _EntryDtypes:
    """Stands in for a RoIAlign kernel wrapper: records the dtype of the maps
    each call gets, then launches the kernel."""

    def __init__(self, kernel):
        self.kernel, self.dtypes = kernel, []

    def __call__(self, feats, *rest):
        self.dtypes.append(feats[0].dtype)
        return self.kernel(feats, *rest)


@pytest.mark.cuda
def test_bfloat16_request_matches_the_cpu(monkeypatch):
    """A bfloat16 request of 256x512 through ``DetectorHandle.test``: B1
    launches once, on bfloat16 maps; FPN maps and the RoI head (on the card's
    proposals) against the same seeded bfloat16 model on the CPU."""
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.ops import roi_align
    dev = _cuda()
    cfg, model = _r18_model()
    card = init_detector({"model": model}, device="cuda", dtype=torch.bfloat16)
    cpu = init_detector({"model": model}, device="cpu", dtype=torch.bfloat16)
    img = np.random.RandomState(2).randint(0, 256, (256, 512, 3), dtype=np.uint8)
    bg, bc = prepare_image(img, cfg, dev), prepare_image(img, cfg, "cpu")
    fwd = _EntryDtypes(ROI_ALIGN_FWD)
    monkeypatch.setattr(roi_align, "ROI_ALIGN_FWD", fwd)
    dets, labels, valid = card.test(bg)
    torch.cuda.synchronize()
    assert fwd.dtypes == [torch.bfloat16]
    assert dets.dtype == torch.float32 and torch.isfinite(dets).all() and int(valid.sum()) > 0
    with torch.inference_mode():
        fg, fc = card.model.extract_feat(bg["img"]), cpu.model.extract_feat(bc["img"])
        for i, (a, b) in enumerate(zip(fg, fc)):
            assert a.dtype == b.dtype == torch.bfloat16
            _assert_close_to_largest(a, b, TOL_BF16_MAPS, f"FPN level {i}")
        boxes, _, _ = card.model.rpn_head.get_proposals(*card.model.rpn_head(fg),
                                                        bg["img_shape"])
        rois = card.model.roi_head.proposals_to_rois(boxes)
        outs = [m.roi_head.bbox_head(m.roi_head.bbox_roi_extractor(f, r))
                for m, f, r in ((card.model, fg, rois), (cpu.model, fc, rois.cpu()))]
    for name, a, b in zip(("cls_score", "bbox_pred"), *outs[:2]):
        assert a.dtype == torch.bfloat16
        _assert_close_to_largest(a, b, TOL_BF16_MAPS, name)


@pytest.mark.cuda
def test_bfloat16_step_matches_the_cpu(monkeypatch):
    """One bfloat16 training step of 2 x 2 views of 256x512 on the card and
    on the CPU (the card's proposals and the CPU's draws on both): B1 and B2
    each launch twice, on bfloat16 maps; losses float32 and close;
    parameters and their gradients float32, the gradients close
    (``TOL_BF16_GRAD_SUMS``)."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    _, model = _r18_model()
    card = init_detector({"model": model}, device="cuda", num_views=2,
                         dtype=torch.bfloat16).model
    cpu = init_detector({"model": model}, device="cpu", num_views=2,
                        dtype=torch.bfloat16).model
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 256, 512).astype(np.float32))
    x1, y1 = rng.uniform(0, 300, (2, 8)), rng.uniform(0, 150, (2, 8))
    gt = np.stack([x1, y1, x1 + rng.uniform(16, 200, (2, 8)),
                   y1 + rng.uniform(16, 100, (2, 8))], -1).astype(np.float32)
    batch = {"img": torch.cat([img, img.flip(1)]).to(torch.bfloat16),
             "gt_bboxes": torch.from_numpy(gt).repeat(2, 1, 1),
             "gt_labels": torch.from_numpy(rng.randint(0, 8, (2, 8))).repeat(2, 1),
             "gt_valid": torch.ones((4, 8), dtype=torch.bool),
             "img_shape": torch.tensor([[256.0, 512.0]] * 4)}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    card_batch["img"] = card_batch["img"].contiguous(memory_format=torch.channels_last)
    props = {}
    card_props = card.rpn_head.get_proposals
    card.rpn_head.get_proposals = lambda *a: props.setdefault("card", card_props(*a))
    cpu.rpn_head.get_proposals = lambda *a: tuple(t.cpu() for t in props["card"])
    fwd, bwd = _EntryDtypes(ROI_ALIGN_FWD), _EntryDtypes(ROI_ALIGN_BWD)
    monkeypatch.setattr(roi_align, "ROI_ALIGN_FWD", fwd)
    monkeypatch.setattr(roi_align, "ROI_ALIGN_BWD", bwd)
    draws = UniformDraws(torch.Generator().manual_seed(7))      # made on the CPU
    grads = []
    for m, b in ((card, card_batch), (cpu, batch)):
        losses = m.forward_train(b, draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        grads.append((losses, dict(m.named_parameters())))
        draws = UniformDraws(given=draws.drawn)                 # the same for the CPU
    torch.cuda.synchronize()
    assert fwd.dtypes == [torch.bfloat16] * 2 and bwd.dtypes == [torch.bfloat16] * 2
    (lc, pc), (lh, ph) = grads
    for k in lh:
        assert lc[k].dtype == torch.float32 and torch.isfinite(lc[k])
        if "loss" in k:
            np.testing.assert_allclose(float(lc[k]), float(lh[k]), rtol=TOL_BF16_LOSS,
                                       atol=1e-6, err_msg=k)
    assert float(lc["loss_cont"]) > 0
    errs = []
    for k, p in pc.items():
        assert p.dtype == torch.float32
        if p.requires_grad:
            assert p.grad.dtype == torch.float32, k
            want = ph[k].grad
            errs.append((float((p.grad.cpu() - want).abs().max() / want.abs().max()), k))
        else:
            assert p.grad is None, k
    print("largest gradient errors, card vs CPU:", sorted(errs)[-8:])
    heads = [e for e in errs if e[1].startswith(("rpn_head.", "roi_head.", "backbone.layer4."))]
    assert max(heads)[0] <= TOL_BF16_MAPS, sorted(heads)[-5:]
    assert max(errs)[0] <= TOL_BF16_GRAD_SUMS, sorted(errs)[-5:]


def _grid_rois(rng, images, img_h, img_w):
    """Rois over ``images`` images of img_h x img_w: log-uniform boxes, a
    clustered set (per image 64 boxes jittered around 8 boxes, IoU >= 0.5
    for the most), and edge, out-of-range, zero, tiny, extreme-aspect and
    whole-map boxes on every image."""
    parts = []
    for b in range(images):
        n = 60
        bw = np.exp(rng.uniform(np.log(2), np.log(img_w * 0.7), n))
        bh = np.exp(rng.uniform(np.log(2), np.log(img_h * 0.7), n))
        cx, cy = rng.uniform(-20, img_w + 20, n), rng.uniform(-20, img_h + 20, n)
        parts.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1))
        gw = rng.uniform(24, img_w / 3, 8)
        gh = rng.uniform(24, img_h / 3, 8)
        gx, gy = rng.uniform(0, img_w - gw), rng.uniform(0, img_h - gh)
        k = np.repeat(np.arange(8), 8)
        jit = rng.uniform(-0.08, 0.08, (64, 4)) * np.stack([gw[k], gh[k], gw[k], gh[k]], 1)
        parts.append(np.stack([gx[k], gy[k], gx[k] + gw[k], gy[k] + gh[k]], 1) + jit)
        parts.append(np.array([
            [0, 0, 40, 30], [img_w - 50, img_h - 40, img_w, img_h],       # edges
            [-80, -60, 30, 20], [img_w - 10, -40, img_w + 90, 40],        # partly outside
            [-300, -300, -200, -250], [img_w + 10, 5, img_w + 90, 60],    # wholly outside
            [30, 40, 30, 40], [50.2, 60.1, 50.4, 60.3],                   # zero, tiny
            [3, 100, img_w - 3, 103], [200, 0, 204, img_h],               # extreme aspect
            [0, 0, img_w, img_h], [-40, -30, img_w + 40, img_h + 30]],    # whole map
            np.float64))
        parts[-3:] = [np.concatenate([np.full((len(x), 1), b), x], 1) for x in parts[-3:]]
    return np.concatenate(parts).astype(np.float32)


def _grid_inputs(dev, dtype, levels, c, seed=0, images=3, img_h=512, img_w=1024, out=7):
    """Maps of the first ``levels`` FPN levels of ``images`` images of
    img_h x img_w (a whole-image roi is level 3), C = ``c``, and the rois of
    ``_grid_rois``, with their dy at ``out`` x ``out`` bins."""
    rng = np.random.RandomState(seed)
    strides = STRIDES[:levels]
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(images, c, img_h // s, img_w // s, device=dev, generator=gen)
             .to(dtype).contiguous(memory_format=torch.channels_last) for s in strides]
    rois = torch.from_numpy(_grid_rois(rng, images, img_h, img_w)).to(dev)
    dy = torch.randn(rois.shape[0], c, out, out, device=dev, generator=gen)
    return feats, rois, dy, strides


ROI_GRID = [(levels, c, dtype) for levels in (1, 2, 3, 4) for c in (96, 200, 256)
            for dtype in (torch.float32, torch.bfloat16)] + [
    (4, 6, torch.float32), (4, 6, torch.bfloat16)]       # one channel a load


def _grid_id(case):
    levels, c, dtype = case
    return f"L{levels}-C{c}-{str(dtype).split('.')[-1]}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROI_GRID, ids=_grid_id)
def test_roi_align_kernels_on_the_grid(case):
    """B1 and B2 against their plain versions over levels, channel counts
    and dtypes, on edge, out-of-range, zero, tiny, extreme-aspect, whole-map
    and clustered rois of three images; B2 gives equal bits in two calls."""
    levels, c, dtype = case
    dev = _cuda()
    feats, rois, dy, strides = _grid_inputs(dev, dtype, levels, c)
    got = ROI_ALIGN_FWD(feats, rois, 7, strides, 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 7, strides, 2, 56)
    fmax = max(float(f.float().abs().max()) for f in feats)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * fmax)
    grads = ROI_ALIGN_BWD(feats, rois, dy, 7, strides, 2, 56)
    again = ROI_ALIGN_BWD(feats, rois, dy, 7, strides, 2, 56)
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois,
                                             7, strides, 2, 56)
    scale = max(float(w.abs().max()) for w in want)
    for g, a, w, f in zip(grads, again, want, feats):
        assert g.dtype == dtype and g.shape == f.shape
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(g, a)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(g.float(), w, rtol=2 ** -8, atol=1e-4 * scale)
    assert sum(bool(w.abs().max() > 0) for w in want) == levels


ROI_GRID_14 = [(levels, c, dtype) for levels in (1, 4) for c in (96, 256)
               for dtype in (torch.float32, torch.bfloat16)] + [
    (4, 6, torch.float32), (4, 6, torch.bfloat16)]       # one channel a load


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROI_GRID_14, ids=_grid_id)
def test_roi_align_kernels_at_14x14(case):
    """B1 and B2 at the mask head's 14x14 bins against their plain versions,
    over levels, channel counts and dtypes, on the grid's rois (tiny and zero
    boxes put all 196 bins of a roi on one 8x8 tile of B2); B2 gives equal
    bits in two calls; each wrapper counts its 14x14 launches."""
    levels, c, dtype = case
    dev = _cuda()
    feats, rois, dy, strides = _grid_inputs(dev, dtype, levels, c, seed=3, out=14)
    fwd14, bwd14 = ROI_ALIGN_FWD.launches_by_size[14], ROI_ALIGN_BWD.launches_by_size[14]
    got = ROI_ALIGN_FWD(feats, rois, 14, strides, 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 14, strides, 2, 56)
    assert got.shape == (rois.shape[0], c, 14, 14) and got.dtype == torch.float32
    fmax = max(float(f.float().abs().max()) for f in feats)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * fmax)
    grads = ROI_ALIGN_BWD(feats, rois, dy, 14, strides, 2, 56)
    again = ROI_ALIGN_BWD(feats, rois, dy, 14, strides, 2, 56)
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois,
                                             14, strides, 2, 56)
    scale = max(float(w.abs().max()) for w in want)
    for g, a, w, f in zip(grads, again, want, feats):
        assert g.dtype == dtype and g.shape == f.shape
        assert g.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(g, a)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(g.float(), w, rtol=2 ** -8, atol=1e-4 * scale)
    assert sum(bool(w.abs().max() > 0) for w in want) == levels
    assert (ROI_ALIGN_FWD.launches_by_size[14], ROI_ALIGN_BWD.launches_by_size[14]) == (
        fwd14 + 1, bwd14 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_14x14_through_autograd(dtype):
    """``roi_align_multilevel`` at ``output_size=14`` on CUDA tensors runs B1
    and B2 (no plain version), forward and backward."""
    dev = _cuda()
    feats, rois = _inputs(dev, dtype, seed=4)
    feats = [f.requires_grad_(True) for f in feats]
    dy = torch.from_numpy(np.random.RandomState(5).randn(300, 24, 14, 14)
                          .astype(np.float32)).to(dev)
    fwd, bwd = ROI_ALIGN_FWD.launches_by_size[14], ROI_ALIGN_BWD.launches_by_size[14]
    out = roi_align_multilevel(feats, rois, 14, STRIDES, 2, 56)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (ROI_ALIGN_FWD.launches_by_size[14], ROI_ALIGN_BWD.launches_by_size[14]) == (
        fwd + 1, bwd + 1)
    torch.testing.assert_close(out, roi_align_multilevel_ref(feats, rois, 14, STRIDES, 2, 56),
                               rtol=1e-5, atol=1e-6)
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois,
                                             14, STRIDES, 2, 56)
    scale = max(float(w.abs().max()) for w in want)
    for f, w in zip(feats, want):
        if dtype == torch.float32:
            torch.testing.assert_close(f.grad, w, rtol=1e-5, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(f.grad.float(), w, rtol=2 ** -8, atol=1e-4 * scale)


@pytest.mark.cuda
def test_roi_align_kernels_refuse_other_output_sizes():
    """The kernels take 7x7 and 14x14 bins; 10x10 raises in both wrappers
    (and through the op), naming what they take, and launches nothing."""
    dev = _cuda()
    feats, rois, dy, strides = _grid_inputs(dev, torch.float32, 4, 96, out=10)
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    with pytest.raises(ValueError, match="7x7 and 14x14"):
        ROI_ALIGN_FWD(feats, rois, 10, strides, 2, 56)
    with pytest.raises(ValueError, match="7x7 and 14x14"):
        ROI_ALIGN_BWD(feats, rois, dy, 10, strides, 2, 56)
    with pytest.raises(ValueError, match="7x7 and 14x14"):
        roi_align_multilevel(feats, rois, 10, strides, 2, 56)
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd, bwd)


DWD_ROI_CASES = {"serving": (1, 64, 128, 1000), "training": (4, 46, 80, 4 * 512 + 4 * 10)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DWD_ROI_CASES))
def test_roi_align_kernels_at_the_dwd_shapes(case, dtype):
    """B1 and B2 at the DWD config's one level (stride 16) and C = 2048:
    serving (one 64x128 map, R=1000) and training (4 maps of 46x80, the
    step's R=2088), against their plain versions; B2 gives equal bits in
    two calls."""
    dev = _cuda()
    images, h, w, r = DWD_ROI_CASES[case]
    rng = np.random.RandomState(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    feats = [torch.randn(images, 2048, h, w, device=dev, generator=gen).to(dtype)
             .contiguous(memory_format=torch.channels_last)]
    rois = _grid_rois(rng, images, h * 16, w * 16)
    extra = r - len(rois)
    bw = np.exp(rng.uniform(np.log(4), np.log(w * 12), extra))
    bh = np.exp(rng.uniform(np.log(4), np.log(h * 12), extra))
    x1, y1 = rng.uniform(-20, w * 16, extra), rng.uniform(-20, h * 16, extra)
    more = np.stack([rng.randint(0, images, extra), x1, y1, x1 + bw, y1 + bh], 1)
    rois = torch.from_numpy(np.concatenate([rois, more]).astype(np.float32)).to(dev)
    assert rois.shape[0] == r
    got = ROI_ALIGN_FWD(feats, rois, 7, (16,), 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 7, (16,), 2, 56)
    fmax = float(feats[0].float().abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * fmax)
    del got, want
    dy = torch.randn(r, 2048, 7, 7, device=dev, generator=gen)
    (grad,) = ROI_ALIGN_BWD(feats, rois, dy, 7, (16,), 2, 56)
    (again,) = ROI_ALIGN_BWD(feats, rois, dy, 7, (16,), 2, 56)
    (want,) = roi_align_multilevel_ref_backward(dy, [feats[0].shape], rois, 7, (16,), 2, 56)
    scale = float(want.abs().max())
    assert grad.dtype == dtype and torch.equal(grad, again)
    if dtype == torch.float32:
        torch.testing.assert_close(grad, want, rtol=0, atol=1e-5 * scale)
    else:
        torch.testing.assert_close(grad.float(), want, rtol=2 ** -8, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_takes_long_lists(dtype):
    """1300 rois of one level of the second image: a bucket of 1300 rois
    and tiles that list hundreds of them (many groups a block); the first
    image gets zeros."""
    dev = _cuda()
    rng = np.random.RandomState(5)
    n, c = 1300, 40
    bw, bh = rng.uniform(1, 200, n), rng.uniform(1, 120, n)
    cx, cy = rng.uniform(-10, 300, n), rng.uniform(-10, 170, n)
    rois = torch.from_numpy(np.stack([np.ones(n), cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                      cy + bh / 2], 1).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    feats = [torch.randn(2, c, 40, 72, device=dev, generator=gen).to(dtype)
             .contiguous(memory_format=torch.channels_last)]
    dy = torch.randn(n, c, 7, 7, device=dev, generator=gen)
    got = ROI_ALIGN_BWD(feats, rois, dy, 7, (4,), 2, 56)
    again = ROI_ALIGN_BWD(feats, rois, dy, 7, (4,), 2, 56)
    want = roi_align_multilevel_ref_backward(dy, [feats[0].shape], rois, 7, (4,), 2, 56)
    scale = float(want[0].abs().max())
    assert torch.equal(got[0], again[0]) and not got[0][0].any()
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5 * scale)
    else:
        torch.testing.assert_close(got[0].float(), want[0], rtol=2 ** -8, atol=1e-4 * scale)


@pytest.mark.cuda
def test_roi_align_kernels_take_no_rois():
    dev = _cuda()
    feats, rois, dy, strides = _grid_inputs(dev, torch.float32, 4, 96)
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    out = ROI_ALIGN_FWD(feats, rois[:0], 7, strides, 2, 56)
    grads = ROI_ALIGN_BWD(feats, rois[:0], dy[:0], 7, strides, 2, 56)
    assert out.shape == (0, 96, 7, 7)
    assert all(g.shape == f.shape and not g.any() for g, f in zip(grads, feats))
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_wrappers_do_not_sync(dtype):
    """Both wrappers only enqueue: no call waits for the device."""
    dev = _cuda()
    feats, rois, dy, strides = _grid_inputs(dev, dtype, 4, 256, seed=1)
    ROI_ALIGN_FWD(feats, rois, 7, strides, 2, 56)                 # builds, loads
    ROI_ALIGN_BWD(feats, rois, dy, 7, strides, 2, 56)
    torch.cuda.synchronize()
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ROI_ALIGN_FWD(feats, rois, 7, strides, 2, 56)
        grads = ROI_ALIGN_BWD(feats, rois, dy, 7, strides, 2, 56)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == (fwd + 1, bwd + 1)
    assert torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)


def _oamix_inputs(dev, h=256, w=512, seed=0):
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).to(dev)
    fx = torch.from_numpy(rng.rand(16, w).astype(np.float32)).to(dev)
    fy = torch.from_numpy((rng.rand(16, h) * (rng.rand(16, 1) > 0.3))
                          .astype(np.float32)).to(dev)
    return rng, img, fx, fy


@pytest.mark.cuda
def test_fg_maps_kernel_matches_plain_version():
    dev = _cuda()
    _, _, fx, fy = _oamix_inputs(dev)
    before = fg_mod.FG_MAPS.launches
    got = fg_mod.fg_maps(fx, fy, 256, 512)
    want = fg_mod.fg_maps_ref(fx, fy, 256, 512)
    torch.cuda.synchronize()
    assert fg_mod.FG_MAPS.launches == before + 1
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -8, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("kind", ["uint8", "f32x3", "f32x4"])
def test_shear_rows_kernel_matches_plain_version(axis, kind):
    dev = _cuda()
    rng, img, _, _ = _oamix_inputs(dev)
    if kind != "uint8":
        img = img.float()
    if kind == "f32x4":
        img = torch.cat([img, img[..., :1] * 0.5], -1).contiguous()
    n = img.shape[0] if axis == 1 else img.shape[1]
    shifts = torch.from_numpy(rng.randint(-300, 301, n).astype(np.int32)).to(dev)
    fracs = torch.rand(n, device=dev)
    before = warp_mod.SHEAR_ROWS.launches
    got = warp_mod.shear_rows(img, shifts, fracs, 200, axis)
    want = warp_mod.shear_rows_ref(img, shifts, fracs, 200, axis)
    torch.cuda.synchronize()
    assert warp_mod.SHEAR_ROWS.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
def test_piecewise_shift_rows_kernel_matches_plain_version(axis):
    dev = _cuda()
    rng, img, fx, fy = _oamix_inputs(dev)
    bid = fg_mod.fg_maps_ref(fx, fy, 256, 512)[0]
    n = 256 if axis == 1 else 512
    shifts = torch.randn(n, 16, device=dev) * 300
    before = warp_mod.PIECEWISE_SHIFT_ROWS.launches
    got = warp_mod.piecewise_shift_rows(img, bid, shifts, 512, axis)
    want = warp_mod.piecewise_shift_rows_ref(img, bid, shifts, 512, axis)
    torch.cuda.synchronize()
    assert warp_mod.PIECEWISE_SHIFT_ROWS.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("flags", ["bb", "bg", "neither", "three_slots"])
@pytest.mark.parametrize("kind", ["uint8", "f32x4"])
def test_merged_shift_rows_kernel_matches_plain_version(kind, flags, axis):
    dev = _cuda()
    rng, img, fx, fy = _oamix_inputs(dev)
    if kind == "f32x4":
        img = torch.cat([img.float(), img[..., :1] * 0.5], -1).contiguous()
    s = 3 if flags == "three_slots" else 1
    cid = fg_mod.fg_maps_ref(fx, fy, 256, 512)[0].long()            # 16: the sentinel
    if s == 3:
        slot = torch.from_numpy(rng.randint(0, 3, (256, 512))).to(dev)
        cid = torch.where(cid < 16, slot * 16 + cid, torch.full_like(cid, 48))
    n = 256 if axis == 1 else 512
    p_bb = torch.randn(n, s * 16, device=dev) * 200
    p_sl = torch.randn(n, s, device=dev) * 200
    is_bb, is_bg = {"bb": ([True], [False]), "bg": ([False], [True]),
                    "neither": ([False], [False]),
                    "three_slots": ([True, False, False], [False, False, True])}[flags]
    before = warp_mod.MERGED_SHIFT_ROWS.launches
    got = warp_mod.merged_shift_rows(img, cid, p_bb, p_sl, is_bb, is_bg, axis)
    want = warp_mod.merged_shift_rows_ref(img, cid, p_bb, p_sl, is_bb, is_bg, axis)
    torch.cuda.synchronize()
    assert warp_mod.MERGED_SHIFT_ROWS.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    if flags == "neither":
        assert torch.equal(got, img.float())
    with pytest.raises(ValueError, match="host value"):
        warp_mod.merged_shift_rows(img, cid, p_bb, p_sl, torch.tensor(is_bb, device=dev),
                                   is_bg, axis)


def _routes_taken(wrapper, before):
    return {k: wrapper.routes[k] - before[k] for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.GRID, ids=cases.grid_id)
def test_shear_rows_kernel_grid(case):
    """B4 over the grid, one launch per kind of shift (whole, zero, beyond
    the image, past the clamp, a shear's slope, a few pixels)."""
    dev = _cuda()
    kind, c, axis, w = case
    img = torch.from_numpy(cases.image(0, w, c, kind)).to(dev)
    n, extent = (cases.H, w) if axis == 1 else (w, cases.H)
    table = torch.from_numpy(cases.shift_table(2, n, cases.G, extent)).to(dev)
    for k in range(cases.G):
        shifts = torch.floor(table[:, k])
        fracs = table[:, k] - shifts
        got = warp_mod.shear_rows(img, shifts.to(torch.int32), fracs, 100, axis)
        want = warp_mod.shear_rows_ref(img, shifts.to(torch.int32), fracs, 100, axis)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases.GRID, ids=cases.grid_id)
def test_piecewise_shift_rows_kernel_grid(case):
    dev = _cuda()
    kind, c, axis, w = case
    img, ids, shifts = (torch.from_numpy(a).to(dev) for a in cases.piecewise_case(case))
    before = dict(warp_mod.PIECEWISE_SHIFT_ROWS.routes)
    got = warp_mod.piecewise_shift_rows(img, ids, shifts, cases.MAX_SHIFT, axis)
    want = warp_mod.piecewise_shift_rows_ref(img, ids, shifts, cases.MAX_SHIFT, axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    fast = c == 3 and w % 4 == 0
    assert _routes_taken(warp_mod.PIECEWISE_SHIFT_ROWS, before) == \
        {"fast": int(fast), "generic": int(not fast)}


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["bb", "bg", "mixed3"])
@pytest.mark.parametrize("case", cases.GRID, ids=cases.grid_id)
def test_merged_shift_rows_kernel_grid(case, flags):
    dev = _cuda()
    kind, c, axis, w = case
    is_bb, is_bg = {"bb": ([True], [False]), "bg": ([False], [True]),
                    "mixed3": ([True, False, False], [False, True, True])}[flags]
    img, ids, p_bb, p_sl = (torch.from_numpy(a).to(dev)
                            for a in cases.merged_case(case, len(is_bb)))
    before = dict(warp_mod.MERGED_SHIFT_ROWS.routes)
    got = warp_mod.merged_shift_rows(img, ids, p_bb, p_sl, is_bb, is_bg, axis)
    want = warp_mod.merged_shift_rows_ref(img, ids, p_bb, p_sl, is_bb, is_bg, axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    fast = kind == "f32" and c == 4 and w % 4 == 0
    assert _routes_taken(warp_mod.MERGED_SHIFT_ROWS, before) == \
        {"fast": int(fast), "generic": int(not fast)}


def _misaligned(t):
    """A contiguous view of ``t``'s values that starts one element into its
    storage: 1 byte off for uint8, 4 bytes off for float32."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_piecewise_shift_rows_kernel_takes_views(kind, axis):
    """A strided image is copied by the public function and a misaligned one
    (the uint8 image, the ids or the output's 16 bytes) goes to the generic
    route; the values do not change."""
    dev = _cuda()
    case = (kind, 3, axis, 64)
    img, ids, shifts = (torch.from_numpy(a).to(dev) for a in cases.piecewise_case(case))
    want = warp_mod.piecewise_shift_rows_ref(img, ids, shifts, cases.MAX_SHIFT, axis)
    wide = torch.stack([img, img], 2).reshape(cases.H, 128, 3)[:, ::2]     # strided along x
    assert not wide.is_contiguous() and torch.equal(wide, img)
    with pytest.raises(ValueError, match="contiguous"):
        warp_mod.PIECEWISE_SHIFT_ROWS(wide, ids, shifts, cases.MAX_SHIFT, axis)
    for im, bid, route in ((wide, ids, "fast"), (img, _misaligned(ids), "generic"),
                           (_misaligned(img), ids, "generic" if kind == "u8" else "fast")):
        before = dict(warp_mod.PIECEWISE_SHIFT_ROWS.routes)
        got = warp_mod.piecewise_shift_rows(im, bid, shifts, cases.MAX_SHIFT, axis)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        assert _routes_taken(warp_mod.PIECEWISE_SHIFT_ROWS, before)[route] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
def test_merged_shift_rows_kernel_takes_views(axis):
    dev = _cuda()
    case = ("f32", 4, axis, 64)
    img, ids, p_bb, p_sl = (torch.from_numpy(a).to(dev) for a in cases.merged_case(case, 1))
    want = warp_mod.merged_shift_rows_ref(img, ids, p_bb, p_sl, [True], [False], axis)
    turned = img.permute(1, 0, 2).contiguous().permute(1, 0, 2)            # strided along y
    assert not turned.is_contiguous()
    for im, cid, route in ((turned, ids, "fast"), (_misaligned(img), ids, "generic"),
                           (img, ids.long(), "fast")):
        before = dict(warp_mod.MERGED_SHIFT_ROWS.routes)
        got = warp_mod.merged_shift_rows(im, cid, p_bb, p_sl, [True], [False], axis)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        assert _routes_taken(warp_mod.MERGED_SHIFT_ROWS, before)[route] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
def test_flagship_shapes_take_the_fast_route(axis):
    """1024x2048 as OA-Mix calls the kernels: B5 on the uint8 3-channel
    image and on a float32 3-channel result, B7 on the float32 4-channel
    image with one slot; each against its plain version."""
    dev = _cuda()
    rng, img, fx, fy = _oamix_inputs(dev, 1024, 2048)
    ids = fg_mod.fg_maps_ref(fx, fy, 1024, 2048)[0]
    n = 1024 if axis == 1 else 2048
    shifts = torch.from_numpy((rng.randn(n, 16) * 60).astype(np.float32)).to(dev)
    img4 = torch.cat([img.float(), img[..., :1] * 0.5], -1).contiguous()
    b5, b7 = warp_mod.PIECEWISE_SHIFT_ROWS, warp_mod.MERGED_SHIFT_ROWS
    before = b5.routes["fast"], b7.routes["fast"]
    for im in (img, img.float() * 0.75):
        got = warp_mod.piecewise_shift_rows(im, ids, shifts, 512, axis)
        want = warp_mod.piecewise_shift_rows_ref(im, ids, shifts, 512, axis)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    got = warp_mod.merged_shift_rows(img4, ids, shifts, shifts[:, :1], [True], [False], axis)
    want = warp_mod.merged_shift_rows_ref(img4, ids, shifts, shifts[:, :1], [True], [False],
                                          axis)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert (b5.routes["fast"], b7.routes["fast"]) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_hist256_kernel_matches_plain_version():
    dev = _cuda()
    _, img, _, _ = _oamix_inputs(dev)
    before = hist_mod.HIST256.launches
    got = hist_mod.image_hist256(img)
    torch.cuda.synchronize()
    assert hist_mod.HIST256.launches == before + 1
    assert torch.equal(got, hist_mod.hist256_ref(img, 3))
    assert torch.equal(hist_mod.hist256(img[..., 1].float()), hist_mod.hist256_ref(
        img[..., 1].contiguous())[0])


def _hist_buffer(kind, n, dev, seed=0):
    """n + 16 uint8 values on the card: random, flat (runs of 64 equal
    values) or constant."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        v = rng.randint(0, 256, n + 16)
    elif kind == "flat":
        v = np.repeat(rng.randint(0, 256, n // 64 + 2), 64)[:n + 16]
    else:
        v = np.full(n + 16, 77)
    return torch.from_numpy(v.astype(np.uint8)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["random", "flat", "constant"])
def test_hist256_kernel_offsets_and_sizes(kind, c):
    """B6 against the plain version on views that start 0..15 bytes past a
    16-byte boundary, of sizes below one 8-byte word, not a multiple of 48
    and of a few megabytes (several words a thread)."""
    dev = _cuda()
    buf = _hist_buffer(kind, 1_500_000 * c, dev, seed=c)
    for offset in range(16):
        for n in (c, 7 * c, 49 * c, 4801 * c, 1_500_000 * c):
            x = buf[offset:offset + n]
            got = hist_mod.HIST256(x, c)
            assert torch.equal(got, hist_mod.hist256_ref(x, c)), (offset, n)


@pytest.mark.cuda
def test_hist256_kernel_repeats_and_counts_launches():
    dev = _cuda()
    img = _hist_buffer("random", 1024 * 2048 * 3, dev)[:1024 * 2048 * 3].reshape(1024, 2048, 3)
    before = hist_mod.HIST256.launches
    a = hist_mod.image_hist256(img)
    b = hist_mod.image_hist256(img)
    torch.cuda.synchronize()
    assert hist_mod.HIST256.launches == before + 2
    assert torch.equal(a, b) and torch.equal(a, hist_mod.hist256_ref(img, 3))
    assert int(a.sum()) == img.numel()


def _blurred_fg_inputs(dev, h, w, g=16, seed=0):
    """The gated blurred profiles of g seeded gts, as OA-Mix makes them for
    B3 (most products exact zeros)."""
    from oadg_tpu_torch.ops.oamix_device import _blurred_profiles
    rng = np.random.RandomState(seed)
    bw = np.exp(rng.uniform(np.log(16), np.log(w / 2), g))
    bh = np.exp(rng.uniform(np.log(16), np.log(h / 2), g))
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    gt = torch.from_numpy(np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)).to(dev)
    fx, fy = _blurred_profiles(gt, h, w, 0.3)
    fy[1::5] = 0.0                                    # gated gts
    return fx.contiguous(), fy.contiguous()


def _fg_case(name, dev):
    rng = np.random.RandomState(11)
    if name == "blurred":
        return (*_blurred_fg_inputs(dev, 256, 512), 256, 512)
    if name == "blurred ragged 1000x1333":
        return (*_blurred_fg_inputs(dev, 1000, 1333, seed=1), 1000, 1333)
    if name == "dense":
        return (torch.from_numpy(rng.uniform(0.01, 1, (16, 512)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0.01, 1, (16, 256)).astype(np.float32)).to(dev),
                256, 512)
    if name == "G=1":
        fx, fy = _blurred_fg_inputs(dev, 1000, 1333, g=1, seed=2)
        return fx, fy, 1000, 1333
    if name == "G=127":
        fx, fy = _blurred_fg_inputs(dev, 256, 512, g=127, seed=3)
        return fx, fy, 256, 512
    if name == "all zero":
        return torch.zeros((16, 512), device=dev), torch.zeros((16, 256), device=dev), 256, 512
    if name == "unaligned fx":                        # the scalar path
        fx, fy = _blurred_fg_inputs(dev, 256, 512, seed=4)
        buf = torch.zeros(fx.numel() + 1, device=dev)
        buf[1:] = fx.reshape(-1)
        return buf[1:].view(16, 512), fy, 256, 512
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blurred", "blurred ragged 1000x1333", "dense", "G=1",
                                  "G=127", "all zero", "unaligned fx"])
def test_fg_maps_kernel_cases(name):
    """B3 against the plain version on OA-Mix's sparse blurred profiles, on
    dense ones, at a ragged size, at both ends of G and on zero profiles
    (every id the sentinel); one launch per call."""
    dev = _cuda()
    fx, fy, h, w = _fg_case(name, dev)
    g = fx.shape[0]
    before = fg_mod.FG_MAPS.launches
    got = fg_mod.FG_MAPS(fx, fy, h, w)
    want = fg_mod.fg_maps_ref(fx, fy, h, w)
    torch.cuda.synchronize()
    assert fg_mod.FG_MAPS.launches == before + 1
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -8, atol=0)
    if name == "all zero":
        assert bool((got[0] == g).all()) and not bool(got[1].float().any())


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["slots", "merged"])
def test_oamix_on_the_card_matches_the_cpu(chain):
    from oadg_tpu_torch.ops.oamix_device import oamix_batch
    dev = _cuda()
    _, img, _, _ = _oamix_inputs(dev)
    gt = torch.tensor([[40, 30, 200, 150], [60, 50, 230, 170], [300, 100, 480, 240]]
                      + [[0, 0, 0, 0]] * 13, dtype=torch.float32)
    gv = torch.zeros(16, dtype=torch.bool)
    gv[:3] = True
    shape = np.array([[256, 512]], np.float32)
    cfg = dict(num_views=2, version="augmix.all")
    b7 = warp_mod.MERGED_SHIFT_ROWS.launches
    card = oamix_batch(img[None], gt[None].to(dev), gv[None].to(dev), shape, cfg,
                       generator=torch.Generator().manual_seed(0), chain=chain)
    cpu = oamix_batch(img[None].cpu(), gt[None], gv[None], shape, cfg, draws=card["draws"],
                      chain=chain)
    assert (warp_mod.MERGED_SHIFT_ROWS.launches > b7) == (chain == "merged")
    same = (card["aug"].cpu() == cpu["aug"]).float().mean().item()
    assert same >= 0.995, same
    for k in ("multilevel_boxes", "multilevel_valid", "oamix_boxes", "oamix_valid"):
        assert torch.equal(card[k].cpu(), cpu[k]), k


TOL_HEAD = 1e-4


def _tiny_test_cfg(tmp_path):
    """The tiny flagship (R18-FPN at 16 channels) with its test set on the
    4-image dataset of ``torch_data_cases.py``, written with the port's
    own PNG encoder (the card machine has no OpenCV)."""
    import torch_data_cases as data_cases
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    cfg = load_config(data_cases.FLAGSHIP)
    cfg.merge_from_dict(data_cases.cfg_options(
        *data_cases.write_dataset(str(tmp_path), imwrite=imwrite)))
    m = cfg.model
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    m["rpn_head"].update(in_channels=16, feat_channels=16)
    m["roi_head"]["bbox_roi_extractor"].update(out_channels=16)
    m["roi_head"]["bbox_head"].update(in_channels=16, fc_out_channels=32)
    m["roi_head"]["bbox_head"]["cont_predictor_cfg"] = dict(
        num_linear=2, feat_channels=16, return_relu=True)
    m["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    m["test_cfg"]["rcnn"].update(max_per_img=10)
    return cfg


def _separated_checkpoint(cfg, path):
    """Seeded weights with random frozen-BN statistics and larger RPN and
    box-head weights, so that scores are far apart (as the CPU tests'
    ``_randomize``), saved as a ``state_dict``."""
    from oadg_tpu_torch.apis import init_detector
    sd = init_detector(cfg, device="cpu").model.state_dict()
    gen = torch.Generator().manual_seed(1)
    for suffix, std in (("rpn_cls.weight", 1.0), ("rpn_reg.weight", 0.1),
                        ("fc_cls.weight", 1.0), ("fc_reg.weight", 0.3)):
        (key,) = [k for k in sd if k.endswith(suffix)]
        sd[key] = torch.randn(sd[key].shape, generator=gen) * std
    for key in [k for k in sd if k.endswith("running_var")]:
        sd[key] = torch.rand(sd[key].shape, generator=gen) * 0.4 + 0.8
        mean = key.replace("running_var", "running_mean")
        sd[mean] = torch.randn(sd[mean].shape, generator=gen) * 0.1
    torch.save(sd, path)
    return str(path)


@pytest.mark.cuda
def test_tiny_test_loop_on_the_card_matches_the_cpu(tmp_path):
    """``single_gpu_test`` over ``build_test_loader`` on the card (pinned
    batches) and on the CPU, one checkpoint: B1 launches once per image, and
    the results agree (boxes within ``TOL_HEAD`` of the largest box
    coordinate, scores within ``TOL_HEAD`` of the largest score); the
    evaluation of the card's results is the CPU's."""
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    _cuda()
    cfg = _tiny_test_cfg(tmp_path)
    ckpt = _separated_checkpoint(cfg, tmp_path / "tiny.pth")
    dataset, card_loader = build_test_loader(cfg, pin_memory=True)
    batch = next(iter(card_loader))
    assert torch.from_numpy(batch["img"]).is_pinned()
    _, cpu_loader = build_test_loader(cfg)
    card = load_model_state(cfg, ckpt, device="cuda")
    cpu = load_model_state(cfg, ckpt, device="cpu")
    before = ROI_ALIGN_FWD.launches
    got = single_gpu_test(card, card_loader)
    assert ROI_ALIGN_FWD.launches - before == len(dataset) == 4
    want = single_gpu_test(cpu, cpu_loader)
    dets = [r for img in want for r in img if len(r)]
    largest_box = max(float(np.abs(r[:, :4]).max()) for r in dets)
    largest_score = max(float(r[:, 4].max()) for r in dets)
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0,
                                       atol=TOL_HEAD * largest_box)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0,
                                       atol=TOL_HEAD * largest_score)
    assert sum(len(r) for img in got for r in img) > 10
    assert dataset.evaluate(got, metric="bbox") == dataset.evaluate(want, metric="bbox")


@pytest.mark.cuda
def test_native_host_library_builds_and_loads_on_the_card_machine():
    """The host library builds with the machine's g++ into ``_build/`` and
    its unfilter equals the numpy twin on a 1024x2048 image."""
    from oadg_tpu_torch.utils import host_kernels as native
    from oadg_tpu_torch.data.pipelines import image_io
    _cuda()
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.is_file()
    img = np.random.RandomState(0).randint(0, 256, (1024, 2048, 3), dtype=np.uint8)
    for filter_type in (0, 1):
        data = image_io.encode_png(img, filter_type=filter_type)
        np.testing.assert_array_equal(image_io.decode_png(data), img)
    lines = np.random.RandomState(1).randint(0, 256, (64, 1 + 96 * 3)).astype(np.uint8)
    lines[:, 0] = np.arange(64) % 5
    np.testing.assert_array_equal(native.png_unfilter(lines, 3),
                                  image_io.png_unfilter_numpy(lines, 3))


@pytest.mark.cuda
def test_native_matcher_equals_numpy_matcher_on_the_card_machine():
    """The host library as the card machine's g++ builds it: its matcher
    equals the numpy loop per (image, class, area range, maxDets), and the
    12 numbers agree on seeded fixtures that score strictly between 0 and 1."""
    import torch_data_cases as data_cases
    from oadg_tpu_torch.core.evaluation import coco_eval
    _cuda()
    gts, results = data_cases.coco_fixture(7, n_images=4)
    n = 0
    for g, r in zip(gts, results):
        for c, (boxes, crowd) in g.items():
            d = r[c]
            for rng in coco_eval.AREA_RANGES.values():
                for mdet in (1, 10, 100):
                    args = (d[:, :4], d[:, 4], boxes, crowd, boxes[:, 2] * boxes[:, 3],
                            rng, mdet)
                    for a, b in zip(coco_eval._evaluate_img(*args, native=True),
                                    coco_eval._evaluate_img(*args, native=False)):
                        np.testing.assert_array_equal(a, b)
                    n += 1
    assert n > 100
    for seed in (0, 1, 2):
        gts, results = data_cases.coco_fixture(seed)
        got = coco_eval.COCOEvalBbox(gts, results, [1, 2, 3]).accumulate()
        assert got == coco_eval.COCOEvalBbox(gts, results, [1, 2, 3], native=False).accumulate()
        assert 0 < got["bbox_mAP"] < 1


def _tiny_train_cfg(tmp_path):
    """The tiny OA-DG training config of ``torch_data_cases.tiny_train_cfg``,
    its PNGs written by the port's encoder."""
    import torch_data_cases as data_cases
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    return data_cases.tiny_train_cfg(tmp_path / "data", imwrite=imwrite)


def _tiny_train_runner(cfg, work_dir, device, ckpt=None):
    """``cfg``'s runner on ``device`` (``build_runner``: loader, OA-Mix
    preprocess, SGD), with the weights of ``ckpt`` where given."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.apis.train import build_runner
    from oadg_tpu_torch.data import build_dataset
    model = init_detector(cfg, checkpoint=ckpt, device=device, num_views=2).model
    return build_runner(model, build_dataset(dict(cfg.data.train)), cfg, work_dir=str(work_dir))


@pytest.mark.cuda
def test_runner_iteration_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    """One runner iteration (the loader's first batch, uploaded from pinned
    memory, through OA-Mix and the step) on the card and on the CPU: the
    same OA-Mix table, sampling draws and proposals (the card's, handed to
    the CPU); losses within 1e-3 relative, gradients of the RPN conv, the
    class FC and ``layer4``'s last convs within 1e-3 of the largest, the
    updated parameters within 1e-4 of the largest (phase 8 of
    ``chip_smoke.py``)."""
    from oadg_tpu_torch.engine import preprocess as preprocess_mod
    from oadg_tpu_torch.engine import train_step as train_step_mod
    from oadg_tpu_torch.engine.runner import fetch_log_vars, step_generator
    from oadg_tpu_torch.engine.train_step import upload_train_batch
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    cfg = _tiny_train_cfg(tmp_path)
    ckpt = _separated_checkpoint(cfg, tmp_path / "tiny.pth")
    card = _tiny_train_runner(cfg, tmp_path / "card", dev, ckpt)
    cpu = _tiny_train_runner(cfg, tmp_path / "cpu", "cpu", ckpt)
    np.random.seed(5)
    card_batch = next(iter(card.loader))
    np.random.seed(5)
    cpu_batch = next(iter(cpu.loader))
    assert card_batch["img_raw"].dtype == np.uint8
    assert torch.from_numpy(card_batch["img_raw"]).is_pinned()
    np.testing.assert_array_equal(card_batch["img_raw"], cpu_batch["img_raw"])

    seen = {}
    real_oamix = preprocess_mod.oamix_batch

    def oamix(*a, **k):
        if "draws" in seen:
            k = dict(k, draws=seen["draws"])
        out = real_oamix(*a, **k)
        seen["draws"] = out["draws"]
        return out

    def draws(generator):
        if "uniform" not in seen:
            seen["uniform"] = UniformDraws(generator)
            return seen["uniform"]
        return UniformDraws(given={k: v.cpu() for k, v in seen["uniform"].drawn.items()})

    props = {}
    card_props, cpu_props = card.model.rpn_head.get_proposals, cpu.model.rpn_head.get_proposals

    def record(*args, **kw):
        props["card"] = card_props(*args, **kw)
        return props["card"]

    def replay(*args, **kw):
        cpu_props(*args, **kw)
        return tuple(t.cpu() for t in props["card"])

    monkeypatch.setattr(preprocess_mod, "oamix_batch", oamix)
    monkeypatch.setattr(train_step_mod, "UniformDraws", draws)
    monkeypatch.setattr(card.model.rpn_head, "get_proposals", record)
    monkeypatch.setattr(cpu.model.rpn_head, "get_proposals", replay)
    got = fetch_log_vars(card.step(upload_train_batch(card_batch, dev),
                                   step_generator(0, 0, dev)))
    want = fetch_log_vars(cpu.step(upload_train_batch(cpu_batch, torch.device("cpu")),
                                   step_generator(0, 0, "cpu")))
    for k in want:
        assert math.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 1e-3 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    pc, ph = dict(card.model.named_parameters()), dict(cpu.model.named_parameters())
    names = [k for k in ph if k.startswith(("rpn_head.rpn_conv.", "roi_head.bbox_head.fc_cls."))
             or (k.startswith("backbone.layer4.") and ".conv2." in k)]
    assert len(names) >= 4
    for k in names:
        want_g = ph[k].grad
        assert float((pc[k].grad.cpu() - want_g).abs().max()) <= 1e-3 * float(
            want_g.abs().max()), k
    for k, p in ph.items():
        assert float((pc[k].detach().cpu() - p.detach()).abs().max()) <= 1e-4 * max(
            float(p.detach().abs().max()), 1e-6), k


@pytest.mark.cuda
def test_runner_epoch_on_the_card_launches_what_the_tables_imply(tmp_path, monkeypatch):
    """A runner epoch on the card (2 iterations of the tiny OA-DG config):
    B1 and B2 twice a step, B3-B6 as each step's OA-Mix table implies on the
    slots chain (``chip_smoke.expected_launches``), B7 never; the train
    batches' ``img_raw`` pinned uint8; losses finite."""
    from chip_smoke import expected_launches, oamix_wrappers
    from oadg_tpu_torch.engine import preprocess as preprocess_mod
    from oadg_tpu_torch.engine import runner as runner_mod
    dev = _cuda()
    cfg = _tiny_train_cfg(tmp_path)
    runner = _tiny_train_runner(cfg, tmp_path / "work", dev)
    tables, pinned = [], []
    real_oamix = preprocess_mod.oamix_batch
    real_upload = runner_mod.upload_train_batch

    def oamix(*a, **k):
        out = real_oamix(*a, **k)
        tables.append(out["draws"])
        return out

    def upload(batch, device):
        pinned.append(batch["img_raw"].dtype == np.uint8
                      and torch.from_numpy(batch["img_raw"]).is_pinned())
        return real_upload(batch, device)

    monkeypatch.setattr(preprocess_mod, "oamix_batch", oamix)
    monkeypatch.setattr(runner_mod, "upload_train_batch", upload)
    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD, **oamix_wrappers())
    before = {k: w.launches for k, w in wrappers.items()}
    runner.train_epoch()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    want = dict(roi_align_fwd=4, roi_align_bwd=4, **dict.fromkeys(oamix_wrappers(), 0))
    for t in tables:
        for k, n in expected_launches(t, cfg.oamix_config["version"]).items():
            want[k] += n
    assert len(tables) == 2 and pinned == [True, True]
    assert launched == want and launched["fg_maps"] == 4 and launched["merged_shift_rows"] == 0
    assert runner.iter == 2


@pytest.mark.cuda
def test_train_detector_in_float32_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    """``train_detector`` through the API (no tool) for one epoch of the tiny
    OA-DG config, in float32, with cuDNN's TF32 switched on beforehand (as
    PyTorch leaves it): building the model on the card turns TF32 off, and
    the run equals the CPU's on the same OA-Mix tables, sampling draws and
    proposals (the card's, handed to the CPU), iteration by iteration:
    losses within 1e-3 relative, the final parameters within 1e-4 of the
    largest."""
    import json
    from oadg_tpu_torch.apis import init_detector, train_detector
    from oadg_tpu_torch.engine import preprocess as preprocess_mod
    from oadg_tpu_torch.engine import train_step as train_step_mod
    from oadg_tpu_torch.utils.draws import UniformDraws
    _cuda()
    cfg = _tiny_train_cfg(tmp_path)
    cfg.merge_from_dict({"runner.max_epochs": 1})
    ckpt = _separated_checkpoint(cfg, tmp_path / "tiny.pth")
    torch.backends.cudnn.allow_tf32 = True
    card = init_detector(cfg, checkpoint=ckpt, device="cuda", num_views=2).model
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    cpu = init_detector(cfg, checkpoint=ckpt, device="cpu", num_views=2).model

    record = {"oamix": [], "uniform": [], "props": []}
    at = dict.fromkeys(record, 0)
    replaying = []
    real_oamix = preprocess_mod.oamix_batch

    def replayed(kind):
        i = at[kind]
        at[kind] += 1
        return record[kind][i]

    def oamix(*a, **k):
        if replaying:
            k = dict(k, draws=replayed("oamix"))
        out = real_oamix(*a, **k)
        if not replaying:
            record["oamix"].append(out["draws"])
        return out

    def draws(generator):
        if replaying:
            return UniformDraws(given=replayed("uniform"))
        d = UniformDraws(generator)
        record["uniform"].append(d.drawn)
        return d

    card_props, cpu_props = card.rpn_head.get_proposals, cpu.rpn_head.get_proposals

    def props_record(*args, **kw):
        out = card_props(*args, **kw)
        record["props"].append(out)
        return out

    def props_replay(*args, **kw):
        cpu_props(*args, **kw)
        return tuple(t.cpu() for t in replayed("props"))

    monkeypatch.setattr(preprocess_mod, "oamix_batch", oamix)
    monkeypatch.setattr(train_step_mod, "UniformDraws", draws)
    monkeypatch.setattr(card.rpn_head, "get_proposals", props_record)
    monkeypatch.setattr(cpu.rpn_head, "get_proposals", props_replay)
    logs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        if name == "cpu":
            record["uniform"] = [{k: v.cpu() for k, v in d.items()} for d in record["uniform"]]
            replaying.append(True)
        np.random.seed(5)
        work = tmp_path / name
        runner = train_detector(model, dict(cfg.data.train), cfg, work_dir=str(work))
        assert runner.iter == 2
        with open(work / "log.json") as f:
            logs[name] = [json.loads(line) for line in f]
    assert at == {"oamix": 2, "uniform": 2, "props": 2}
    for got, want in zip(logs["card"], logs["cpu"], strict=True):
        for k, v in want.items():
            if k.startswith("loss"):
                assert math.isfinite(got[k])
                assert abs(got[k] - v) <= 1e-3 * max(abs(v), 1e-6), (k, got[k], v)
    pc = dict(card.named_parameters())
    for k, p in cpu.named_parameters():
        assert float((pc[k].detach().cpu() - p.detach()).abs().max()) <= 1e-4 * max(
            float(p.detach().abs().max()), 1e-6), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolo_runner_iteration_on_the_card_matches_the_cpu(tmp_path, monkeypatch, dtype):
    """One runner iteration of the tiny OA-DG YOLOv3 config
    (``torch_yolo_cases.tiny_train_cfg``: full Darknet-53, the neck and head
    narrowed; the SSD-style float32 pipeline, OA-Mix on every view) on the
    card and on the CPU, the same seeded weights, OA-Mix table and cont
    draws: float32 losses within 1e-3 relative, the gradients of the
    prediction convs within 1e-3 of the largest, those of a neck conv and
    BN and of the first and last backbone convs within 1e-2 (below the head
    the gradient passes the live BNs' backward, which cancels over the few
    values a channel holds at this size: the CPU's own float32 step is
    ~3e-3 of the largest from a float64 one at 128x128), the neck's and
    head's BN buffers within 1e-4 of the largest and the backbone's
    unchanged. bfloat16: each loss within 2**-4
    relative of the CPU's bfloat16 step (a 52-layer bfloat16 network rounds
    differently on the card and on the CPU; see
    ``tests/test_torch_yolo_slice.py``)."""
    import torch_yolo_cases
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.apis.train import build_runner
    from oadg_tpu_torch.data import build_dataset
    from oadg_tpu_torch.engine import preprocess as preprocess_mod
    from oadg_tpu_torch.engine import train_step as train_step_mod
    from oadg_tpu_torch.engine.runner import fetch_log_vars, step_generator
    from oadg_tpu_torch.engine.train_step import upload_train_batch
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    cfg = torch_yolo_cases.tiny_train_cfg(tmp_path / "data")
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    runners = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        model = init_detector(cfg, device=where, seed=0, num_views=2, dtype=tdt).model
        runners[name] = build_runner(model, build_dataset(dict(cfg.data.train)), cfg,
                                     work_dir=str(tmp_path / name))
    batches = {}
    for name, r in runners.items():
        np.random.seed(5)
        batches[name] = next(iter(r.loader))
    assert batches["card"]["img_raw"].dtype == np.float32
    np.testing.assert_array_equal(batches["card"]["img_raw"], batches["cpu"]["img_raw"])
    seen = {}
    real_oamix = preprocess_mod.oamix_batch

    def oamix(*a, **k):
        if "draws" in seen:
            k = dict(k, draws=seen["draws"])
        out = real_oamix(*a, **k)
        seen["draws"] = out["draws"]
        return out

    def draws(generator):
        if "uniform" not in seen:
            seen["uniform"] = UniformDraws(generator)
            return seen["uniform"]
        return UniformDraws(given={k: v.cpu() for k, v in seen["uniform"].drawn.items()})

    monkeypatch.setattr(preprocess_mod, "oamix_batch", oamix)
    monkeypatch.setattr(train_step_mod, "UniformDraws", draws)
    before = {k: v.clone() for k, v in runners["cpu"].model.state_dict().items()}
    got, want = (fetch_log_vars(runners[n].step(upload_train_batch(batches[n], d),
                                                step_generator(0, 0, d)))
                 for n, d in (("card", dev), ("cpu", torch.device("cpu"))))
    assert set(torch_yolo_cases.LOSS_KEYS) <= set(want)
    tol = 1e-3 if dtype == "float32" else 2 ** -4
    for k in want:
        assert math.isfinite(got[k])
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    if dtype == "bfloat16":
        return
    pc = dict(runners["card"].model.named_parameters())
    ph = dict(runners["cpu"].model.named_parameters())
    for k, tol in (("bbox_head.convs_pred.0.weight", 1e-3),
                   ("bbox_head.convs_pred.2.weight", 1e-3),
                   ("neck.detect1.conv1.conv.weight", 1e-2),
                   ("neck.detect1.conv1.bn.weight", 1e-2),
                   ("backbone.conv1.conv.weight", 1e-2),
                   ("backbone.conv_res_block5.res3.conv2.conv.weight", 1e-2)):
        want_g = ph[k].grad
        assert float((pc[k].grad.cpu() - want_g).abs().max()) <= tol * float(
            want_g.abs().max()), k
    sc, sh = runners["card"].model.state_dict(), runners["cpu"].model.state_dict()
    for k in (k for k in sh if "running_" in k):
        assert torch.equal(sh[k], before[k]) == k.startswith("backbone."), k
        assert float((sc[k].cpu() - sh[k]).abs().max()) <= 1e-4 * max(
            float(sh[k].abs().max()), 1e-6), k


@pytest.mark.cuda
@pytest.mark.parametrize("nms_type", ["soft_nms", "soft_nms_gaussian"])
def test_soft_nms_on_the_card_matches_the_cpu(nms_type):
    """``multiclass_nms(nms_type=...)`` over 1000 seeded candidates x 8
    classes (the flagship's rcnn at 1000 proposals), on the card inside
    ``set_sync_debug_mode("error")`` (its 400 picks sync with the host
    nowhere) and on the CPU: the same kept set and labels, boxes equal and
    scores within 1e-6."""
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    dev = _cuda()
    rng = np.random.RandomState(4)
    n, c = 1000, 8
    xy = rng.uniform(0, 1800, (1, n, 1, 2))
    wh = rng.uniform(8, 300, (1, n, c, 2))
    boxes = torch.from_numpy(np.concatenate([np.broadcast_to(xy, wh.shape), xy + wh], -1)
                             .reshape(1, n, 4 * c).astype(np.float32))
    logits = rng.normal(0, 2, (1, n, c + 1)).astype(np.float32)
    scores = torch.softmax(torch.from_numpy(logits), -1)
    kw = dict(score_thr=0.05, iou_threshold=0.5, max_per_img=100, num_classes=c,
              nms_type=nms_type, sigma=0.5, min_score=0.05)
    want = multiclass_nms(boxes, scores, **kw)
    boxes, scores = boxes.to(dev), scores.to(dev)      # the uploads sync: outside the mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = multiclass_nms(boxes, scores, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = [g.cpu() for g in got]
    assert torch.equal(got[2], want[2]) and int(want[2].sum()) == 100
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0][..., :4], want[0][..., :4], rtol=0, atol=0)
    torch.testing.assert_close(got[0][..., 4], want[0][..., 4], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_tta_test_loop_on_the_card_matches_the_cpu(tmp_path):
    """``single_gpu_test`` of the tiny flagship over the 4-image set with
    ``MultiScaleFlipAug(img_scale=[(160, 96), (128, 80)], flip=True)``, on
    the card and on the CPU: B1 launches once per view (16 times), and the
    results agree as in ``test_tiny_test_loop_on_the_card_matches_the_cpu``."""
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    _cuda()
    cfg = _tiny_test_cfg(tmp_path)
    cfg.merge_from_dict({"data.test.pipeline.1.img_scale": [(160, 96), (128, 80)],
                         "data.test.pipeline.1.flip": True})
    ckpt = _separated_checkpoint(cfg, tmp_path / "tiny.pth")
    dataset, card_loader = build_test_loader(cfg, pin_memory=True)
    _, cpu_loader = build_test_loader(cfg)
    before = ROI_ALIGN_FWD.launches
    got = single_gpu_test(load_model_state(cfg, ckpt, device="cuda"), card_loader)
    assert ROI_ALIGN_FWD.launches - before == 4 * len(dataset) == 16
    want = single_gpu_test(load_model_state(cfg, ckpt, device="cpu"), cpu_loader)
    dets = [r for img in want for r in img if len(r)]
    largest_box = max(float(np.abs(r[:, :4]).max()) for r in dets)
    largest_score = max(float(r[:, 4].max()) for r in dets)
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=TOL_HEAD * largest_box)
            np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=TOL_HEAD * largest_score)
    assert sum(len(r) for img in got for r in img) > 10


class _NcclWorldOne:
    """This process as rank 0 of a world of 1 over NCCL, joined through
    ``parallel.init_distributed`` from torchrun's environment; the group is
    destroyed and the environment put back on exit."""

    KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

    def __enter__(self):
        import os
        import socket
        from oadg_tpu_torch.parallel import init_distributed
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        assert init_distributed("pytorch", device="cuda") == (0, 1)
        assert torch.distributed.get_backend() == "nccl"
        return self

    def __exit__(self, *exc):
        import os
        torch.distributed.destroy_process_group()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.cuda
def test_parallel_helpers_are_identities_at_world_one():
    """Over NCCL at world 1: ``gather_rows`` returns its rows and routes the
    gradient back unchanged, ``all_reduce_sum`` and ``all_reduce_sum_grad``
    return their input's values (``shard_sum`` inside ``sharded_batch()``
    too), ``sum_gradients`` leaves every gradient's bits (and a missing one
    missing), ``broadcast_state`` every tensor's."""
    from oadg_tpu_torch.parallel import (all_reduce_sum, all_reduce_sum_grad,
                                         batch_is_sharded, broadcast_state, gather_rows,
                                         shard_sum, sharded_batch, sum_gradients)
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(6, 5, device=dev, generator=gen, requires_grad=True)
    w = torch.randn(6, 5, device=dev, generator=gen)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3)).to(dev)
    model[1].bias.requires_grad_(False)
    with _NcclWorldOne():
        y = gather_rows(x)
        assert torch.equal(y, x)
        (y * w).sum().backward()
        assert torch.equal(x.grad, w)
        assert torch.equal(all_reduce_sum(w), w)
        z = all_reduce_sum_grad(x)
        assert torch.equal(z, x)
        labels = torch.arange(6, device=dev)
        assert torch.equal(gather_rows(labels), labels)
        assert not batch_is_sharded()
        with sharded_batch():
            assert batch_is_sharded()
            assert torch.equal(shard_sum(w), w)
        model(x.detach()).sum().backward()
        model[0].weight.grad = None                  # a parameter without a gradient
        before = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        sum_gradients(model.parameters())
        broadcast_state(model)
        torch.cuda.synchronize()
    assert model[0].weight.grad is None and model[1].bias.grad is None
    assert before.keys() == {"0.bias", "1.weight"}
    for k, p in model.named_parameters():
        if k in before:
            assert torch.equal(p.grad, before[k]), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.cuda
def test_world_one_nccl_step_is_bit_equal_to_the_plain_step():
    """The R18 flagship's training step (2 images x 2 views of 256x512) twice
    from the same weights, generator and batch: without a process group and
    as rank 0 of a world of 1 over NCCL (gathered contrastive rows,
    all-reduced normalizers and logged values, the summed gradient), both
    with cuDNN's deterministic algorithms. Every logged value of both steps
    and every parameter and buffer after them equal bit for bit."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine import build_lr_schedule, build_optimizer, make_train_step
    dev = _cuda()
    cfg, model = _r18_model()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(2, 3, 256, 512).astype(np.float32))
    x1 = rng.uniform(0, 300, (2, 8))
    y1 = rng.uniform(0, 150, (2, 8))
    gt = np.stack([x1, y1, x1 + rng.uniform(16, 200, (2, 8)),
                   y1 + rng.uniform(16, 100, (2, 8))], -1).astype(np.float32)
    batch = {"img": torch.cat([img, img.flip(1)]).to(dev)
             .contiguous(memory_format=torch.channels_last),
             "gt_bboxes": torch.from_numpy(gt).repeat(2, 1, 1).to(dev),
             "gt_labels": torch.from_numpy(rng.randint(0, 8, (2, 8))).repeat(2, 1).to(dev),
             "gt_valid": torch.ones((4, 8), dtype=torch.bool, device=dev),
             "img_shape": torch.tensor([[256.0, 512.0]] * 4, device=dev)}

    def run():
        det = init_detector({"model": model}, device="cuda", num_views=2, seed=1).model
        step = make_train_step(det, build_optimizer(det, cfg.optimizer, grad_clip=dict(
            max_norm=35)), build_lr_schedule(cfg.lr_config, cfg.optimizer["lr"], 100))
        gen = torch.Generator(device=dev).manual_seed(0)
        logs = [step(batch, gen) for _ in range(2)]
        torch.cuda.synchronize()
        return logs, {k: v.clone() for k, v in det.state_dict().items()}

    # the step without a group is not reproducible bit for bit on the card
    # by default (cuDNN's weight gradients): both runs in deterministic mode
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain_logs, plain_state = run()
        with _NcclWorldOne():
            logs, state = run()
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])
    for a, b in zip(logs, plain_logs):
        assert a.keys() == b.keys()
        for k in b:
            assert torch.equal(a[k].float(), b[k].float()), k
    for k, v in plain_state.items():
        assert torch.equal(state[k], v), k


# ------------------------------------------------------------ long tail ----

C4_ROI_CASES = {"serving": (1, 50, 84, 1000), "training": (2, 50, 84, 2 * 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(C4_ROI_CASES))
def test_roi_align_kernels_at_the_c4_shapes(case, dtype):
    """B1 and B2 at the caffe-C4 config's 14x14 bins on one level (stride
    16) at C = 1024: serving (one 50x84 map of an 800x1344 canvas, R=1000
    proposals) and training (2 maps, R = 2 x 512 sampled), against their
    plain versions; B2 gives equal bits in two calls."""
    dev = _cuda()
    images, h, w, r = C4_ROI_CASES[case]
    rng = np.random.RandomState(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    feats = [torch.randn(images, 1024, h, w, device=dev, generator=gen).to(dtype)
             .contiguous(memory_format=torch.channels_last)]
    bw = np.exp(rng.uniform(np.log(4), np.log(w * 12), r))
    bh = np.exp(rng.uniform(np.log(4), np.log(h * 12), r))
    x1, y1 = rng.uniform(-20, w * 16, r), rng.uniform(-20, h * 16, r)
    rois = torch.from_numpy(np.stack([rng.randint(0, images, r), x1, y1, x1 + bw, y1 + bh],
                                     1).astype(np.float32)).to(dev)
    got = ROI_ALIGN_FWD(feats, rois, 14, (16,), 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 14, (16,), 2, 56)
    fmax = float(feats[0].float().abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * fmax)
    del got, want
    dy = torch.randn(r, 1024, 14, 14, device=dev, generator=gen)
    (grad,) = ROI_ALIGN_BWD(feats, rois, dy, 14, (16,), 2, 56)
    (again,) = ROI_ALIGN_BWD(feats, rois, dy, 14, (16,), 2, 56)
    (want,) = roi_align_multilevel_ref_backward(dy, [feats[0].shape], rois, 14, (16,), 2, 56)
    scale = float(want.abs().max())
    assert grad.dtype == dtype and torch.equal(grad, again)
    if dtype == torch.float32:
        torch.testing.assert_close(grad, want, rtol=0, atol=1e-5 * scale)
    else:
        torch.testing.assert_close(grad.float(), want, rtol=2 ** -8, atol=1e-4 * scale)


def _nms_boxes(rng, shape, extent, size):
    xy = rng.uniform(0, extent, shape + (2,))
    wh = rng.uniform(size[0], size[1], shape + (2,))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


def _nms_case(name):
    """(boxes, scores, valid, class ids or None, IoU threshold) of the paths
    the tiled NMS serves: the flagship's training proposals (2 images x 5
    levels x 2000), the DWD config's RPN level (nms_pre 12000), YOLOv3's
    request (3 x 1000 priors x 8 classes = 24,000 candidates) and a
    test-time augmentation's pooled detections (4 views x 100) with bf16
    scores."""
    rng = np.random.RandomState(len(name))
    if name == "flagship_rpn":
        boxes = _nms_boxes(rng, (2, 5, 2000), 2048.0, (8, 400))
        valid = torch.ones(2, 5, 2000, dtype=torch.bool)
        valid[:, 4, 512:] = False
        return boxes, torch.rand(2, 5, 2000, generator=torch.Generator().manual_seed(1)), \
            valid, None, 0.7
    if name == "dwd_rpn":
        boxes = _nms_boxes(rng, (1, 1, 12000), 1280.0, (16, 600))
        return boxes, torch.rand(1, 1, 12000, generator=torch.Generator().manual_seed(2)), \
            None, None, 0.7
    if name == "yolo_multiclass":
        boxes = _nms_boxes(rng, (1, 24000), 1024.0, (8, 500))
        scores = torch.from_numpy(rng.uniform(0, 1, (1, 24000)).astype(np.float32) ** 2)
        labels = torch.arange(8).repeat(3000)[None]
        return boxes, scores, scores > 0.05, labels, 0.45
    if name == "tta_pooled":
        boxes = _nms_boxes(rng, (2, 400), 2048.0, (8, 300))
        scores = torch.from_numpy(rng.uniform(0, 1, (2, 400)).astype(np.float32)).bfloat16()
        return boxes, scores, scores > 0.05, torch.from_numpy(rng.randint(0, 8, (2, 400))), 0.5
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_rpn", "dwd_rpn", "yolo_multiclass", "tta_pooled"])
def test_tiled_nms_on_the_card_equals_one_tile_and_the_cpu(name):
    """The 256-box tiles give the one-tile keep set bit for bit on the card,
    and the CPU's."""
    from oadg_tpu_torch.core.post_processing.nms import batched_nms_padded, nms_padded
    dev = _cuda()
    boxes, scores, valid, labels, thr = _nms_case(name)

    def run(tile, device):
        b, s = boxes.to(device), scores.to(device)
        v = None if valid is None else valid.to(device)
        if labels is None:
            return nms_padded(b, s, thr, v, tile_size=tile).cpu()
        return batched_nms_padded(b, s, labels.to(device), thr, v, tile_size=tile).cpu()

    tiled = run(256, dev)
    assert torch.equal(tiled, run(None, dev))
    assert torch.equal(tiled, run(256, "cpu"))
    assert 0 < int(tiled.sum()) < tiled.numel()


@pytest.mark.cuda
def test_retina_multiclass_nms_of_400000_candidates_matches_the_cpu():
    """RetinaNet's request shape: 5 levels x 1000 boxes x 80 classes, seeded
    scores of which about 20,000 pass ``score_thr``: the card's detections
    equal the CPU's (the same tiled greedy NMS), and the card holds it in
    well under a GiB above its inputs."""
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    dev = _cuda()
    rng = np.random.RandomState(3)
    boxes = _nms_boxes(rng, (1, 5000), 2048.0, (8, 400))
    scores = np.zeros((1, 5000, 81), np.float32)
    scores[..., :80] = rng.uniform(0, 1, (1, 5000, 80)) ** 58.4
    scores = torch.from_numpy(scores)
    assert 15000 < int((scores[..., :80] > 0.05).sum()) < 25000
    want = multiclass_nms(boxes, scores, 0.05, 0.5, 100, 80)
    b, s = boxes.to(dev), scores.to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = [g.cpu() for g in multiclass_nms(b, s, 0.05, 0.5, 100, 80)]
    peak = torch.cuda.max_memory_allocated() - base
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].sum()) == 100
    assert peak < 2 ** 30, peak


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_modulated_deform_conv_on_the_card_matches_the_cpu(dtype):
    """DCNv2 at a stage-2 shape (C = 128, stride 2 in, 3x3) on 2 images of
    64x96 with offsets of a few pixels: the card's output and the gradients
    of the input, offsets, modulation and weight against the CPU's, float32
    within 1e-5 of each largest magnitude (sums in other orders and
    ``index_add`` in the gather's backward), bfloat16 within two bfloat16
    steps."""
    from oadg_tpu_torch.ops.deform_conv import modulated_deform_conv2d
    dev = _cuda()
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 128, 64, 96, generator=gen).to(dtype)
    off = torch.randn(2, 18, 32, 48, generator=gen) * 2
    mask = torch.rand(2, 9, 32, 48, generator=gen)
    w = (torch.randn(128, 128, 3, 3, generator=gen) * 0.03).to(dtype)
    dy = torch.randn(2, 128, 32, 48, generator=gen)
    outs = {}
    for where in ("cpu", dev):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (x, off, mask, w)]
        y = modulated_deform_conv2d(*leaves, stride=2, padding=1)
        (y.float() * dy.to(where)).sum().backward()
        outs[str(where)] = [y.detach().float().cpu()] + [t.grad.float().cpu() for t in leaves]
    tol = 1e-5 if dtype == torch.float32 else 2 * 2 ** -8
    for name, g, c in zip(("y", "x", "offset", "mask", "weight"), outs[str(dev)], outs["cpu"]):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, c, rtol=0 if dtype == torch.float32 else 2 ** -7,
                                   atol=tol * float(c.abs().max()), msg=name)


# ------------------------------------------------------- two-stage family ----

SEM_ROI_CASE = (1, 128, 256, 128)       # HTC's semantic level of a 1024x2048 image, R


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernels_at_the_semantic_shape(dtype):
    """B1 and B2 at HTC's semantic RoIAlign: 14x14 bins on the one stride-8
    embedding (one 128x256 map of 256 channels), R = 128 mask slots,
    against their plain versions; both count the launch under (14, 1); B2
    gives equal bits in two calls."""
    dev = _cuda()
    images, h, w, r = SEM_ROI_CASE
    rng = np.random.RandomState(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    feats = [torch.randn(images, 256, h, w, device=dev, generator=gen).to(dtype)
             .contiguous(memory_format=torch.channels_last)]
    bw = np.exp(rng.uniform(np.log(16), np.log(1024), r))
    bh = np.exp(rng.uniform(np.log(16), np.log(512), r))
    x1, y1 = rng.uniform(-16, 2048 - 16, r), rng.uniform(-16, 1024 - 16, r)
    rois = torch.from_numpy(np.stack([np.zeros(r), x1, y1, x1 + bw, y1 + bh],
                                     1).astype(np.float32)).to(dev)
    before = (ROI_ALIGN_FWD.launches_by_shape.get((14, 1), 0),
              ROI_ALIGN_BWD.launches_by_shape.get((14, 1), 0))
    got = ROI_ALIGN_FWD(feats, rois, 14, (8,), 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 14, (8,), 2, 56)
    fmax = float(feats[0].float().abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=(1e-5 if dtype == torch.float32
                                                        else 1e-4) * fmax)
    dy = torch.randn(r, 256, 14, 14, device=dev, generator=gen)
    (grad,) = ROI_ALIGN_BWD(feats, rois, dy, 14, (8,), 2, 56)
    (again,) = ROI_ALIGN_BWD(feats, rois, dy, 14, (8,), 2, 56)
    (want,) = roi_align_multilevel_ref_backward(dy, [feats[0].shape], rois, 14, (8,), 2, 56)
    scale = float(want.abs().max())
    assert grad.dtype == dtype and torch.equal(grad, again)
    if dtype == torch.float32:
        torch.testing.assert_close(grad, want, rtol=0, atol=1e-5 * scale)
    else:
        torch.testing.assert_close(grad.float(), want, rtol=2 ** -8, atol=1e-4 * scale)
    assert (ROI_ALIGN_FWD.launches_by_shape[(14, 1)] - before[0],
            ROI_ALIGN_BWD.launches_by_shape[(14, 1)] - before[1]) == (1, 2)


def _tiny_twostage(rel, mask_roi=False):
    """A two-stage config of the repo made tiny: R18-FPN of 16 channels, FCs
    of 32, 8 classes, 2 mask convs, samplers of 32, 30 proposals."""
    import os
    from oadg_tpu_torch.config import load_config
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)), rel))
    m = cfg["model"]
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    m["rpn_head"].update(in_channels=16, feat_channels=16)
    rh = m["roi_head"]
    rh["bbox_roi_extractor"]["out_channels"] = 16
    heads = rh["bbox_head"]
    for h in heads if isinstance(heads, list) else [heads]:
        h.update(in_channels=16, fc_out_channels=32, num_classes=8)
    if rh.get("mask_head"):
        rh["mask_head"].update(num_convs=2, in_channels=16, conv_out_channels=16, num_classes=8)
    if rh.get("semantic_head"):
        rh["semantic_head"].update(num_convs=2, in_channels=16, conv_out_channels=16,
                                   num_classes=5)
    if mask_roi:
        rh["mask_roi_extractor"] = dict(type="SingleRoIExtractor",
                                        roi_layer=dict(type="RoIAlign", output_size=14),
                                        out_channels=16, featmap_strides=[4, 8, 16, 32])
    rcnn = m["train_cfg"]["rcnn"]
    for tc in rcnn if isinstance(rcnn, list) else [rcnn]:
        tc["sampler"]["num"] = 32
    m["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    m["test_cfg"]["rcnn"]["max_per_img"] = 20
    return cfg


@pytest.mark.cuda
def test_cascade_request_on_the_card_matches_the_cpu():
    """The tiny Cascade R-CNN's request, 2 images of 64x96: B1 3 times (one
    a stage), the detections of the card held by the CPU's (boxes within
    1e-3 of the largest coordinate, scores within 1e-4, labels equal) for
    at least 95% of them."""
    from oadg_tpu_torch.apis import init_detector
    dev = _cuda()
    cfg = _tiny_twostage("configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py")
    gen = torch.Generator().manual_seed(5)
    batch = {"img": torch.randn(2, 3, 64, 96, generator=gen),
             "img_shape": torch.tensor([[64., 96.], [60., 90.]]),
             "scale_factor": torch.ones(2, 4)}
    outs = {}
    for where in ("cpu", dev):
        handle = init_detector(cfg, device=where, seed=0)
        b = {k: v.to(where) for k, v in batch.items()}
        before = ROI_ALIGN_FWD.launches_by_shape.get((7, 4), 0)
        outs[str(where)] = [t.cpu() for t in handle.test(b)]
        if where != "cpu":
            torch.cuda.synchronize()
            assert ROI_ALIGN_FWD.launches_by_shape[(7, 4)] - before == 3
    (cd, cl, cv), (gd, gl, gv) = outs["cpu"], outs[str(dev)]
    assert cv.any() and abs(int(cv.sum()) - int(gv.sum())) <= 1
    scale = float(cd[cv][:, :4].abs().max())
    held = 0
    for i in range(2):
        for d, lab in zip(gd[i][gv[i]], gl[i][gv[i]]):
            ok = ((cd[i][cv[i]][:, :4] - d[:4]).abs().max(1).values <= 1e-3 * scale) & \
                 ((cd[i][cv[i]][:, 4] - d[4]).abs() <= 1e-4) & (cl[i][cv[i]] == lab)
            held += bool(ok.any())
    assert held >= 0.95 * int(gv.sum())


@pytest.mark.cuda
def test_htc_step_on_the_card_matches_the_cpu():
    """The tiny HTC RoI head's losses (with 14x14 mask RoIs: B1 and B2 at
    7x7 and 14x14 on the pyramid and at 14x14 on the semantic level, three
    each) and every parameter's and FPN map's gradient on the card against
    the CPU, on the same seeded maps, proposals, gts, masks and draws:
    losses rtol 1e-4, gradients within 1e-4 of each largest magnitude."""
    from oadg_tpu_torch.models.roi_heads import HybridTaskCascadeRoIHead
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    m = _tiny_twostage("configs/htc/htc_r50_fpn_1x_coco.py", mask_roi=True)["model"]
    gen = torch.Generator().manual_seed(6)
    feats = [torch.randn(2, 16, 16 >> i, 24 >> i, generator=gen) for i in range(5)]
    gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 90., 60.], [50., 30., 80., 62.]],
                       [[0., 0., 30., 40.], [20., 20., 70., 60.], [0., 0., 0., 0.]]])
    gt_valid = torch.tensor([[True, True, True], [True, True, False]])
    labels = torch.tensor([[1, 2, 3], [4, 5, 0]])
    props = torch.cat([gt.repeat(1, 8, 1) + torch.randn(2, 24, 4, generator=gen) * 3,
                       torch.rand(2, 16, 2, generator=gen).mul(48).repeat(1, 1, 2)
                       + torch.tensor([0., 0., 20., 16.])], 1).clamp(0, 96)
    prop_valid = torch.ones(2, 40, dtype=torch.bool)
    masks = (torch.rand(2, 3, 28, 28, generator=gen) > 0.4).float()
    seeded = None
    outs = {}
    for where in ("cpu", dev):
        head = HybridTaskCascadeRoIHead(**{k: v for k, v in m["roi_head"].items() if k != "type"},
                                        train_cfg=m["train_cfg"]["rcnn"],
                                        test_cfg=m["test_cfg"]["rcnn"], device=where)
        if seeded is None:
            from oadg_tpu_torch.models.layers import init_default_
            init_default_(head, torch.Generator().manual_seed(0))
            head.init_weights(torch.Generator().manual_seed(1))
            seeded = {k: v.clone() for k, v in head.state_dict().items()}
        head.load_state_dict(seeded)
        fs = [f.to(where).contiguous(memory_format=torch.channels_last).requires_grad_(True)
              for f in feats]
        draws = UniformDraws(torch.Generator().manual_seed(7)) if where == "cpu" else \
            UniformDraws(given=outs["cpu"][2])
        before = dict(ROI_ALIGN_FWD.launches_by_shape)
        losses = head.loss(fs, props.to(where), prop_valid.to(where), gt.to(where),
                           gt_valid.to(where), labels.to(where), draws,
                           gt_masks=masks.to(where))
        sum(v for k, v in losses.items() if "loss" in k).backward()
        if where != "cpu":
            torch.cuda.synchronize()
            after = ROI_ALIGN_FWD.launches_by_shape
            assert {s: after.get(s, 0) - before.get(s, 0) for s in ((7, 4), (14, 4), (14, 1))} \
                == {(7, 4): 3, (14, 4): 3, (14, 1): 3}
        grads = {k: p.grad.detach().cpu() for k, p in head.named_parameters()
                 if p.grad is not None}
        grads.update({f"level{i}": f.grad.detach().cpu() for i, f in enumerate(fs[:4])})
        outs[str(where)] = ({k: float(v) for k, v in losses.items()}, grads,
                            {k: v.cpu() for k, v in draws.drawn.items()})
    (cl, cg, _), (gl, gg, _) = outs["cpu"], outs[str(dev)]
    assert cl.keys() == gl.keys() and all(math.isfinite(v) for v in gl.values())
    for k in cl:
        assert gl[k] == pytest.approx(cl[k], rel=1e-4, abs=1e-6), k
    assert cg.keys() == gg.keys() and len(cg) > 30
    for k, c in cg.items():
        torch.testing.assert_close(gg[k], c, rtol=0, atol=1e-4 * float(c.abs().max()) + 1e-12,
                                   msg=k)


SPARSE_MAPS = [(1024 >> (2 + i), 2048 >> (2 + i)) for i in range(4)]   # one 1024x2048 image


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernels_at_the_sparse_shape(dtype):
    """B1 and B2 at Sparse R-CNN's stage: 7x7 bins on one 1024x2048 image's
    four FPN maps (256x512 .. 32x64, 256 channels), R = 100 learned
    proposals (from the whole image down to small boxes), against their
    plain versions; each counts the launch under (7, 4)."""
    dev = _cuda()
    rng = np.random.RandomState(29)
    gen = torch.Generator(device=dev).manual_seed(29)
    feats = [torch.randn(1, 256, h, w, device=dev, generator=gen).to(dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in SPARSE_MAPS]
    r = 100
    bw = np.exp(rng.uniform(np.log(24), np.log(2048), r))
    bh = np.exp(rng.uniform(np.log(24), np.log(1024), r))
    x1, y1 = rng.uniform(0, 2048 - bw), rng.uniform(0, 1024 - bh)
    rois = torch.from_numpy(np.stack([np.zeros(r), x1, y1, x1 + bw, y1 + bh],
                                     1).astype(np.float32)).to(dev)
    before = (ROI_ALIGN_FWD.launches_by_shape.get((7, 4), 0),
              ROI_ALIGN_BWD.launches_by_shape.get((7, 4), 0))
    got = ROI_ALIGN_FWD(feats, rois, 7, STRIDES, 2, 56)
    want = roi_align_multilevel_ref(feats, rois, 7, STRIDES, 2, 56)
    fmax = max(float(f.float().abs().max()) for f in feats)
    torch.testing.assert_close(got, want, rtol=0, atol=(1e-5 if dtype == torch.float32
                                                        else 1e-4) * fmax)
    dy = torch.randn(r, 256, 7, 7, device=dev, generator=gen)
    grads = ROI_ALIGN_BWD(feats, rois, dy, 7, STRIDES, 2, 56)
    wants = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois, 7, STRIDES,
                                              2, 56)
    for g, w in zip(grads, wants):
        scale = float(w.abs().max()) or 1.0
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * scale)
        else:
            torch.testing.assert_close(g.float(), w, rtol=2 ** -8, atol=1e-4 * scale)
    assert (ROI_ALIGN_FWD.launches_by_shape[(7, 4)] - before[0],
            ROI_ALIGN_BWD.launches_by_shape[(7, 4)] - before[1]) == (1, 1)


def _tiny_sparse():
    import os
    from oadg_tpu_torch.config import load_config
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                   "configs/sparse_rcnn/sparse_rcnn_r50_fpn_1x_coco.py"))
    m = cfg["model"]
    m["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    m["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
    m["rpn_head"].update(num_proposals=20, proposal_feature_channel=16)
    m["roi_head"].update(num_stages=2, stage_loss_weights=[1.0, 1.0], proposal_feature_channel=16)
    m["roi_head"]["bbox_head"].update(num_classes=8, feat_channels=16, dim_feedforward=32,
                                      num_heads=4, dynamic_dim=8)
    m["test_cfg"] = dict(max_per_img=10)
    return cfg


def _step_card_vs_cpu(make, run, want_launches, draws_from_cpu=True):
    """``run(model, device, draws)`` -> losses of a model from ``make(device)``
    on the CPU and on the card with the same seeded weights and draws: the
    losses (rtol 1e-4) and every parameter's gradient (within 1e-4 of its
    largest magnitude) equal; B1's and B2's launches by (bins, levels) on
    the card as ``want_launches``."""
    from oadg_tpu_torch.models.layers import init_default_
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    seeded, outs = None, {}
    for where in ("cpu", dev):
        model = make(where)
        if seeded is None:
            init_default_(model, torch.Generator().manual_seed(0))
            model.init_weights(torch.Generator().manual_seed(1))
            seeded = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict({k: v.to(where) for k, v in seeded.items()})
        draws = (UniformDraws(torch.Generator().manual_seed(7)) if where == "cpu"
                 else UniformDraws(given=outs["cpu"][2]))
        before = {k: dict(v.launches_by_shape) for k, v in
                  (("fwd", ROI_ALIGN_FWD), ("bwd", ROI_ALIGN_BWD))}
        losses = run(model, where, draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        if where != "cpu":
            torch.cuda.synchronize()
            for k, w in (("fwd", ROI_ALIGN_FWD), ("bwd", ROI_ALIGN_BWD)):
                got = {s: n - before[k].get(s, 0) for s, n in w.launches_by_shape.items()
                       if n != before[k].get(s, 0)}
                assert got == want_launches, (k, got)
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        outs[str(where)] = ({k: v.item() for k, v in losses.items()}, grads,
                            {k: v.cpu() for k, v in draws.drawn.items()})
    (cl, cg, _), (gl, gg, _) = outs["cpu"], outs[str(dev)]
    assert cl.keys() == gl.keys() and all(math.isfinite(v) for v in gl.values())
    for k in cl:
        assert gl[k] == pytest.approx(cl[k], rel=1e-4, abs=1e-6), k
    assert cg.keys() == gg.keys() and len(cg) > 10
    for k, c in cg.items():
        torch.testing.assert_close(gg[k], c, rtol=0, atol=1e-4 * float(c.abs().max()) + 1e-12,
                                   msg=k)


def _seeded_batch(n=2):
    gen = torch.Generator().manual_seed(8)
    gt = torch.tensor([[[4., 6., 40., 50.], [30., 10., 90., 60.], [50., 30., 80., 62.]],
                       [[8., 4., 30., 40.], [20., 20., 70., 60.], [0., 0., 0., 0.]]])[:n]
    return {"img": torch.randn(n, 3, 64, 96, generator=gen),
            "img_shape": torch.tensor([[64., 96.], [60., 90.]])[:n],
            "scale_factor": torch.ones(n, 4), "gt_bboxes": gt,
            "gt_valid": torch.tensor([[True, True, True], [True, True, False]])[:n],
            "gt_labels": torch.tensor([[1, 2, 3], [4, 5, 0]])[:n],
            "gt_masks": (torch.rand(n, 3, 28, 28, generator=gen) > 0.4).float()}


@pytest.mark.cuda
def test_sparse_rcnn_step_on_the_card_matches_the_cpu():
    """The tiny Sparse R-CNN's ``forward_train`` (2 stages, P = 20, the
    matcher on the host) on the card against the CPU: B1 and B2 once a
    stage at 7x7 on the pyramid."""
    from oadg_tpu_torch.models import build_detector
    cfg = _tiny_sparse()
    batch = _seeded_batch()

    def run(model, where, draws):
        return model.forward_train({k: v.to(where) for k, v in batch.items()}, draws)

    _step_card_vs_cpu(lambda where: build_detector(cfg["model"], device=where), run,
                      {(7, 4): 2})


@pytest.mark.cuda
@pytest.mark.parametrize("rel", ["configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py",
                                 "configs/point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py"])
def test_grid_and_point_rend_steps_on_the_card_match_the_cpu(rel):
    """The tiny Grid R-CNN and PointRend RoI heads' losses on the card
    against the CPU, on the same seeded maps, proposals, gts, masks and
    draws (the points' too): B1 and B2 once at 7x7 and once at 14x14 on the
    pyramid (the grid branch's, the mask branch's)."""
    from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg
    m = _tiny_twostage(rel, mask_roi="point_rend" in rel)["model"]
    rh = m["roi_head"]
    if "grid" in rel:
        rh["grid_head"].update(in_channels=16, conv_out_channels=48, num_convs=2)
    else:
        rh["point_head"].update(in_channels=16, fc_channels=16, num_classes=8)
    batch = _seeded_batch()
    gen = torch.Generator().manual_seed(6)
    feats = [torch.randn(2, 16, 16 >> i, 24 >> i, generator=gen) for i in range(5)]
    gt = batch["gt_bboxes"]
    props = torch.cat([gt.repeat(1, 8, 1) + torch.randn(2, 24, 4, generator=gen) * 3,
                       torch.rand(2, 16, 2, generator=gen).mul(48).repeat(1, 1, 2)
                       + torch.tensor([0., 0., 20., 16.])], 1).clamp(0, 96)

    def make(where):
        return build_from_cfg(dict(rh, train_cfg=m["train_cfg"]["rcnn"],
                                   test_cfg=m["test_cfg"]["rcnn"]), HEADS, dict(device=where))

    def run(head, where, draws):
        fs = [f.to(where).contiguous(memory_format=torch.channels_last).requires_grad_(True)
              for f in feats]
        return head.loss(fs, props.to(where), torch.ones(2, 40, dtype=torch.bool, device=where),
                         gt.to(where), batch["gt_valid"].to(where), batch["gt_labels"].to(where),
                         draws, gt_masks=batch["gt_masks"].to(where) if "point" in rel else None)

    _step_card_vs_cpu(make, run, {(7, 4): 1, (14, 4): 1})


@pytest.mark.cuda
def test_trident_resnet_on_the_card_matches_the_cpu():
    """``TridentResNet`` at its published widths (depth 18's blocks) on a
    256x384 image, both modes, the card against the CPU within 1e-4 of the
    largest magnitude: (3, 2048, 8, 12) in train mode, the middle branch in
    test mode."""
    from oadg_tpu_torch.models.backbones import TridentResNet
    from oadg_tpu_torch.models.layers import init_default_
    dev = _cuda()
    net = TridentResNet(depth=18)
    init_default_(net, torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 256, 384, generator=torch.Generator().manual_seed(1))
    for mode in ("train", "test"):
        net.mode = mode
        with torch.no_grad():
            (want,) = net(x)
            (got,) = net.to(dev)(x.to(dev))
        net.cpu()
        assert got.shape == want.shape == ((3 if mode == "train" else 1), 2048, 8, 12)
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------ one-stage family ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_on_the_card_matches_the_cpu(dtype):
    """DCNv1 at VFNet's shape (C = 256 in and out, 3x3, stride 1) on 2 maps
    of 32x48 with star offsets of a few cells: the card's output and the
    gradients of the input, offsets and weight against the CPU's, float32
    within 1e-5 of each largest magnitude, bfloat16 within two bfloat16
    steps; the input's bfloat16 gradient within eight: it is a scatter-add
    of up to 36 contributions a pixel, each rounded to bfloat16 (on the H100
    4.1 steps from the float32 gradient, on the CPU 1.4)."""
    from oadg_tpu_torch.ops.deform_conv import deform_conv2d
    dev = _cuda()
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(2, 256, 32, 48, generator=gen).to(dtype)
    off = torch.randn(2, 18, 32, 48, generator=gen) * 3
    w = (torch.randn(256, 256, 3, 3, generator=gen) * 0.02).to(dtype)
    dy = torch.randn(2, 256, 32, 48, generator=gen)
    outs = {}
    for where in ("cpu", dev):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (x, off, w)]
        y = deform_conv2d(*leaves, padding=1)
        (y.float() * dy.to(where)).sum().backward()
        outs[str(where)] = [y.detach().float().cpu()] + [t.grad.float().cpu() for t in leaves]
    for name, g, c in zip(("y", "x", "offset", "weight"), outs[str(dev)], outs["cpu"]):
        assert torch.isfinite(g).all(), name
        print(f"DCNv1 {dtype} {name}: card vs CPU {float((g - c).abs().max()):.3e}, the "
              f"largest {float(c.abs().max()):.3e}")
        steps = 8 if name == "x" else 2
        tol = 1e-5 if dtype == torch.float32 else steps * 2 ** -8
        torch.testing.assert_close(g, c, rtol=0 if dtype == torch.float32 else 2 ** -7,
                                   atol=tol * float(c.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ga_deform_conv_of_4_groups_on_the_card_matches_the_cpu(dtype):
    """DCNv1 at GA-RetinaNet's feature adaption (C = 256 in and out, 3x3, 4
    deform groups: 72 offsets from its 1x1 ``conv_offset``) on 2 maps of
    32x48 with offsets of a few cells: the card's output and the gradients
    of the input, the offsets and the weight against the CPU's, with the
    tolerances of ``test_deform_conv_on_the_card_matches_the_cpu``."""
    from oadg_tpu_torch.ops.deform_conv import deform_conv2d
    dev = _cuda()
    gen = torch.Generator().manual_seed(23)
    x = torch.randn(2, 256, 32, 48, generator=gen).to(dtype)
    off = torch.randn(2, 72, 32, 48, generator=gen) * 3
    w = (torch.randn(256, 256, 3, 3, generator=gen) * 0.02).to(dtype)
    dy = torch.randn(2, 256, 32, 48, generator=gen)
    outs = {}
    for where in ("cpu", dev):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (x, off, w)]
        y = deform_conv2d(*leaves, padding=1, deform_groups=4)
        (y.float() * dy.to(where)).sum().backward()
        outs[str(where)] = [y.detach().float().cpu()] + [t.grad.float().cpu() for t in leaves]
    for name, g, c in zip(("y", "x", "offset", "weight"), outs[str(dev)], outs["cpu"]):
        assert torch.isfinite(g).all(), name
        print(f"DCNv1 4 groups {dtype} {name}: card vs CPU {float((g - c).abs().max()):.3e}, "
              f"the largest {float(c.abs().max()):.3e}")
        steps = 8 if name == "x" else 2
        tol = 1e-5 if dtype == torch.float32 else steps * 2 ** -8
        torch.testing.assert_close(g, c, rtol=0 if dtype == torch.float32 else 2 ** -7,
                                   atol=tol * float(c.abs().max()), msg=name)


def _tiny_onestage(rel):
    """A one-stage config of the repo made tiny: R18-FPN of 16 channels, a
    head of 64 channels (two a GroupNorm group: with one, a conv bias
    before the GN has a gradient of 0 plus noise) with one conv a tower
    (TOOD two: with one, its layer attention scales the whole input of a
    bias-free conv and a GN, and its gradient is 0 plus noise), 8
    classes; LD's teacher the same."""
    import os
    from oadg_tpu_torch.config import load_config
    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)), rel))
    m = cfg["model"]
    for part in [m] + ([m["teacher_config"]["model"]] if "teacher_config" in m else []):
        part["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
        part["neck"].update(in_channels=[16, 32, 64, 128], out_channels=16)
        part["bbox_head"].update(in_channels=16, feat_channels=64, num_classes=8,
                                 stacked_convs=2 if "tood" in rel else 1)
    return m


def _onestage_batch():
    gen = torch.Generator().manual_seed(11)
    gt = torch.tensor([[[16., 24., 160., 200.], [120., 40., 360., 240.], [200., 120., 320., 250.]],
                       [[32., 16., 120., 160.], [80., 80., 280., 240.], [0., 0., 0., 0.]]])
    return {"img": torch.randn(2, 3, 256, 384, generator=gen), "gt_bboxes": gt,
            "img_shape": torch.tensor([[256., 384.], [240., 360.]]),
            "gt_valid": torch.tensor([[True, True, True], [True, True, False]]),
            "gt_labels": torch.tensor([[1, 2, 3], [4, 5, 0]])}


ONESTAGE_CARD = ["configs/vfnet/vfnet_r50_fpn_1x_coco.py", "configs/tood/tood_r50_fpn_1x_coco.py",
                 "configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py",
                 "configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py"]


def _onestage_card_vs_cpu(rel, dtype):
    """The tiny model of ``rel`` in ``dtype`` on the card and on the CPU from
    the same seeded float32 weights (the classifier's bias at mmdet's 0.01
    prior, as ``chip_smoke.py`` trains them; TOOD's regression bias at 2,
    so that every point's box spans two strides a side and each gt's
    alignments come from IoUs, not from the 1e-9 tie-break of the IoU-less
    start, see ``test_onestage_step_on_the_card_matches_the_cpu``): one
    ``forward_train`` and its backward each -> [(losses, head gradients)]
    card first, then (float32 only, else None) the CPU head's gradients in
    float64 on the CPU's features; B1's and B2's launch counts must not
    move."""
    import copy
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.models.layers import init_default_
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    model = _tiny_onestage(rel)
    batch = _onestage_batch()
    seed_model = build_detector(model, device="cpu")
    init_default_(seed_model, torch.Generator().manual_seed(0))
    seed_model.init_weights(torch.Generator().manual_seed(1))
    head = seed_model.bbox_head
    prior = {"vfnet_cls": ("vfnet_cls",), "tood_cls": ("tood_cls", "cls_prob_module"),
             "gfl_cls": ("gfl_cls",)}          # FreeAnchor's retina_cls starts there
    with torch.no_grad():
        for name in next((v for k, v in prior.items() if hasattr(head, k)), ()):
            m = getattr(head, name)
            (m[2] if name == "cls_prob_module" else m).bias.fill_(-math.log(99))
        if hasattr(head, "tood_reg"):
            head.tood_reg.bias.fill_(2.0)
    before = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
    outs = []
    for where in (dev, "cpu"):
        det = build_detector(model, device=where, dtype=dtype)
        det.load_state_dict({k: v.to(where) for k, v in seed_model.state_dict().items()})
        det.train()
        b = {k: v.to(where) for k, v in batch.items()}
        b["img"] = b["img"].to(dtype)
        losses = det.forward_train(b, UniformDraws())
        sum(losses.values()).backward()
        outs.append((losses, {k: p.grad.float().cpu() for k, p in det.bbox_head.named_parameters()
                              if p.grad is not None}))
    torch.cuda.synchronize()
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == before
    g64 = None
    if dtype == torch.float32:
        extra = {}
        with torch.no_grad():
            feats = [f.double() for f in det.extract_feat(b["img"])]
            if hasattr(det, "teacher_model"):       # LD: the teacher's bin logits
                t = det.teacher_model
                extra["soft_targets"] = [s.double() for s in
                                         t.bbox_head(t.extract_feat(b["img"]))[1]]
        h64 = copy.deepcopy(det.bbox_head).double()
        h64.zero_grad()
        l64 = h64.loss(h64(feats), b["gt_bboxes"].double(), b["gt_valid"], b["gt_labels"],
                       **extra)
        sum(l64.values()).backward()
        g64 = {k: p.grad for k, p in h64.named_parameters() if p.grad is not None}
    return outs, g64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rel", ONESTAGE_CARD)
def test_onestage_step_on_the_card_matches_the_cpu(rel, dtype):
    """The tiny VFNet's (DCNv1, ATSS, the varifocal loss), TOOD's (the
    task decomposition, the aligned boxes' bilinear gather, the
    task-aligned targets), FreeAnchor's (the per-class ``box_prob``
    scatter, the top-50 anchor bags) and LD's (the GFL student and its
    teacher run under ``no_grad``, ``loss_ld``) ``forward_train`` on the
    card against the CPU,
    two 256x384 images (``_onestage_card_vs_cpu``): losses float32, rtol
    1e-4 in float32 and ``TOL_BF16_LOSS`` in bfloat16 (TOOD's 2**-4: its
    alignment is IoU ** 6, which multiplies a box's bfloat16 rounding six
    times; on the H100 2.07e-2 apart); the head's gradients float32 and
    finite, in float32 within 1e-4 of each largest of the CPU's (TOOD's
    layer attention 3e-4: its gradient sums a product over every position
    and channel of a level's stacked maps, 1.1e-4 apart on the H100), and
    the CPU's within 1e-4 of each largest of a float64 evaluation of its
    head on the same features: the case's positives sit away from any tie,
    so that the card and the CPU must pick the same.
    (With TOOD's regression bias at 0 most boxes are empty, every IoU 0,
    and the positives are picked by the 1e-9 centre-distance term alone,
    whose float32 rounding differs between the two: the CPU's float32
    gradients then sit up to 0.61 of their largest from float64's and the
    card's up to 6.8e-4 from the CPU's while the losses agree; ROADMAP C.) In
    bfloat16 a head gradient sums bfloat16-rounded products over every
    position with both signs (the tiny VFNet's per-level scales' are 0.35
    of their largest apart on the H100), and only finiteness is held. No B1
    or B2 launch. Each gradient's distance is printed (``-s``)."""
    ((lg, gg), (lc, gc)), g64 = _onestage_card_vs_cpu(rel, dtype)
    assert lg.keys() == lc.keys() and gg.keys() == gc.keys() and len(gc) >= 8
    f32 = dtype == torch.float32
    for k in lc:
        assert lg[k].dtype == torch.float32 and torch.isfinite(lg[k]), k
        np.testing.assert_allclose(float(lg[k]), float(lc[k]), rtol=1e-4 if f32 else (
            2 ** -4 if "tood" in rel else TOL_BF16_LOSS), atol=1e-6, err_msg=k)
    errs = {k: float((gg[k] - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for k, c in gc.items()}
    print(f"{rel} {dtype}: losses card {({k: float(v) for k, v in lg.items()})} CPU "
          f"{({k: float(v) for k, v in lc.items()})}; head gradients' distance over their "
          f"largest: {sorted(errs.items(), key=lambda kv: -kv[1])[:6]}")
    for k, e in errs.items():
        assert gg[k].dtype == torch.float32 and torch.isfinite(gg[k]).all(), k
        assert not f32 or e <= (3e-4 if "layer_attention" in k else 1e-4), (k, e)
    if f32:
        for k, c in gc.items():
            r = g64[k]
            assert float((c.double() - r).abs().max()) <= 1e-4 * float(r.abs().max()), k


ONESTAGE4_CARD = ["reppoints", "centernet", "cornernet", "centripetalnet"]


def _onestage4_card_vs_cpu(name, dtype):
    """The tiny model of ``torch_onestage_cases.tiny_model(name)``
    (RepPoints on R18-FPN-16, CenterNet on R18 with a 16-channel head, the
    corner heads on the narrowed Hourglass; 8 classes) in ``dtype`` on the
    card and on the CPU from the same seeded float32 weights, the
    classifier at mmdet's prior (RepPoints' at 0.01, the heatmaps at 0.1),
    on ``_onestage_batch``'s two 256x384 images: one ``forward_train`` (the
    Hourglass's and the corner pools' BNs live) and its backward each ->
    [(losses, head gradients)], card first. B1's and B2's launch counts
    must not move."""
    import torch_onestage_cases as oc
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.models.layers import init_default_
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    model = oc.tiny_model(name)
    seed_model = build_detector(model, device="cpu")
    init_default_(seed_model, torch.Generator().manual_seed(0))
    seed_model.init_weights(torch.Generator().manual_seed(1))
    head = seed_model.bbox_head
    with torch.no_grad():
        if hasattr(head, "reppoints_cls_out"):
            head.reppoints_cls_out.bias.fill_(-math.log(99))
        for b in ([head.heatmap_head[2].bias] if hasattr(head, "heatmap_head") else
                  [m[1].conv.bias for m in (*getattr(head, "tl_heat", ()),
                                             *getattr(head, "br_heat", ()))]):
            b.fill_(-math.log(9))
    batch = _onestage_batch()
    before = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
    outs = []
    for where in (dev, "cpu"):
        det = build_detector(model, device=where, dtype=dtype)
        det.load_state_dict({k: v.to(where) for k, v in seed_model.state_dict().items()})
        det.train()
        b = {k: v.to(where) for k, v in batch.items()}
        b["img"] = b["img"].to(dtype)
        losses = det.forward_train(b, UniformDraws())
        sum(losses.values()).backward()
        outs.append((losses, {k: p.grad.float().cpu() for k, p in det.bbox_head.named_parameters()
                              if p.grad is not None}))
    torch.cuda.synchronize()
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == before
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ONESTAGE4_CARD)
def test_onestage4_step_on_the_card_matches_the_cpu(name, dtype):
    """RepPoints' (two DCNv1s on the points, the point assignment, MaxIoU on
    the init boxes), CenterNet's (the gaussian targets, ``torch.exp`` on
    each side), CornerNet's and CentripetalNet's (the
    live-BN Hourglass, the corner pools' ``cummax``, the per-gt gaussians'
    ``amax`` scatter) ``forward_train`` on the card against the CPU
    (``_onestage4_card_vs_cpu``): losses float32 and finite, rtol 1e-4 in
    float32 and ``TOL_BF16_LOSS`` in bfloat16 (CornerNet's pull and push
    2**-4: hinges and squares over at most 3 gts' bfloat16 embeddings, each
    read at one cell, 2.1e-2 apart on the H100); the head's gradients
    float32 and finite, in float32 within 1e-4 of each largest of the CPU's
    (in bfloat16 only finiteness, as
    ``test_onestage_step_on_the_card_matches_the_cpu``), but for a conv bias
    before a GroupNorm (RepPoints' towers): its true gradient is 0, and
    both sides' are within 1e-4 of the head's largest gradient. Each
    gradient's distance is printed (``-s``)."""
    (lg, gg), (lc, gc) = _onestage4_card_vs_cpu(name, dtype)
    assert lg.keys() == lc.keys() and gg.keys() == gc.keys() and len(gc) >= 6
    f32 = dtype == torch.float32
    for k in lc:
        assert lg[k].dtype == torch.float32 and torch.isfinite(lg[k]), k
        rtol = 1e-4 if f32 else 2 ** -4 if k.endswith(("pull", "push")) else TOL_BF16_LOSS
        np.testing.assert_allclose(float(lg[k]), float(lc[k]), rtol=rtol, atol=1e-6, err_msg=k)
    errs = {k: float((gg[k] - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for k, c in gc.items()}
    print(f"{name} {dtype}: losses card {({k: float(v) for k, v in lg.items()})} CPU "
          f"{({k: float(v) for k, v in lc.items()})}; head gradients' distance over their "
          f"largest: {sorted(errs.items(), key=lambda kv: -kv[1])[:6]}")
    top = max(float(c.abs().max()) for c in gc.values())
    for k, e in errs.items():
        assert gg[k].dtype == torch.float32 and torch.isfinite(gg[k]).all(), k
        if f32 and re.fullmatch(r"(cls|reg)_convs\.\d+\.conv\.bias", k):
            assert max(float(gg[k].abs().max()), float(gc[k].abs().max())) <= 1e-4 * top, k
            continue
        assert not f32 or e <= 1e-4, (k, e)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["top", "bottom", "left", "right"])
def test_corner_pool_bfloat16_on_the_card_matches_the_cpu(direction):
    """``corner_pool`` on a bfloat16 map of CornerNet's shape (2 x 256 x 64
    x 128) with many ties (values on a grid of 1/8): the card's values equal
    the CPU's, and so do the tie rule's indices (torch's ``cummax`` takes
    the latest index of the running maximum on both), so the input's
    gradient (bfloat16, each the sum of the upstream gradients of the
    positions it is the maximum of) differs only by the order of those
    bfloat16 sums: within ``n * 2**-8 * max|dy|``, ``n`` the pooled axis's
    length (the most terms a sum can have)."""
    from oadg_tpu_torch.ops.misc_ops import corner_pool
    dev = _cuda()
    gen = torch.Generator().manual_seed(31)
    x = (torch.randint(-16, 16, (2, 256, 64, 128), generator=gen) / 8).to(torch.bfloat16)
    dy = torch.randn(2, 256, 64, 128, generator=gen).to(torch.bfloat16)
    outs = {}
    for where in ("cpu", dev):
        leaf = x.detach().to(where).requires_grad_(True)
        y = corner_pool(leaf, direction)
        y.backward(dy.to(where))
        outs[str(where)] = (y.detach().cpu(), leaf.grad.float().cpu())
    (yg, gg), (yc, gc) = outs[str(dev)], outs["cpu"]
    assert torch.equal(yg, yc)
    n = x.shape[2] if direction in ("top", "bottom") else x.shape[3]
    bound = n * 2 ** -8 * float(dy.float().abs().max())
    err = float((gg - gc).abs().max())
    print(f"corner_pool {direction} bf16: gradient card vs CPU {err:.3e} (bound {bound:.3e})")
    assert torch.isfinite(gg).all() and err <= bound


ONESTAGE5_CARD = ["yolof", "yolox", "ssd", "solo", "yolact"]
# YOLOX's f32 head gradients on the card sit up to 2.4e-4 of a leaf's
# largest from the CPU's (level 2's ``multi_level_conv_reg``, a stride-32
# map behind two live BNs; the JAX package's own CPU step sits 2.0e-4 from a
# float64 evaluation at the same layers): held at 5e-4
CARD_GRAD_TOL5 = {"yolox": 5e-4}
# YOLOX's bf16 losses on the card sit up to 3.5e-2 from the CPU's on the
# same assignment (``loss_obj`` 11.9954 against 11.6681, float32's
# 11.6639; ``loss_cls`` 0.6107 against 0.6326):
# its 77 live-BN convs of 8 to 128 channels each round to bf16, and the
# head's outputs sit up to 0.42 of their largest from float32 on the CPU,
# 0.62 on the card (``tests/torch_bf16_drift.py``, an H100): held at
# 2**-4, as TOOD's
CARD_BF16_LOSS_TOL5 = {"yolox": 2 ** -4}


def _assignment(name, head, outs, batch):
    """The part of ``name``'s assignment that reads the head's outputs (on
    the CPU): YOLOF's labels and class weights, YOLOX's SimOTA, SSD's
    positives and hard negatives; None for SOLO and YOLACT (theirs reads
    the gts alone)."""
    from oadg_tpu_torch.core.bbox.geometry import bbox_overlaps
    from oadg_tpu_torch.models.dense_heads.retina_head import _flatten
    gt, gv, gl = batch["gt_bboxes"], batch["gt_valid"], batch["gt_labels"]
    if name == "yolof":
        anchors = head.prior_generator.grid_priors_cat([tuple(outs[0][0].shape[-2:])],
                                                       outs[0][0].device)
        dec = head.bbox_coder.decode(anchors[None], _flatten(outs[1], 4))
        labels, _, cw, _ = head.targets(anchors, dec, gt, gv, gl)
        return torch.stack([labels.float(), cw])
    if name == "yolox":
        pts, strides, cls, reg, obj = head._flat(outs)
        ious = bbox_overlaps(head.decode(reg, pts, strides), gt)
        return head.assign(cls, obj, ious, pts, strides, gt, gv, gl)
    if name == "ssd":
        anchors, cls, _ = head._flat(outs)
        a = head.assigner.assign(anchors, gt, gv, gt_labels=gl)
        pos, neg = a.gt_inds > 0, a.gt_inds == 0
        labels = torch.where(pos, a.labels, torch.full_like(a.labels, head.num_classes))
        ce = -torch.gather(torch.log_softmax(cls, -1), -1, labels[..., None])[..., 0]
        return pos | head.hard_negatives(ce, pos, neg)
    return None


# the head methods through which each assignment reads the head's outputs
# (``_assignment``'s parts), by path under the head: the card's step takes
# the CPU's results from them, so that both devices' losses and gradients
# run on one assignment. SSD's assigner reads the anchors and gts alone, and
# is pinned with its hard negatives; SOLO's and YOLACT's targets read the
# gts alone.
PINNED5 = {"yolof": ["targets"], "yolox": ["assign"], "ssd": ["assigner.assign", "hard_negatives"]}


def _pin(head, path, log, device=None):
    """Puts a stand-in for the method at ``path`` under ``head``: with no
    ``device`` it appends each result to ``log``, else it returns ``log``'s
    results in turn, moved to ``device``, and computes nothing. -> a
    function that takes the stand-in away."""
    *parents, attr = path.split(".")
    obj = head
    for part in parents:
        obj = getattr(obj, part)
    real, given = getattr(obj, attr), iter(log)

    def pinned(*args, **kwargs):
        if device is not None:
            return torch.utils._pytree.tree_map(lambda t: t.to(device), next(given))
        log.append(real(*args, **kwargs))
        return log[-1]

    setattr(obj, attr, pinned)
    return lambda: delattr(obj, attr)


def _seeded5(name):
    """The tiny model of ``torch_onestage_cases.tiny_model(name)`` (a plain
    dict) and its seeded float32 detector on the CPU, the sigmoid
    classifiers at mmdet's 0.01 prior."""
    import torch_onestage_cases as oc
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.models.layers import init_default_
    model = oc.tiny_model(name)
    seed_model = build_detector(model, device="cpu")
    init_default_(seed_model, torch.Generator().manual_seed(0))
    seed_model.init_weights(torch.Generator().manual_seed(1))
    head = seed_model.bbox_head
    with torch.no_grad():
        convs = {"yolof": lambda: [head.cls_score], "solo": lambda: [head.conv_cls],
                 "yolox": lambda: [*head.multi_level_conv_cls, *head.multi_level_conv_obj]}
        for conv in convs.get(name, list)():
            conv.bias.fill_(-math.log(99))
    return model, seed_model


def _onestage5_card_vs_cpu(name, dtype):
    """The tiny model of ``torch_onestage_cases.tiny_model(name)`` (YOLOF on
    R18's C5 with its DilatedEncoder at 16 channels, YOLOX-S's CSPDarknet at
    ``widen_factor`` 0.125, SSD300 whole, SOLO and YOLACT on R18-FPN-16; 8
    classes) in ``dtype`` on the CPU and then on the card from the same
    seeded float32 weights, the sigmoid classifiers at mmdet's 0.01 prior,
    on ``_onestage_batch``'s two 256x384 images (SSD: its first image
    resized to 300x300; SOLO and YOLACT with seeded box-cropped masks): one
    ``forward_train`` (the live BNs on the batch) and its backward each, the
    card's assignment given the CPU's (``PINNED5``) -> [(losses, head
    gradients)], card first, then [the card's own assignment, the CPU's]
    (``_assignment``, each read on its device from its own head outputs
    after the step). B1's and B2's launch counts must not move."""
    import torch_onestage_cases as oc
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    model, seed_model = _seeded5(name)
    batch = _onestage_batch()
    if name == "ssd":
        batch = {k: v[:1] for k, v in batch.items()}
        batch["img"] = torch.nn.functional.interpolate(batch["img"], (300, 300), mode="bilinear")
        batch["gt_bboxes"] = batch["gt_bboxes"] * torch.tensor([300 / 384, 300 / 256] * 2)
    if name in ("solo", "yolact"):
        batch["gt_masks"] = torch.from_numpy(oc.with_masks(
            {"gt_labels": batch["gt_labels"].numpy()}, m0=28)["gt_masks"])
    before = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
    outs, picks, logs = [], [], {path: [] for path in PINNED5.get(name, [])}
    for where in ("cpu", dev):
        det = build_detector(model, device=where, dtype=dtype)
        det.load_state_dict({k: v.to(where) for k, v in seed_model.state_dict().items()})
        det.train()
        b = {k: v.to(where) for k, v in batch.items()}
        b["img"] = b["img"].to(dtype)
        unpin = [_pin(det.bbox_head, path, log, None if where == "cpu" else where)
                 for path, log in logs.items()]
        losses = det.forward_train(b, UniformDraws())
        sum(losses.values()).backward()
        for undo in unpin:
            undo()
        outs.insert(0, (losses, {k: p.grad.float().cpu()
                                 for k, p in det.bbox_head.named_parameters()
                                 if p.grad is not None}))
        with torch.no_grad():
            o = torch.utils._pytree.tree_map(lambda t: t.float(),
                                             det.bbox_head(det.extract_feat(b["img"])))
            p = _assignment(name, det.bbox_head, o, {k: v.to(where) for k, v in batch.items()})
        picks.insert(0, None if p is None else p.cpu())
    torch.cuda.synchronize()
    assert (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches) == before
    assert all(len(log) == 1 for log in logs.values())
    return outs + [picks]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ONESTAGE5_CARD)
def test_onestage5_step_on_the_card_matches_the_cpu(name, dtype):
    """YOLOF's (the DilatedEncoder's and the towers' live BNs, the uniform
    matching), YOLOX's (CSPDarknet, the PAFPN, SimOTA), SSD's (VGG-16, hard
    negatives), SOLO's (the antialiased category resize, the dice loss) and
    YOLACT's (the protonet, the 32-positive mask loss) ``forward_train`` on
    the card against the CPU (``_onestage5_card_vs_cpu``), the card's step
    on the CPU's assignment: losses float32 and finite, rtol 1e-4 in
    float32 and ``TOL_BF16_LOSS`` in bfloat16 (``CARD_BF16_LOSS_TOL5``);
    the head's gradients float32
    and finite, in float32 within 1e-4 of each largest of the CPU's
    (``CARD_GRAD_TOL5``; in bfloat16 only finiteness, as
    ``test_onestage_step_on_the_card_matches_the_cpu``), but for a conv bias
    before a GroupNorm or a live BN (SOLO's and YOLOF's towers): its true
    gradient is 0, and both sides' are within 1e-4 of the head's largest.
    Apart from that, each device's own assignment from its own head
    outputs: they round apart (and each decodes with its own ``exp``), so a
    decision at a near-tie can go either way (on this batch one of YOLOF's
    gts has its 4th and 5th smallest decoded-centre distances 8e-6 px apart
    on the CPU, and the card's decode moves one candidate): at most 1 in
    500 of the decisions differ in float32 and 1 in 100 in bfloat16 (the
    bound set from an H100's reading: YOLOF 1 of 1,920 in float32, 10 of
    1,920 in bfloat16; YOLOX 4 of 4,032 and SSD 4 of 8,732 in bfloat16).
    Each gradient's distance is printed (``-s``)."""
    (lg, gg), (lc, gc), (pg, pc) = _onestage5_card_vs_cpu(name, dtype)
    assert lg.keys() == lc.keys() and gg.keys() == gc.keys() and len(gc) >= 4
    f32 = dtype == torch.float32
    apart = 0 if pg is None else int((pg != pc).sum())
    errs = {k: float((gg[k] - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for k, c in gc.items()}
    print(f"{name} {dtype}: losses card {({k: float(v) for k, v in lg.items()})} CPU "
          f"{({k: float(v) for k, v in lc.items()})}; own assignments "
          f"{'equal' if not apart else f'{apart} of {pg.numel()} apart'}; head "
          f"gradients' distance over their largest: "
          f"{sorted(errs.items(), key=lambda kv: -kv[1])[:6]}")
    for k in lc:
        assert lg[k].dtype == torch.float32 and torch.isfinite(lg[k]), k
        np.testing.assert_allclose(float(lg[k].detach()), float(lc[k].detach()), rtol=1e-4 if f32
                                   else CARD_BF16_LOSS_TOL5.get(name, TOL_BF16_LOSS), atol=1e-6,
                                   err_msg=k)
    top = max(float(c.abs().max()) for c in gc.values())
    for k, e in errs.items():
        assert gg[k].dtype == torch.float32 and torch.isfinite(gg[k]).all(), k
        if f32 and re.fullmatch(r"(cls_convs|mask_convs|cls_subnet|bbox_subnet)\.\d+\.conv\.bias", k):
            assert max(float(gg[k].abs().max()), float(gc[k].abs().max())) <= 1e-4 * top, k
            continue
        assert not f32 or e <= CARD_GRAD_TOL5.get(name, 1e-4), (k, e)
    assert pg is None or apart <= pg.numel() / (500 if f32 else 100), apart


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_mask_matrix_nms_on_the_card_matches_the_cpu(kernel):
    """``mask_matrix_nms`` over 500 seeded blob masks of 128x192 (SOLO's
    ``nms_pre`` at a 256x384 request's level-0 mask size), 8 classes, 60
    padded rows: the intersection counts are a float32 product of 0/1
    masks, exact with TF32 off (``build_detector`` sets it; set here too),
    so the card picks the CPU's rows (keep indices, labels, valid, masks)
    and its decayed scores are within rtol 1e-6."""
    from oadg_tpu_torch.core.post_processing import mask_matrix_nms
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(14)
    n, h, w = 500, 128, 192
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx, r = rng.uniform(0, h, n), rng.uniform(0, w, n), rng.uniform(5, 40, n)
    masks = torch.from_numpy(((yy[None] - cy[:, None, None]) ** 2
                              + (xx[None] - cx[:, None, None]) ** 2) < r[:, None, None] ** 2)
    labels = torch.from_numpy(rng.randint(0, 8, n))
    scores = torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    valid[-60:] = False
    kw = dict(filter_thr=0.05, max_num=100, kernel=kernel, sigma=2.0)
    want = mask_matrix_nms(masks, labels, scores, valid=valid, **kw)
    got = mask_matrix_nms(masks.to(dev), labels.to(dev), scores.to(dev), valid=valid.to(dev), **kw)
    got = [t.cpu() for t in got]
    for i in (1, 2, 3, 4):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    assert int(want[4].sum()) > 20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msdeform_attention_on_the_card_matches_the_cpu(dtype):
    """Deformable DETR's multi-scale deformable attention (8 heads, 3 levels
    of 64x128, 32x64 and 16x32, 4 points, 1,000 queries) on the card against
    the CPU in the same dtype, on value maps of seeded noise with the
    offsets' bias drawn wide (~40% of the samples fall outside their level,
    where each corner outside reads 0): the output and the gradients of the
    query, the value tokens and the reference points. In float32 within
    1e-4 of each largest (``F.grid_sample`` sums its corners and the
    weights in another order on each device). In bfloat16 both devices
    round the offsets' product to bfloat16, as the JAX package does, and
    sample in float32; the two sum their products in other orders, so an
    offset may round one step apart (a quarter pixel at 128 columns) and
    every bfloat16 product one unit in the last place apart: within
    ``TOL_BF16_CARD`` of each largest. A wrong border or a wrong gradient
    moves ~40% of the samples, by the whole of a noise value."""
    from oadg_tpu_torch.models.dense_heads.deformable_detr_head import MSDeformAttention
    dev = _cuda()
    shapes = ((64, 128), (32, 64), (16, 32))
    gen = torch.Generator().manual_seed(21)
    mod = MSDeformAttention(256, 8, 3, 4)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(max(p.shape[-1], 1)))
        mod.sampling_offsets.bias.mul_(40.0)
    n = sum(h * w for h, w in shapes)
    inputs = [torch.randn(2, 1000, 256, generator=gen), torch.rand(2, 1000, 2, generator=gen),
              torch.randn(2, n, 256, generator=gen)]
    cot = torch.randn(2, 1000, 256, generator=gen)
    results = []
    for where in ("cpu", dev):
        m = MSDeformAttention(256, 8, 3, 4, device=where, dtype=dtype)
        m.load_state_dict(mod.state_dict())
        q, r, v = (t.detach().to(where).requires_grad_(True) for t in inputs)
        out = m(q.to(dtype), r, v.to(dtype), shapes)
        (out.float() * cot.to(where)).sum().backward()
        results.append([t.detach().float().cpu() for t in (out, q.grad, v.grad, r.grad)])
    tol = 1e-4 if dtype == torch.float32 else TOL_BF16_CARD
    for (want, got), what in zip(zip(*results), ("out", "query", "value", "ref")):
        assert torch.isfinite(got).all(), what
        err = float((got - want).abs().max()) / float(want.abs().max())
        print(f"msdeform {dtype} {what}: card vs CPU {err:.3e} of the largest")
        assert err <= tol, (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["detr", "deformable_detr", "panoptic_fpn"])
def test_detr_and_panoptic_steps_on_the_card_match_the_cpu(name):
    """The tiny DETR, Deformable DETR and PanopticFPN of
    ``torch_detr_cases`` (with mmdet's 14x14 mask RoI layer) on the card
    against the CPU, float32, the same weights and the CPU's sampler
    uniforms: every loss within rtol 1e-4, every trainable gradient within
    1e-4 of each largest (``F.grid_sample``, the convolutions and the FCs
    sum in other orders); B1 and B2 launch in PanopticFPN's step, never in
    the DETRs'; ``simple_test``'s outputs within 1e-4 of each largest."""
    import torch_detr_cases as dcases
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    model = dcases.torch_model(name)
    seed = build_detector(model, device="cpu")
    seed.init_weights(torch.Generator().manual_seed(0))
    batch = dcases.torch_batch(dcases.batch(semantic=name == "panoptic_fpn"))
    draws, outs = None, []
    for where in ("cpu", dev):
        det = build_detector(model, device=where)
        det.load_state_dict({k: v.to(where) for k, v in seed.state_dict().items()})
        det.train()
        b = {k: v.to(where) for k, v in batch.items()}
        before = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
        d = UniformDraws(torch.Generator().manual_seed(1)) if draws is None else \
            UniformDraws(given=draws)
        losses = det.forward_train(b, d)
        draws = {k: v.cpu() for k, v in d.drawn.items()}
        sum(v for k, v in losses.items() if "loss" in k).backward()
        if where == dev:
            torch.cuda.synchronize()
            launched = (ROI_ALIGN_FWD.launches - before[0], ROI_ALIGN_BWD.launches - before[1])
            assert (min(launched) > 0) == (name == "panoptic_fpn"), launched
        det.eval()
        with torch.no_grad():
            res = det.simple_test({k: b[k] for k in ("img", "img_shape", "scale_factor")})
        outs.append((losses, {k: p.grad.cpu() for k, p in det.named_parameters()
                              if p.grad is not None},
                     [t.float().cpu() for t in torch.utils._pytree.tree_leaves(res)]))
    (lc, gc, tc), (lg, gg, tg) = outs
    assert lg.keys() == lc.keys() and gg.keys() == gc.keys()
    for k in lc:
        assert torch.isfinite(lg[k]), k
        np.testing.assert_allclose(float(lg[k].detach()), float(lc[k].detach()), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k, c in gc.items():
        err = float((gg[k] - c).abs().max()) / max(float(c.abs().max()), 1e-30)
        assert err <= 1e-4 or float(c.abs().max()) < 1e-6, (k, err)
    for got, want in zip(tg, tc):
        assert float((got - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnest_step_on_the_card_matches_the_cpu(dtype):
    """The tiny ResNeSt Faster R-CNN of ``torch_backbone_cases`` (all four
    stages of split-attention bottlenecks at base width 8, the FPN and heads
    at 16 channels; the radix softmax in float32 in either dtype) on the
    card against the CPU in the same dtype, on the same weights and the
    CPU's sampler uniforms. The backbone's four maps within 1e-4 of each
    largest in float32, ``TOL_BF16_CARD`` in bfloat16 (the convolutions sum
    in other orders on each device); the step's losses float32 and finite,
    rtol 1e-4 in float32; in bfloat16 the RPN's (on the anchors, with the
    given uniforms) within ``TOL_BF16_LOSS``, the RoI head's finite (its
    proposals come through an NMS whose near-ties bfloat16 rounding moves
    on either device: on the CPU alone the bfloat16 step's ``loss_bbox``
    reads 0.078 against float32's 0.139); every
    trainable gradient float32 and finite, within 1e-4 of each largest in
    float32 (bfloat16: finiteness, as
    ``test_onestage5_step_on_the_card_matches_the_cpu``); the frozen stem
    convs, first stem BN and ``layer1`` without a gradient, the second and
    third stem BNs with one (the JAX ``frozen_mask``); B1 and B2 launched in
    the card's step. Each distance is printed (``-s``)."""
    import torch_backbone_cases as bcases
    from oadg_tpu_torch.models import build_detector
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = _cuda()
    model = bcases.torch_detector_model("resnest")
    seed = build_detector(model, device="cpu")
    seed.init_weights(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in bcases.batch("resnest").items()}
    batch["img"] = batch["img"].permute(0, 3, 1, 2).contiguous()
    draws, outs = None, []
    for where in ("cpu", dev):
        det = build_detector(model, device=where, dtype=dtype)
        det.load_state_dict({k: v.to(where) for k, v in seed.state_dict().items()})
        det.train()
        b = {k: v.to(where) for k, v in batch.items()}
        b["img"] = b["img"].to(dtype)
        with torch.no_grad():
            maps = [m.float().cpu() for m in det.backbone(b["img"])]
        before = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
        d = UniformDraws(torch.Generator().manual_seed(1)) if draws is None else \
            UniformDraws(given=draws)
        losses = det.forward_train(b, d)
        draws = {k: v.cpu() for k, v in d.drawn.items()}
        sum(v for k, v in losses.items() if "loss" in k).backward()
        if where == dev:
            torch.cuda.synchronize()
            launched = (ROI_ALIGN_FWD.launches - before[0], ROI_ALIGN_BWD.launches - before[1])
            assert min(launched) > 0, launched
        params = dict(det.named_parameters())
        assert params["backbone.stem.4.weight"].grad is not None
        assert all(p.grad is None for k, p in params.items() if not p.requires_grad)
        assert not params["backbone.stem.1.weight"].requires_grad
        assert not params["backbone.layer1.0.conv2.fc1.weight"].requires_grad
        outs.append((maps, losses, {k: p.grad.cpu() for k, p in params.items()
                                    if p.grad is not None}))
    (mc, lc, gc), (mg, lg, gg) = outs
    f32 = dtype == torch.float32
    for i, (g, c) in enumerate(zip(mg, mc)):
        err = float((g - c).abs().max()) / float(c.abs().max())
        print(f"resnest {dtype} C{i + 2}: card vs CPU {err:.3e} of the largest")
        assert err <= (1e-4 if f32 else TOL_BF16_CARD), (i, err)
    assert lg.keys() == lc.keys() and gg.keys() == gc.keys()
    print(f"resnest {dtype}: losses card {({k: float(v) for k, v in lg.items()})} CPU "
          f"{({k: float(v) for k, v in lc.items()})}")
    for k in lc:
        assert lg[k].dtype == torch.float32 and torch.isfinite(lg[k]), k
        if f32 or k.startswith("loss_rpn"):
            np.testing.assert_allclose(float(lg[k].detach()), float(lc[k].detach()),
                                       rtol=1e-4 if f32 else TOL_BF16_LOSS, atol=1e-6, err_msg=k)
    errs = {k: float((gg[k] - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for k, c in gc.items()}
    print(f"resnest {dtype}: gradients' distance over their largest: "
          f"{sorted(errs.items(), key=lambda kv: -kv[1])[:6]}")
    for k, e in errs.items():
        assert gg[k].dtype == torch.float32 and torch.isfinite(gg[k]).all(), k
        assert not f32 or e <= 1e-4 or float(gc[k].abs().max()) < 1e-6, (k, e)
