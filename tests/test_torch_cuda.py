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
``TOL_BF16_MAPS`` and ``TOL_BF16_LOSS``.
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _grid_inputs(dev, dtype, levels, c, seed=0, images=3, img_h=512, img_w=1024):
    """Maps of the first ``levels`` FPN levels of ``images`` images of
    img_h x img_w (a whole-image roi is level 3), C = ``c``, and the rois of
    ``_grid_rois``, with their dy."""
    rng = np.random.RandomState(seed)
    strides = STRIDES[:levels]
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(images, c, img_h // s, img_w // s, device=dev, generator=gen)
             .to(dtype).contiguous(memory_format=torch.channels_last) for s in strides]
    rois = torch.from_numpy(_grid_rois(rng, images, img_h, img_w)).to(dev)
    dy = torch.randn(rois.shape[0], c, 7, 7, device=dev, generator=gen)
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
