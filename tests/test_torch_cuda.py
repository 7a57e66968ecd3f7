"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip elsewhere. The machine with the
card has no JAX, so this file imports none, and it is run there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and the plain versions compute bit-identical tap
indices and weights and differ only in the order of the sums (the backward
kernel sums with atomics, in an order that changes from run to run), so
rtol=1e-5, atol=1e-6 for values of order 1; a bfloat16 gradient is the
rounding of such an f32 sum, so it is held to one bfloat16 rounding step.
"""
import numpy as np
import pytest
import torch

from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD,
                                          roi_align_multilevel,
                                          roi_align_multilevel_ref,
                                          roi_align_multilevel_ref_backward)

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
    # The kernel sums with f32 atomics in an order that changes from run to
    # run, so a cell where large contributions cancel can be off by a few
    # ulps of the largest gradient: the absolute limit scales with it.
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
