"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA card and skip elsewhere. The machine with the
card has no JAX, so this file imports none, and it is run there without the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: the kernel and the plain version compute bit-identical tap
indices and weights and differ only in the order of the final sums, so
rtol=1e-5, atol=1e-6 for values of order 1.
"""
import numpy as np
import pytest
import torch

from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_FWD, roi_align_multilevel,
                                          roi_align_multilevel_ref)

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
