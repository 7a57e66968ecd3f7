#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``oadg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, the torch and CUDA versions; turns TF32 off for matmuls and
   convolutions so float32 means float32.
2. build: compiles every CUDA kernel of the serving and training paths
   from ``oadg_tpu_torch/ops/csrc/``, one nvcc per source, all at once.
3. kernels: each kernel against its plain PyTorch version, in float32 and
   with bfloat16 features, with CUDA-event medians of both and the least
   time the card could take (the bytes the function must move over 3.35
   TB/s): B1 (RoIAlign forward) at the serving shapes (one 1024x2048 image:
   FPN levels 256x512 .. 32x64, C=256, 1000 rois), B2 (RoIAlign backward)
   at the training shapes (4 images, 2048 sampled + 40 random rois).
4. slice: ``init_detector`` on the flagship config (OA-DG Faster R-CNN
   R50-FPN, Cityscapes, 8 classes) with seeded random weights, one warm-up
   request, then 3 timed requests of 1024x2048 uint8 images through
   ``DetectorHandle.test``. B1 must have launched once per request. One
   request's RoI head is run again with the plain RoIAlign and compared.
5. reference: the same seeded model on the CPU (plain PyTorch throughout,
   the path the CPU tests hold to the JAX package) against the card on a
   small 256x512 request: FPN outputs, and the RoI head on the card's
   proposals.
6. train: the flagship built for training (``num_views=2``), SGD with the
   config's LR schedule through ``make_train_step``, one warm-up step and 3
   timed steps on 2 images x 2 views of 1024x2048 (view 2: the image with
   seeded noise, as OA-Mix is not ported yet; 32 seeded gts each). B1 and B2
   must each launch twice per step; losses finite, ``loss_cont`` > 0, every
   trainable parameter moved, every frozen one (stem, ``layer1``) unchanged.
   One more step checks B1's RoI features and B2's level gradients inside
   the path against the plain versions on the same inputs. Then one step
   under ``torch.profiler``: host and device time of each stage's
   ``record_function`` span, and the device's busy share.
7. train reference: one step of the same seeded model on the CPU and on the
   card, 2 x 2 views of 256x512, the draws made on the CPU and handed to
   both, the card's proposals used on both: losses, and the gradients of
   ``rpn_head.rpn_conv``, ``roi_head.bbox_head.fc_cls`` and
   ``backbone.layer4.*.conv3``.
8. a JSON line of the kernels, the card's ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX and nothing of the JAX package.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"
IMG_H, IMG_W = 1024, 2048
STRIDES = (4, 8, 16, 32)
CHANNELS = 256
NUM_ROIS = 1000
TRAIN_IMAGES = 4            # 2 images x 2 views
TRAIN_ROIS = 512            # rcnn sampler num, per image
RANDOM_ROIS = 10            # oagrb random proposals, per image
NUM_GTS = 32
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
CITYSCAPES_TRAIN_IMAGES = 2975
# Kernel vs plain version, measured in this run (max abs error over the
# largest magnitude of the result: feature for B1, gradient for B2):
# float32 taps and weights are bit-identical, so only the sum order differs
# (B2 sums with atomics, in an order that changes from run to run);
# bfloat16 features are widened to f32 before any arithmetic, and B2's
# bfloat16 gradient is the rounding of its f32 sum, so it may sit one
# bfloat16 step (2**-8 relative) from the rounding of the plain sum.
TOL_F32 = 1e-5
TOL_BF16 = 1e-4
# RoI head on kernel vs plain RoIAlign features, and the card vs the CPU,
# relative to the largest output magnitude (cuDNN, cuBLAS and the CPU sum
# convolutions and FC layers over up to 12544 inputs in other orders).
TOL_HEAD = 1e-4


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Median CUDA-event time of ``fn`` over ``iters`` runs, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    log("device", f"nvidia-smi: {nvidia_smi_line()}")
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", "TF32 off for matmul and cuDNN convolutions")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    libs = [ROI_ALIGN_FWD.library, ROI_ALIGN_BWD.library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc each, all at once
        built = list(pool.map(lambda lib: lib.build(), libs))
    log("build", f"{len(built)} libraries in {time.perf_counter() - t0:.2f} s "
                 "(one nvcc each, in parallel)")
    for lib, so in zip(libs, built):
        log("build", f"{lib.source.relative_to(ROOT)} -> {so.name}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"ptxas: {line.strip()}")
        lib.load()


def flagship_rois(rng, num=NUM_ROIS, image=0):
    """``num`` seeded rois on one 1024x2048 image: ordinary boxes of
    log-uniform size plus edge, out-of-range, extreme-aspect, tiny and zero
    (padded) boxes (a tenth), covering every level."""
    n_special = num // 10 // 5 * 5
    n = num - n_special
    w = np.exp(rng.uniform(np.log(4), np.log(1500), n))
    h = np.exp(rng.uniform(np.log(4), np.log(900), n))
    cx = rng.uniform(0, IMG_W, n)
    cy = rng.uniform(0, IMG_H, n)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    boxes = np.clip(boxes, 0, [IMG_W, IMG_H, IMG_W, IMG_H])
    special = []
    for i in range(n_special // 5):
        s = rng.uniform(20, 400)
        special += [
            [0, 0, s, s * 0.7],                            # top-left edge
            [IMG_W - s, IMG_H - s, IMG_W, IMG_H],           # bottom-right edge
            [-s, -0.5 * s, s, 0.5 * s],                     # out of range
            [10 + i, 100, 2000, 100 + 3 + i % 7],           # extreme aspect
            [500 + i, 300 + i, 500 + i + 0.5 * (i % 3), 300 + i],  # tiny / zero
        ]
    boxes = np.concatenate([boxes, np.asarray(special).reshape(-1, 4)],
                           0).astype(np.float32)
    return np.concatenate([np.full((num, 1), image, np.float32), boxes], 1)


def training_rois(rng):
    """The RoI head's rois of one training step at full size: 512 sampled
    per image and 10 random proposals per image over 4 images."""
    parts = [flagship_rois(rng, TRAIN_ROIS, b) for b in range(TRAIN_IMAGES)]
    parts += [flagship_rois(rng, RANDOM_ROIS, b) for b in range(TRAIN_IMAGES)]
    return np.concatenate(parts)


def distinct_taps(feat_shapes, rois):
    """How many distinct map cells (level, image, y, x) the in-range samples
    of ``rois`` read: the data-dependent part of B1's least memory traffic,
    and the cells B2's atomics read and write."""
    import torch
    from oadg_tpu_torch.ops.roi_align import _CHUNK, _Pyramid, _geometry
    pyr = _Pyramid(feat_shapes, STRIDES, rois.device)
    rows = []
    for i in range(0, rois.shape[0], _CHUNK):
        g = _geometry(pyr, rois[i:i + _CHUNK].float(), 7, 2, 56)
        for yi in (g.y0, g.y1):
            for xi in (g.x0, g.x1):
                rows.append(g.rows(yi, xi)[g.ok])
    return int(torch.unique(torch.cat(rows)).numel())


def bound_ms(nbytes):
    """Least time for ``nbytes`` of device-memory traffic on the card; both
    kernels' FLOPs are negligible beside it."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_kernels():
    """Each kernel vs its plain version; returns the kernels' report rows."""
    import torch
    from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD,
                                              roi_align_multilevel_ref,
                                              roi_align_multilevel_ref_backward)
    rng = np.random.RandomState(0)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn(1, CHANNELS, IMG_H // s, IMG_W // s, device=dev,
                         generator=gen).contiguous(memory_format=torch.channels_last)
             for s in STRIDES]
    rois = torch.from_numpy(flagship_rois(rng)).to(dev)
    shapes = [f.shape for f in feats]
    taps = distinct_taps(shapes, rois)
    rows = []
    for name, fs, tol in (("f32", feats, TOL_F32),
                          ("bf16", [f.bfloat16() for f in feats], TOL_BF16)):
        got = ROI_ALIGN_FWD(fs, rois, 7, STRIDES, 2, 56)
        want = roi_align_multilevel_ref(fs, rois, 7, STRIDES, 2, 56)
        torch.cuda.synchronize()
        fmax = max(float(f.float().abs().max()) for f in fs)
        err = float((got - want).abs().max())
        log("kernels", f"roi_align_fwd {name}: shape {tuple(got.shape)} "
                       f"max_abs_err {err:.3e} (limit {tol * fmax:.3e})")
        if not (torch.isfinite(got).all() and err <= tol * fmax):
            raise AssertionError(f"roi_align_fwd {name} disagrees with the "
                                 f"plain version: {err} > {tol * fmax}")
        ms = cuda_ms(lambda: ROI_ALIGN_FWD(fs, rois, 7, STRIDES, 2, 56), 50)
        plain_ms = cuda_ms(lambda: roi_align_multilevel_ref(fs, rois, 7, STRIDES,
                                                            2, 56), 10)
        # output written once, each distinct tap cell's channels read once
        nbytes = got.numel() * 4 + taps * CHANNELS * fs[0].element_size()
        log("kernels", f"roi_align_fwd {name}: kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms (CUDA-event medians, R={NUM_ROIS}); "
                       f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB, "
                       f"{taps} distinct tap cells)")
        if name == "f32":
            rows.append({"name": "roi_align_fwd", "route": "cuda",
                         "source": "oadg_tpu_torch/ops/csrc/roi_align_fwd.cu",
                         "replaces": "oadg_tpu/ops/pallas_roi_bwd.py:248",
                         "launches": None, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                         "library_ms": None})

    # B2 at the training shapes: 4 images, 2048 sampled + 40 random rois
    feats = [torch.randn(TRAIN_IMAGES, CHANNELS, IMG_H // s, IMG_W // s, device=dev,
                         generator=gen).contiguous(memory_format=torch.channels_last)
             for s in STRIDES]
    rois = torch.from_numpy(training_rois(rng)).to(dev)
    r = rois.shape[0]
    dy = torch.randn(r, CHANNELS, 7, 7, device=dev, generator=gen)
    shapes = [f.shape for f in feats]
    taps = distinct_taps(shapes, rois)
    table = sum(math.prod(sh) for sh in shapes)
    want = roi_align_multilevel_ref_backward(dy, shapes, rois, 7, STRIDES, 2, 56)
    scale = max(float(w.abs().max()) for w in want)
    for name, fs in (("f32", feats), ("bf16", [f.bfloat16() for f in feats])):
        got = ROI_ALIGN_BWD(fs, rois, dy, 7, STRIDES, 2, 56)
        torch.cuda.synchronize()
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        if name == "f32":
            limit = TOL_F32 * scale
            ok = err <= limit
        else:
            limit = TOL_BF16 * scale
            ok = all(bool(((g.float() - w).abs() <= 2 ** -8 * w.abs() + limit).all())
                     for g, w in zip(got, want))
        ok = ok and all(g.dtype == fs[0].dtype and g.shape == f.shape
                        and bool(torch.isfinite(g).all()) for g, f in zip(got, fs))
        log("kernels", f"roi_align_bwd {name}: {len(got)} levels, R={r}, "
                       f"max_abs_err {err:.3e} (limit {limit:.3e}"
                       f"{' + 2^-8 |value|' if name == 'bf16' else ''}; largest "
                       f"gradient {scale:.3e})")
        if not ok:
            raise AssertionError(f"roi_align_bwd {name} disagrees with the plain "
                                 f"version: {err} > {limit}")
        ms = cuda_ms(lambda: ROI_ALIGN_BWD(fs, rois, dy, 7, STRIDES, 2, 56), 20)
        plain_ms = cuda_ms(lambda: roi_align_multilevel_ref_backward(
            dy, shapes, rois, 7, STRIDES, 2, 56), 5)
        # The function's least traffic: dy read once, each level gradient
        # written once in the maps' dtype. The atomic design moves more: it
        # zeroes an f32 table, reads and writes each distinct tap cell, and
        # for bf16 reads the f32 table again to cast it.
        nbytes = dy.numel() * 4 + table * fs[0].element_size()
        design = (dy.numel() * 4 + table * 4 + 2 * taps * CHANNELS * 4
                  + (table * (4 + 2) if name == "bf16" else 0))
        log("kernels", f"roi_align_bwd {name}: kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms (CUDA-event medians, zeroed table "
                       f"included); bound {bound_ms(nbytes):.4f} ms "
                       f"({nbytes / 1e6:.1f} MB: dy {dy.numel() * 4 / 1e6:.1f}, "
                       f"gradient maps {table * fs[0].element_size() / 1e6:.1f}); "
                       f"the atomic design moves {design / 1e6:.1f} MB "
                       f"({bound_ms(design):.4f} ms; {taps} distinct tap cells)")
        if name == "f32":
            rows.append({"name": "roi_align_bwd", "route": "cuda",
                         "source": "oadg_tpu_torch/ops/csrc/roi_align_bwd.cu",
                         "replaces": "oadg_tpu/ops/pallas_roi_bwd.py:316",
                         "launches": None, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                         "library_ms": None})
    del feats, want, got
    torch.cuda.empty_cache()
    return rows


def request_image(rng):
    return rng.randint(0, 256, (IMG_H, IMG_W, 3), dtype=np.uint8)


def phase_slice(rows):
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    t0 = time.perf_counter()
    handle = init_detector(str(FLAGSHIP), device="cuda", seed=0)
    log("slice", f"init_detector (R50-FPN, 8 classes, f32, channels-last) in "
                 f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(1)
    handle.test(prepare_image(request_image(rng), handle.cfg, handle.device))
    torch.cuda.synchronize()                                  # warm-up request
    images = [request_image(rng) for _ in range(3)]

    ROI_ALIGN_FWD.launches = 0
    latencies, results = [], []
    for img in images:
        t0 = time.perf_counter()
        out = handle.test(prepare_image(img, handle.cfg, handle.device))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    launches = ROI_ALIGN_FWD.launches
    log("slice", f"3 requests of {IMG_H}x{IMG_W}: latency ms "
                 f"{[round(x, 3) for x in latencies]}, median "
                 f"{statistics.median(latencies):.3f}; roi_align_fwd launches {launches}")
    if launches != 3:
        raise AssertionError(f"roi_align_fwd launched {launches} times in 3 requests")
    rows[0]["launches_serving"] = launches

    for dets, labels, valid in results:
        if tuple(dets.shape) != (1, 100, 5) or not torch.isfinite(dets).all():
            raise AssertionError(f"bad dets: shape {tuple(dets.shape)}")
        if int(valid.sum()) < 1:
            raise AssertionError("no valid detection")
        if not ((labels[valid] >= 0) & (labels[valid] < handle.num_classes)).all():
            raise AssertionError("label out of range")
    log("slice", f"dets (1, 100, 5) finite; valid rows per request "
                 f"{[int(v.sum()) for _, _, v in results]}")

    # The same request's RoI head on plain-RoIAlign features: a check of the
    # kernel inside the path, not a fallback.
    with torch.inference_mode():
        batch = prepare_image(images[0], handle.cfg, handle.device)
        det = handle.model
        feats = det.extract_feat(batch["img"])
        cls_scores, bbox_preds = det.rpn_head(feats)
        boxes, _, _ = det.rpn_head.get_proposals(cls_scores, bbox_preds,
                                                 batch["img_shape"])
        rois = det.roi_head.proposals_to_rois(boxes)
        head = det.roi_head.bbox_head
        cls_k, reg_k, _ = head(det.roi_head.bbox_roi_extractor(feats, rois))
        ex = det.roi_head.bbox_roi_extractor
        cls_p, reg_p, _ = head(roi_align_multilevel_ref(
            feats[:len(ex.featmap_strides)], rois, 7, ex.featmap_strides,
            ex.sampling_ratio, ex.finest_scale))
    for name, a, b in (("cls_score", cls_k, cls_p), ("bbox_pred", reg_k, reg_p)):
        check_close("slice", f"RoI head {name} kernel vs plain RoIAlign", a, b)
    return handle


def check_close(phase, name, got, want):
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    lim = TOL_HEAD * max(float(want.abs().max()), 1e-6)
    log(phase, f"{name}: max_abs_err {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise AssertionError(f"{phase} {name} disagrees: {err} > {lim}")


def phase_reference(handle):
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    cpu = init_detector(str(FLAGSHIP), device="cpu", seed=0)
    img = request_image(np.random.RandomState(2))[:256, :512]
    bc = prepare_image(img, cpu.cfg, "cpu")
    bg = prepare_image(img, handle.cfg, handle.device)
    with torch.inference_mode():
        fc = cpu.model.extract_feat(bc["img"])
        fg = handle.model.extract_feat(bg["img"])
        for i, (a, b) in enumerate(zip(fg, fc)):
            check_close("reference", f"FPN level {i} card vs CPU", a, b)
        boxes, _, _ = handle.model.rpn_head.get_proposals(
            *handle.model.rpn_head(fg), bg["img_shape"])
        rois = handle.model.roi_head.proposals_to_rois(boxes)
        outs = [m.roi_head.bbox_head(m.roi_head.bbox_roi_extractor(f, r))
                for m, f, r in ((handle.model, fg, rois),
                                (cpu.model, fc, rois.cpu()))]
    for name, a, b in zip(("cls_score", "bbox_pred"), *outs):
        check_close("reference", f"RoI head {name} card vs CPU", a, b)


def train_batch(rng, h, w, cfg, device):
    """2 images x 2 views, views-major, through ``prepare_image``: seeded
    uint8 images, view 2 each image with seeded noise (OA-Mix is not ported
    yet), and 32 seeded gts of log-uniform size over the 8 classes, the same
    in both views."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    views = [np.clip(im.astype(np.int16) + rng.randint(-24, 25, im.shape), 0, 255)
             .astype(np.uint8) for im in images]
    parts = [prepare_image(im, cfg, device) for im in images + views]
    bw = np.exp(rng.uniform(np.log(16), np.log(w / 2), (2, NUM_GTS)))
    bh = np.exp(rng.uniform(np.log(16), np.log(h / 2), (2, NUM_GTS)))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    gt = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    labels = rng.randint(0, 8, (2, NUM_GTS))
    img = torch.cat([b["img"] for b in parts])
    if img.is_cuda:
        img = img.contiguous(memory_format=torch.channels_last)
    return {"img": img,
            "img_shape": torch.cat([b["img_shape"] for b in parts]),
            "gt_bboxes": torch.from_numpy(np.concatenate([gt, gt])).to(device),
            "gt_labels": torch.from_numpy(np.concatenate([labels, labels])).to(device),
            "gt_valid": torch.ones((4, NUM_GTS), dtype=torch.bool, device=device)}


def build_trainer(device, cfg):
    """The flagship built for OA-DG training with seeded random weights,
    SGD and the config's LR schedule, through the port's entry points."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    handle = init_detector(cfg, device=device, seed=0, num_views=cfg["num_views"])
    steps_per_epoch = -(-CITYSCAPES_TRAIN_IMAGES // cfg["data"]["samples_per_gpu"])
    step = make_train_step(
        handle.model, build_optimizer(handle.model, cfg["optimizer"]),
        build_lr_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], steps_per_epoch))
    return handle.model, step


class _Checked:
    """Stands in for a kernel wrapper for one step: launches the kernel,
    then holds its result against the plain version on the same inputs, so
    that each kernel is checked inside the path at the path's own shapes.
    ``plain(feats, rois, *rest)`` returns the plain results and the scale of
    the limit."""

    def __init__(self, name, kernel, plain):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.calls = []                  # (R, max abs error, limit)

    def __call__(self, feats, rois, *rest):
        out = self.kernel(feats, rois, *rest)
        want, scale = self.plain(feats, rois, *rest)
        got = out if isinstance(out, list) else [out]
        want = want if isinstance(want, list) else [want]
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        self.calls.append((rois.shape[0], err, TOL_F32 * scale))
        return out


def _plain_fwd(feats, rois, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref
    return (roi_align_multilevel_ref(feats, rois, *cfg),
            max(float(f.float().abs().max()) for f in feats))


def _plain_bwd(feats, rois, dy, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref_backward
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois, *cfg)
    return want, max(float(w.abs().max()) for w in want)


def phase_train(rows):
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    dev = torch.device("cuda", 0)
    cfg = load_config(FLAGSHIP)
    t0 = time.perf_counter()
    model, step = build_trainer("cuda", cfg)
    batch = train_batch(np.random.RandomState(3), IMG_H, IMG_W, cfg, dev)
    log("train", f"flagship for training (num_views {cfg['num_views']}, f32, "
                 f"channels-last) and a batch of 2 images x 2 views of "
                 f"{IMG_H}x{IMG_W} in {time.perf_counter() - t0:.2f} s")
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    frozen = [k for k, p in params.items() if not p.requires_grad]
    gen = torch.Generator(device=dev).manual_seed(0)
    step(batch, gen)                                           # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ROI_ALIGN_FWD.launches = ROI_ALIGN_BWD.launches = 0
    times, logs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        logs.append(step(batch, gen))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd, bwd = ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches
    peak = torch.cuda.max_memory_allocated()
    for i, lv in enumerate(logs):
        log("train", f"step {i + 1}: " + ", ".join(
            f"{k} {float(v):.5f}" for k, v in lv.items()))
    log("train", f"3 steps: ms {[round(t, 3) for t in times]}, median "
                 f"{statistics.median(times):.3f}; max_memory_allocated "
                 f"{peak / 2 ** 30:.2f} GiB; roi_align_fwd launches {fwd}, "
                 f"roi_align_bwd launches {bwd}")
    if (fwd, bwd) != (6, 6):
        raise AssertionError(f"3 steps launched roi_align_fwd {fwd} and "
                             f"roi_align_bwd {bwd} times, not 6 and 6")
    rows[0]["launches"], rows[1]["launches"] = fwd, bwd
    for lv in logs:
        if not all(bool(torch.isfinite(v).all()) for v in lv.values()):
            raise AssertionError(f"a loss is not finite: {lv}")
        if not float(lv["loss_cont"]) > 0:
            raise AssertionError("loss_cont is not positive")
    still = [k for k, p in params.items() if p.requires_grad
             and torch.equal(p.detach(), before[k])]
    moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
    log("train", f"{len(params) - len(frozen)} trainable parameters, "
                 f"{len(still)} unmoved; {len(frozen)} frozen (stem, layer1), "
                 f"{len(moved)} moved")
    if still or moved or not frozen:
        raise AssertionError(f"unmoved trainable {still[:5]}, moved frozen {moved[:5]}")

    # One more step with both kernels checked in place: B1's RoI features
    # and B2's level gradients against the plain versions on the same inputs
    # (the step's FPN maps, rois and dy).
    checks = (_Checked("roi_align_fwd", ROI_ALIGN_FWD, _plain_fwd),
              _Checked("roi_align_bwd", ROI_ALIGN_BWD, _plain_bwd))
    roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = checks
    step(batch, gen)
    roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = ROI_ALIGN_FWD, ROI_ALIGN_BWD
    torch.cuda.synchronize()
    for check in checks:
        for i, (r, err, lim) in enumerate(check.calls):
            log("train", f"{check.name} call {i} in the step (R={r}, 4 images): "
                         f"vs plain version max_abs_err {err:.3e} (limit {lim:.3e})")
            if not err <= lim:
                raise AssertionError(f"{check.name} in the step disagrees: {err} > {lim}")
        if len(check.calls) != 2:
            raise AssertionError(f"{len(check.calls)} {check.name} calls in a step")
    train_profile(step, batch, gen)
    del model, step, batch
    torch.cuda.empty_cache()


STAGES = ("forward_train: backbone+neck", "forward_train: rpn head+loss",
          "forward_train: proposals", "forward_train: roi head+loss",
          "train_step: backward", "train_step: sgd")


def train_profile(step, batch, gen):
    """One step under torch.profiler, read through the ``record_function``
    spans of ``forward_train`` and ``make_train_step``: per stage the host
    time of its span and the device time of the kernels launched in it, and
    the device's busy share of the step. Autograd launches the backward's
    kernels from its own thread, outside the backward span, so the
    backward's device time is the sum over autograd's ``evaluate_function``
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    autograd = sum(e.device_time_total for k, e in host.items()
                   if k.startswith("autograd::engine::evaluate_function")) / 1e3
    spanned = 0.0
    for name in STAGES:
        if name not in host:
            raise AssertionError(f"the profiled step has no span {name!r}")
        dev_ms = autograd if name == "train_step: backward" else \
            host[name].device_time_total / 1e3
        spanned += dev_ms
        log("train-profile", f"{name}: host {host[name].cpu_time_total / 1e3:.3f} ms, "
                             f"device {dev_ms:.3f} ms ({100 * dev_ms / busy:.1f}% of busy)")
    log("train-profile", f"profiled step {wall:.3f} ms wall, device busy "
                         f"{busy:.3f} ms ({100 * busy / wall:.1f}%), of which "
                         f"{busy - spanned:.3f} ms outside the stages")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log("train-profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
                             f"x{e.count:<5d} {e.key[:90]}")


def phase_train_reference():
    """One step's losses and gradients, CPU vs card, on 256x512 views."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = torch.device("cuda", 0)
    cfg = load_config(FLAGSHIP)
    card, _ = build_trainer("cuda", cfg)
    cpu, _ = build_trainer("cpu", cfg)
    batch = train_batch(np.random.RandomState(4), 256, 512, cfg, "cpu")
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    card_batch["img"] = card_batch["img"].contiguous(memory_format=torch.channels_last)

    # The card's proposals go to both: the sampler's draws are per candidate,
    # so proposals in another order (near-tied objectness of random weights)
    # would sample other rois. The CPU's own proposals are reported.
    proposals = {}
    card_props = card.rpn_head.get_proposals
    cpu_props = cpu.rpn_head.get_proposals

    def record(*args):
        proposals["card"] = card_props(*args)
        return proposals["card"]

    def replay(*args):
        proposals["cpu"] = cpu_props(*args)
        return tuple(t.cpu() for t in proposals["card"])

    card.rpn_head.get_proposals = record
    cpu.rpn_head.get_proposals = replay
    def one_step(model, b, draws):
        losses = model.forward_train(b, draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        return losses, dict(model.named_parameters())

    draws = UniformDraws(torch.Generator().manual_seed(7))       # made on the CPU
    lc, pc = one_step(card, card_batch, draws)
    lh, ph = one_step(cpu, batch, UniformDraws(given=draws.drawn))
    (bc, _, vc), (bh, _, vh) = proposals["card"], proposals["cpu"]
    same = (vc.cpu() == vh) & ((bc.cpu() - bh).abs().max(-1).values < 1e-2)
    log("train-reference", f"CPU proposals equal to the card's in place: "
                           f"{int(same.sum())} of {int(vc.sum())} valid")
    for k in sorted(lc):
        if "loss" not in k:
            continue
        a, b = float(lc[k].detach()), float(lh[k].detach())
        err = abs(a - b) / max(abs(b), 1e-6)
        log("train-reference", f"{k}: card {a:.6f} CPU {b:.6f} rel err {err:.2e} "
                               "(limit 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{k} card vs CPU: {a} vs {b}")
    names = [k for k in ph if k.startswith(("rpn_head.rpn_conv.",
                                            "roi_head.bbox_head.fc_cls."))
             or (k.startswith("backbone.layer4.") and ".conv3." in k)]
    for k in names:
        want = ph[k].grad
        err = float((pc[k].grad.cpu() - want).abs().max())
        lim = 1e-3 * float(want.abs().max())
        log("train-reference", f"grad {k}: max_abs_err {err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            raise AssertionError(f"grad {k} card vs CPU: {err} > {lim}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import oadg_tpu_torch.apis  # noqa: F401  (fails here outside a checkout)
    phase_device()
    phase_build()
    rows = phase_kernels()
    handle = phase_slice(rows)
    phase_reference(handle)
    del handle
    phase_train(rows)
    phase_train_reference()
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
