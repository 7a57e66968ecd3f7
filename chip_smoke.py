#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``oadg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, the torch and CUDA versions; turns TF32 off for matmuls and
   convolutions so float32 means float32.
2. build: compiles every CUDA kernel of the serving path from
   ``oadg_tpu_torch/ops/csrc/`` with nvcc.
3. kernels: each kernel against its plain PyTorch version at the flagship's
   serving shapes (one 1024x2048 image: FPN levels 256x512 .. 32x64, C=256,
   1000 rois), in float32 and with bfloat16 features; CUDA-event medians of
   both.
4. slice: ``init_detector`` on the flagship config (OA-DG Faster R-CNN
   R50-FPN, Cityscapes, 8 classes) with seeded random weights, one warm-up
   request, then 3 timed requests of 1024x2048 uint8 images through
   ``DetectorHandle.test``. Every kernel must have launched in those 3
   requests. One request's RoI head is run again with the plain RoIAlign and
   compared.
5. reference: the same seeded model on the CPU (plain PyTorch throughout,
   the path the CPU tests hold to the JAX package) against the card on a
   small 256x512 request: FPN outputs, and the RoI head on the card's
   proposals.
6. a JSON line of the kernels, the card's ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX and nothing of the JAX package.
"""
import json
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
# Kernel vs plain version, measured in this run (max abs error over the
# largest feature magnitude): float32 taps and weights are bit-identical, so
# only the sum order differs; bfloat16 features are widened to f32 on both
# sides before any arithmetic.
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
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD
    lib = ROI_ALIGN_FWD.library
    t0 = time.perf_counter()
    so = lib.build()
    log("build", f"{lib.source.relative_to(ROOT)} -> {so.name} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", f"ptxas: {line.strip()}")
    lib.load()


def flagship_rois(rng):
    """1000 seeded rois on one 1024x2048 image: ordinary boxes of log-uniform
    size plus edge, out-of-range, extreme-aspect, tiny and zero (padded)
    boxes, covering every level."""
    n_special = 100
    n = NUM_ROIS - n_special
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
    boxes = np.concatenate([boxes, np.asarray(special)], 0).astype(np.float32)
    return np.concatenate([np.zeros((NUM_ROIS, 1), np.float32), boxes], 1)


def phase_kernels():
    """Each kernel vs its plain version; returns the kernels' report rows."""
    import torch
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    rng = np.random.RandomState(0)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn(1, CHANNELS, IMG_H // s, IMG_W // s, device=dev,
                         generator=gen).contiguous(memory_format=torch.channels_last)
             for s in STRIDES]
    rois = torch.from_numpy(flagship_rois(rng)).to(dev)
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
        log("kernels", f"roi_align_fwd {name}: kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms (CUDA-event medians, R={NUM_ROIS})")
        if name == "f32":
            rows.append({"name": "roi_align_fwd", "route": "cuda",
                         "source": "oadg_tpu_torch/ops/csrc/roi_align_fwd.cu",
                         "replaces": "oadg_tpu/ops/pallas_roi_bwd.py:248",
                         "launches": None, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms})
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
    rows[0]["launches"] = launches

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
        cls_k, reg_k = head(det.roi_head.bbox_roi_extractor(feats, rois))
        ex = det.roi_head.bbox_roi_extractor
        cls_p, reg_p = head(roi_align_multilevel_ref(
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
