#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``oadg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, the torch and CUDA versions; turns TF32 off for matmuls and
   convolutions so float32 means float32.
2. build: compiles every CUDA kernel of the serving and training paths
   from ``oadg_tpu_torch/ops/csrc/`` (B1-B7, five sources), one nvcc per
   source, all at once.
3. kernels: each kernel against its plain PyTorch version, with its times,
   the least time the card could take (the bytes the function must move
   over 3.35 TB/s) and, where one PyTorch call computes the same function,
   that call's times. ``device_ms`` is the time per launch of a run of
   launches that the host enqueued while the device was kept busy, one
   CUDA-event pair around the run (``device_time``); ``host_us`` is the host
   clock per call of the wrapper; kernel and library call are timed in turns
   (kernel, library, library, kernel) over three rounds, the median and the
   rounds' least and largest printed; the time of one launch from an idle
   device, wrapper included, stands beside them. B1 (RoIAlign forward) at the
   serving shapes (one 1024x2048 image: FPN levels 256x512 .. 32x64, C=256,
   1000 rois, the report's case) and at the training step's two calls (4
   images, 2048 sampled and 40 random rois); B2 (RoIAlign backward) at the
   training shapes (4 images, both calls' 2088 rois, the report's case), at
   each of the two calls and at 2048 rois whose positives cluster around 32
   gts; each f32 and bf16, each beside its bound and the bytes its design
   moves; B2 must give equal bits in two calls. B3 (OA-Mix foreground maps, G=16 on
   1024x2048: the seeded gts' blurred profiles, then dense ones; with the
   mean number of live boxes a 16x256 tile, a row and a lane's 8 pixels),
   B4 (row shift: x and column passes at the rotate
   shifts of severity 10 and the translate shifts, on uint8 3-channel and
   float32 4-channel images; library call ``F.grid_sample``), B5 (per-box
   row shift on B3's own ``best_id``: the three passes of a per-box rotate,
   uint8 then float32 3-channel, the column pass on uint8, and the x pass on
   a chain-like image of flat blocks; ``F.grid_sample``), B6 (256-bin
   histograms of a 1024x2048x3 uint8 image: random, then the chain-like
   image and a constant one; ``torch.bincount`` on the random one) and B7
   (merged row shift on the float32 4-channel image with B3's ``best_id`` as
   the composite id: per-box x and column passes, a background pass, the
   identity, three slots with mixed flags, and the per-box x pass on the
   chain-like image; ``F.grid_sample``). B5 and B7 must take their fast
   route (the kernel specialised for these shapes) in every case.
4. slice: ``init_detector`` on the flagship config (OA-DG Faster R-CNN
   R50-FPN, Cityscapes, 8 classes) with seeded random weights, once in
   float32 and once with ``dtype=torch.bfloat16`` (the JAX package's bench
   precision: bfloat16 convolutions and FCs, frozen BN folded, float32
   parameters), each with one warm-up request, then 3 timed requests of
   1024x2048 uint8 images through ``DetectorHandle.test``. B1 must have
   launched once per request, entered with maps of the model's dtype. One
   request's RoI head is run again with the plain RoIAlign on the same maps
   and compared.
5. reference: each dtype's seeded model on the CPU (plain PyTorch
   throughout, the path the CPU tests hold to the JAX package) against the
   card on a small 256x512 request: FPN outputs, and the RoI head on the
   card's proposals.
6. oamix: ``oamix_batch`` with the flagship's ``oamix_config`` on 2 seeded
   1024x2048 uint8 images with 32 seeded gts each, inside
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), once per
   chain: on the slots chain B3-B6 launch exactly as often as the drawn
   table implies and B7 never; on the merged chain B3, B6 and B7 do and B4
   and B5 never; outputs uint8 of the expected shape, boxes inside the
   image. Then, per chain, one table per op index (every slot drawing op k)
   with B3-B7 checked in place against their plain versions; the merged
   chain against the slots chain on one table (differ by at most 1 on at
   most 1e-4 of values); then each chain on the card against the CPU on one
   table at 256x512.
7. train: the flagship built for training (``num_views=2``), SGD with the
   config's LR schedule through ``make_train_step(...,
   preprocess=make_oadg_preprocess(oamix_config, img_norm_cfg,
   out_dtype=model.dtype))``, in float32 and then in bfloat16 (one model
   each): one warm-up step and 3 timed steps on uint8 batches of 2 images
   of 1024x2048 (OA-Mix makes view 2; 32 seeded gts each), first with
   OA-Mix on the slots chain, then the same again on the merged chain
   (``make_oadg_preprocess(..., chain="merged")``). B1 and B2 must each
   launch twice per step, entered with maps of the model's dtype, and B3-B7
   as often as each step's table implies for its chain; losses finite
   float32, ``loss_cont`` > 0, parameters and gradients float32, every
   trainable parameter moved, every frozen one (stem, ``layer1``)
   unchanged. One more step checks B1's RoI features and B2's level
   gradients inside the path against the plain versions on the same inputs.
   After both dtypes' timed steps, one step per dtype and chain under
   ``torch.profiler``: host and device time of each stage's
   ``record_function`` span (OA-Mix included), and the device's busy share;
   then one profiled request per dtype (the device's busy share of a
   request), and a line of step medians, ``max_memory_allocated`` and busy
   shares.
8. train reference: per dtype, one step of the same seeded model on the
   CPU and on the card, 2 x 2 fixed views of 256x512 (no OA-Mix), the draws
   made on the CPU and handed to both, the card's proposals used on both:
   losses, and the gradients of ``rpn_head.rpn_conv``,
   ``roi_head.bbox_head.fc_cls`` and ``backbone.layer4.*.conv3``.
9. profiled: the times that need ``torch.profiler`` (the plain versions
   of B1 and B2, on float32 and on bfloat16 maps, and ``torch.bincount`` wait for the device inside a call, so
   a run of them cannot be queued ahead: their device time is the sum of
   their kernels' durations). Last, because the profiler's tracing stays
   attached to the process and slows every later launch on the host.
10. a JSON line of the kernels, the card's ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels-only`` runs phases 1-3 and 9 and prints the
kernels' JSON line and no result line: for work on one kernel.

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
# (the kernels contract separably, the plain versions tap by tap; B2 sums in
# a fixed order, so its bits repeat from call to call); bfloat16 features
# are widened to f32 before any arithmetic, and B2's bfloat16 gradient is
# the rounding of its f32 sum, so it may sit one bfloat16 step (2**-8
# relative) from the rounding of the plain sum.
TOL_F32 = 1e-5
TOL_BF16 = 1e-4
# RoI head on kernel vs plain RoIAlign features, and the card vs the CPU,
# relative to the largest output magnitude (cuDNN, cuBLAS and the CPU sum
# convolutions and FC layers over up to 12544 inputs in other orders).
TOL_HEAD = 1e-4
# The same with bfloat16 FCs: the kernel's and the plain version's float32
# features differ in their last bits, which moves a bfloat16 input or output
# by one step (2**-8 relative) where it lands on a rounding boundary.
TOL_HEAD_BF16 = 2 ** -6
# bfloat16 on the card against bfloat16 on the CPU, relative to the largest
# magnitude: cuDNN / cuBLAS and the CPU sum in float32 in other orders and
# round once; a value one step apart travels through the following layers.
# Losses (same proposals and draws on both) 2**-6 relative.
TOL_BF16_CARD = 2 ** -4
TOL_BF16_LOSS = 2 ** -6
# B4 and B5 vs their plain versions, absolute on values up to 255: the
# kernels fuse the lerp's multiply-add (one rounding), the plain versions
# emulate it in float64 and round a float32 tie a second time, at most one
# float32 ulp (1.5e-5 at 255).
TOL_WARP = 1e-4


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def idle_launch_ms(fn, iters=20):
    """One launch from an idle device, wrapper included: the median
    CUDA-event time of single calls of ``fn(i)``, each started after a
    synchronise. The start event completes at once on the idle device, so
    this is the wrapper's host time to reach the launch plus the kernel; it
    is kept beside ``device_ms`` for comparison with earlier records."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class HostBound(RuntimeError):
    """The host did not enqueue a run of launches before the device began
    it, so the run's elapsed time would be the host's."""


_SPIN = {}


def _spin(ms):
    """Keeps the device busy for about ``ms`` on the current stream."""
    import torch
    if "cycles_per_ms" not in _SPIN:
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))


def _queued_run(fn, n, ring, head_ms):
    """``n`` calls ``fn(i)`` enqueued while the device spins for
    ``head_ms``, one event pair around them. -> (device ms per call, median
    host us per call, whether every call was enqueued before the device
    reached the first). The last ``ring`` results stay alive, so that the
    allocator hands out ``ring`` output buffers in turn."""
    import torch
    kept = [None] * ring
    host = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _spin(head_ms)
    start.record()
    for i in range(n):
        t0 = time.perf_counter()
        kept[i % ring] = fn(i)
        host.append(time.perf_counter() - t0)
    ahead = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, statistics.median(host) * 1e6, ahead


def _profiled_run(fn, n, ring):
    """The device time per call as the sum of the durations of every kernel
    and copy ``torch.profiler`` saw in ``n`` calls, for a call that
    synchronises inside and so cannot be queued ahead. -> (device ms per
    call, median host us per call, synchronises included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kept = [None] * ring
    host = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            t0 = time.perf_counter()
            kept[i % ring] = fn(i)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
    if not busy > 0:
        raise RuntimeError("torch.profiler saw no device time")
    return busy / 1e3 / n, statistics.median(host) * 1e6


def device_time(fn, n, ring=3, method=None):
    """``fn``'s time per call with the device never idle between calls. ->
    {"device_ms", "host_us", "timer"}.

    ``timer`` "events": ``n`` calls are enqueued behind a head start (the
    device spins meanwhile) that is 1.5 times what the host took to enqueue
    a first run of ``n``, and one CUDA-event pair around them is divided by
    ``n``. The run counts only if the start event had not completed when the
    last call was enqueued: then the device found every launch waiting and
    the time is its own, whatever the host's speed. A run that fails this is
    made again with the head doubled and half the calls (a plain version of
    hundreds of small kernels fills CUDA's launch queue, and the host
    then waits for the device), four times before it is refused
    (``HostBound``). ``timer`` "profiler" (asked
    for with ``method``, for a call that synchronises inside): the sum of
    the kernels' own durations from ``torch.profiler``. ``host_us`` is the
    median host-clock time of one call (enqueue only, no synchronise)."""
    import torch
    fn(0)
    if method == "profiler":
        ms, host_us = _profiled_run(fn, n, ring)
        return {"device_ms": ms, "host_us": host_us, "timer": "profiler"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = [None] * ring
    for i in range(n):
        kept[i % ring] = fn(i)
    head_ms = 1.0 + 1.5e3 * (time.perf_counter() - t0)
    del kept
    for _ in range(5):
        ms, host_us, ahead = _queued_run(fn, n, ring, head_ms)
        if ahead:
            return {"device_ms": ms, "host_us": host_us, "timer": "events"}
        head_ms, n = head_ms * 2, max(1, n // 2)
    raise HostBound(f"not even {n} calls were enqueued within a head start of "
                    f"{head_ms / 2:.1f} ms: the call synchronises or the host stalls")


TIMER_ROUNDS = 3


def in_turns(fns, n, ring=3):
    """Times the candidates ``fns`` (name -> ``fn(i)``) in turns: each of
    ``TIMER_ROUNDS`` rounds runs them a, b, b, a (``device_time`` each) and
    reads each candidate as the mean of its two runs. -> name ->
    {"device_ms": median of the rounds, "spread": [min, max] of the rounds,
    "host_us": median of the rounds, "timer"}."""
    names = list(fns)
    rounds = {k: [] for k in names}
    for _ in range(TIMER_ROUNDS):
        got = {k: [] for k in names}
        for k in names + names[::-1]:
            got[k].append(device_time(fns[k], n, ring))
        for k in names:
            rounds[k].append({key: statistics.mean(g[key] for g in got[k])
                              for key in ("device_ms", "host_us")} | {"timer": got[k][0]["timer"]})
    out = {}
    for k in names:
        ms = [r["device_ms"] for r in rounds[k]]
        out[k] = {"device_ms": statistics.median(ms), "spread": [min(ms), max(ms)],
                  "host_us": statistics.median(r["host_us"] for r in rounds[k]),
                  "timer": rounds[k][0]["timer"]}
    return out


def time_kernel(kernel, plain, library=None, n=50, plain_n=5, ring=3):
    """The numbers of one case: the kernel and, where there is one, the
    library call in turns (``in_turns``), the plain version by the same
    timer in a run of its own, and the single-launch time of kernel and
    library call. All take the iteration index, to rotate their inputs.
    ``plain`` and ``library`` are None where the call cannot be queued ahead
    of the device: ``phase_profiled`` times those after the path. -> the
    row's timing keys."""
    fns = {"kernel": kernel}
    if library is not None:
        fns["library"] = library
    got = in_turns(fns, n, ring)
    k = got["kernel"]
    out = {"ms": k["device_ms"], "device_ms": k["device_ms"], "host_us": k["host_us"],
           "spread": k["spread"], "timer": k["timer"],
           "idle_launch_ms": idle_launch_ms(kernel),
           "plain_ms": device_time(plain, plain_n, ring)["device_ms"] if plain else None,
           "library_ms": None, "library_host_us": None, "library_spread": None,
           "library_timer": None, "library_idle_launch_ms": None}
    if library is not None:
        lib = got["library"]
        out.update(library_ms=lib["device_ms"], library_host_us=lib["host_us"],
                   library_spread=lib["spread"], library_timer=lib["timer"],
                   library_idle_launch_ms=idle_launch_ms(library))
    return out


def timing_text(t, library_name=None):
    """One case's timing keys as a log fragment."""
    text = (f"kernel device {t['device_ms']:.4f} ms (rounds {t['spread'][0]:.4f}-"
            f"{t['spread'][1]:.4f}, timer {t['timer']}), host {t['host_us']:.1f} us a call, "
            f"one launch from an idle device, wrapper included, {t['idle_launch_ms']:.4f} ms")
    if t["plain_ms"] is not None:
        text += f"; plain {t['plain_ms']:.4f} ms"
    if t["library_ms"] is not None:
        text += (f"; {library_name} device {t['library_ms']:.4f} ms (rounds "
                 f"{t['library_spread'][0]:.4f}-{t['library_spread'][1]:.4f}, timer "
                 f"{t['library_timer']}), host {t['library_host_us']:.1f} us, one launch "
                 f"from an idle device {t['library_idle_launch_ms']:.4f} ms")
    return text


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
    from oadg_tpu_torch.ops import fg_maps, hist, warp
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    libs = [ROI_ALIGN_FWD.library, ROI_ALIGN_BWD.library, fg_maps.FG_MAPS.library,
            warp.SHEAR_ROWS.library, hist.HIST256.library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc each, all at once
        built = list(pool.map(lambda lib: lib.build(), libs))
    log("build", f"{len(built)} libraries in {time.perf_counter() - t0:.2f} s "
                 "(one nvcc each, in parallel)")
    for lib, so in zip(libs, built):
        log("build", f"{lib.source.relative_to(ROOT)} -> {so.name}")
        spills = 0
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                log("build", f"ptxas: {line.strip().split('Compiling entry function ')[1]}")
            if "registers" in line or "spill" in line:
                log("build", f"ptxas:   {line.strip()}")
            if "spill" in line:
                spills += sum(int(tok) for tok, nxt in zip(line.split(), line.split()[1:])
                              if tok.isdigit() and nxt == "bytes")
        log("build", f"{lib.source.name}: {spills} bytes of stack, spill stores and spill "
                     "loads in all its kernels")
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


def clustered_rois(rng, image):
    """The RoI sampler's rois of one image where positives cluster: 128 of
    ``TRAIN_ROIS`` jittered around ``NUM_GTS`` seeded gts (4 each, every
    side moved by at most a tenth of the gt's size, so IoU >= 0.5), the rest
    as ``flagship_rois``."""
    gt = seeded_gts(rng, 1, IMG_H, IMG_W)[0][0].astype(np.float64)
    k = np.repeat(np.arange(NUM_GTS), 4)
    size = np.stack([gt[k, 2] - gt[k, 0], gt[k, 3] - gt[k, 1]] * 2, 1)
    pos = gt[k] + rng.uniform(-0.1, 0.1, (len(k), 4)) * size
    pos = np.concatenate([np.full((len(k), 1), image), pos], 1).astype(np.float32)
    return np.concatenate([pos, flagship_rois(rng, TRAIN_ROIS - len(k), image)])


def roi_tap_counts(feat_shapes, rois, tile=8):
    """What this run's rois read and write, for the bounds and the design
    bytes: (distinct map cells (level, image, y, x) read by their in-range
    taps; the sum over rois of each roi's distinct tap rows x distinct tap
    columns, the cells B1 reads; the sum over the tiles of B2's lists of the
    dy bins a tile stages per channel)."""
    import torch
    from oadg_tpu_torch.ops.roi_align import _CHUNK, _Pyramid, _geometry
    pyr = _Pyramid(feat_shapes, STRIDES, rois.device)
    rows, fwd_cells, staged = [], 0, 0
    for i in range(0, rois.shape[0], _CHUNK):
        g = _geometry(pyr, rois[i:i + _CHUNK].float(), 7, 2, 56)
        for yi in (g.y0, g.y1):
            for xi in (g.x0, g.x1):
                rows.append(g.rows(yi, xi)[g.ok])
        oky, okx = g.ok.any(2).cpu().numpy(), g.ok.any(1).cpu().numpy()
        per_axis = []
        for ok, taps in ((oky, (g.y0, g.y1)), (okx, (g.x0, g.x1))):
            lo, hi = (t.reshape(t.shape[0], -1).cpu().numpy() for t in taps)
            both = np.where(np.concatenate([ok, ok], 1), np.concatenate([lo, hi], 1), -1)
            both.sort(1)
            distinct = ((both >= 0) & (np.diff(both, axis=1, prepend=-1) != 0)).sum(1)
            # the bins of each tile row (column) that reach it: B2 stages
            # the range first..last of them
            n = len(lo)
            touched = np.zeros((n, max(1, int(both.max()) // tile + 1), 7), bool)
            for s in range(lo.shape[1]):
                for t in (lo[:, s], hi[:, s]):
                    sel = ok[:, s]
                    touched[np.arange(n)[sel], t[sel] // tile, s // 2] = True
            any_ = touched.any(2)
            first = touched.argmax(2)
            last = 6 - touched[:, :, ::-1].argmax(2)
            per_axis.append((distinct, np.where(any_, last - first + 1, 0).sum(1)))
        (dy_, sy), (dx_, sx) = per_axis
        fwd_cells += int((dy_ * dx_).sum())
        staged += int((sy * sx).sum())
    return int(torch.unique(torch.cat(rows)).numel()), fwd_cells, staged


def bound_ms(nbytes):
    """Least time for ``nbytes`` of device-memory traffic on the card; both
    kernels' FLOPs are negligible beside it."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def flagship_maps(dev, images, seed):
    """``images`` images' seeded FPN maps at the flagship's shapes, f32,
    channels-last."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(images, CHANNELS, IMG_H // s, IMG_W // s, device=dev,
                        generator=gen).contiguous(memory_format=torch.channels_last)
            for s in STRIDES]


def roi_fwd_inputs(dev):
    """B1's inputs at the serving shapes: one image's FPN maps and 1000 rois."""
    import torch
    return (flagship_maps(dev, 1, 0),
            torch.from_numpy(flagship_rois(np.random.RandomState(0))).to(dev))


def roi_bwd_inputs(dev):
    """B2's inputs at the training shapes: 4 images' FPN maps, 2048 sampled
    + 40 random rois and the gradient of their features."""
    import torch
    feats = flagship_maps(dev, TRAIN_IMAGES, 1)
    rois = torch.from_numpy(training_rois(np.random.RandomState(1))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    dy = torch.randn(rois.shape[0], CHANNELS, 7, 7, device=dev, generator=gen)
    return feats, rois, dy


def roi_cases(dev):
    """The RoIAlign cases of phase 3 and of tools/torch_compare_roi_align.py,
    each f32 and bf16 (the maps cast): B1 at serving (1 image, R=1000) and
    at the step's two calls (4 images, R=2048 sampled and R=40 random); B2
    at R=2088 (both calls' rois at once, the report's case), at the step's
    two calls, and at R=2048 with clustered positives. The first of each is
    its report row. -> (B1 cases, B2 cases), each a list of (label, feats,
    rois[, dy])."""
    import torch
    serving, srois = roi_fwd_inputs(dev)
    train, trois, dy = roi_bwd_inputs(dev)
    n = TRAIN_IMAGES * TRAIN_ROIS
    rng = np.random.RandomState(4)
    crois = torch.from_numpy(np.concatenate([clustered_rois(rng, b)
                                             for b in range(TRAIN_IMAGES)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    cdy = torch.randn(crois.shape[0], CHANNELS, 7, 7, device=dev, generator=gen)
    fwd, bwd = [], []
    for name, cast in (("f32", lambda fs: fs), ("bf16", lambda fs: [f.bfloat16() for f in fs])):
        sv, tr = cast(serving), cast(train)
        fwd += [(f"{name}, serving, 1 image, R={srois.shape[0]}", sv, srois),
                (f"{name}, training, 4 images, R={n} sampled", tr, trois[:n]),
                (f"{name}, training, 4 images, R={trois.shape[0] - n} random", tr, trois[n:])]
        bwd += [(f"{name}, 4 images, R={trois.shape[0]} (both calls' rois)", tr, trois, dy),
                (f"{name}, 4 images, R={n} sampled", tr, trois[:n], dy[:n].contiguous()),
                (f"{name}, 4 images, R={trois.shape[0] - n} random", tr, trois[n:],
                 dy[n:].contiguous()),
                (f"{name}, 4 images, R={crois.shape[0]} clustered", tr, crois, cdy)]
    return fwd, bwd


def roi_fwd_bytes(feats, rois):
    """B1's bound and design bytes: the f32 output written once plus each
    distinct tap cell's channels read once; the design reads each roi's
    distinct tap rows x columns once."""
    cells, per_roi, _ = roi_tap_counts([f.shape for f in feats], rois)
    out = rois.shape[0] * CHANNELS * 49 * 4
    e = feats[0].element_size()
    return out + cells * CHANNELS * e, out + per_roi * CHANNELS * e, cells


def roi_bwd_bytes(feats, rois):
    """B2's bound and design bytes: dy read once plus the gradient maps
    written once in the maps' dtype; the design writes the maps once and
    reads the dy bins that its tiles stage (each at least once)."""
    _, _, staged = roi_tap_counts([f.shape for f in feats], rois)
    table = sum(math.prod(f.shape) for f in feats) * feats[0].element_size()
    return (rois.shape[0] * CHANNELS * 49 * 4 + table, table + staged * CHANNELS * 4,
            table)


def phase_kernels():
    """B1 and B2 vs their plain versions at every case of ``roi_cases``,
    B2's bits equal in two calls, each case timed beside its bound; returns
    the kernels' report rows. The plain versions' times come from
    ``phase_profiled``."""
    import torch
    from oadg_tpu_torch.ops.roi_align import (ROI_ALIGN_BWD, ROI_ALIGN_FWD,
                                              roi_align_multilevel_ref,
                                              roi_align_multilevel_ref_backward)
    dev = torch.device("cuda", 0)
    fwd_cases, bwd_cases = roi_cases(dev)
    rows = []
    main, others = None, []
    for label, fs, rois in fwd_cases:
        tol = TOL_F32 if label.startswith("f32") else TOL_BF16
        got = ROI_ALIGN_FWD(fs, rois, 7, STRIDES, 2, 56)
        want = roi_align_multilevel_ref(fs, rois, 7, STRIDES, 2, 56)
        torch.cuda.synchronize()
        fmax = max(float(f.float().abs().max()) for f in fs)
        err = float((got - want).abs().max())
        log("kernels", f"roi_align_fwd {label}: shape {tuple(got.shape)} "
                       f"max_abs_err {err:.3e} (limit {tol * fmax:.3e})")
        if not (torch.isfinite(got).all() and err <= tol * fmax):
            raise AssertionError(f"roi_align_fwd {label} disagrees with the "
                                 f"plain version: {err} > {tol * fmax}")
        t = time_kernel(lambda i: ROI_ALIGN_FWD(fs, rois, 7, STRIDES, 2, 56), None, n=30)
        nbytes, design, cells = roi_fwd_bytes(fs, rois)
        log("kernels", f"roi_align_fwd {label}: {timing_text(t)}; bound "
                       f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB, {cells} distinct "
                       f"tap cells; {bound_ms(nbytes) / t['device_ms']:.0%} of the bound); "
                       f"the design moves {design / 1e6:.1f} MB ({bound_ms(design):.4f} ms)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("roi_align_fwd", "roi_align_fwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:248",
                    *main, cases=others))

    main, others = None, []
    for label, fs, rois, dy in bwd_cases:
        shapes = [f.shape for f in fs]
        want = roi_align_multilevel_ref_backward(dy, shapes, rois, 7, STRIDES, 2, 56)
        scale = max(float(w.abs().max()) for w in want)
        got = ROI_ALIGN_BWD(fs, rois, dy, 7, STRIDES, 2, 56)
        again = ROI_ALIGN_BWD(fs, rois, dy, 7, STRIDES, 2, 56)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        if label.startswith("f32"):
            limit = TOL_F32 * scale
            ok = err <= limit
        else:
            limit = TOL_BF16 * scale
            ok = all(bool(((g.float() - w).abs() <= 2 ** -8 * w.abs() + limit).all())
                     for g, w in zip(got, want))
        ok = ok and same and all(g.dtype == fs[0].dtype and g.shape == f.shape
                                 and bool(torch.isfinite(g).all()) for g, f in zip(got, fs))
        log("kernels", f"roi_align_bwd {label}: {len(got)} levels, max_abs_err {err:.3e} "
                       f"(limit {limit:.3e}{' + 2^-8 |value|' if 'bf16' in label else ''}; "
                       f"largest gradient {scale:.3e}); two calls give equal bits: {same}")
        if not ok:
            raise AssertionError(f"roi_align_bwd {label} disagrees with the plain "
                                 f"version ({err} > {limit}) or with itself ({same})")
        del got, again, want
        t = time_kernel(lambda i: ROI_ALIGN_BWD(fs, rois, dy, 7, STRIDES, 2, 56), None, n=20)
        nbytes, design, table = roi_bwd_bytes(fs, rois)
        log("kernels", f"roi_align_bwd {label}: {timing_text(t)}; bound "
                       f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB: dy "
                       f"{dy.numel() * 4 / 1e6:.1f}, gradient maps {table / 1e6:.1f}; "
                       f"{bound_ms(nbytes) / t['device_ms']:.0%} of the bound); the tiled "
                       f"design moves {design / 1e6:.1f} MB ({bound_ms(design):.4f} ms: the "
                       f"maps once and {(design - table) / 1e6:.1f} MB of staged dy bins)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("roi_align_bwd", "roi_align_bwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:316",
                    *main, cases=others))
    del fwd_cases, bwd_cases
    torch.cuda.empty_cache()
    return rows


def flagship_oamix_cfg():
    from oadg_tpu_torch.config import load_config
    cfg = dict(load_config(FLAGSHIP)["oamix_config"])
    cfg.pop("type", None)
    return cfg


def seeded_gts(rng, n_images, h, w):
    """``NUM_GTS`` seeded gts per image of log-uniform size over the 8
    classes: boxes (n, NUM_GTS, 4) float32 and labels (n, NUM_GTS)."""
    bw = np.exp(rng.uniform(np.log(16), np.log(w / 2), (n_images, NUM_GTS)))
    bh = np.exp(rng.uniform(np.log(16), np.log(h / 2), (n_images, NUM_GTS)))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    gt = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return gt, rng.randint(0, 8, (n_images, NUM_GTS))


def fg_inputs(gt, h, w):
    """The gated blurred-mask profiles of the first 16 gts, as OA-Mix makes
    them for B3: fx (16, W), fy (16, H)."""
    import torch
    from oadg_tpu_torch.ops.oamix_device import MAX_FG, _blurred_profiles
    fx, fy = _blurred_profiles(gt[:MAX_FG], h, w, 0.3)
    small = ((gt[:MAX_FG, 2] - gt[:MAX_FG, 0]) < 1) | ((gt[:MAX_FG, 3] - gt[:MAX_FG, 1]) < 1)
    return fx.contiguous(), (fy * (~small).float()[:, None]).contiguous()


FG_TILE = (16, 256)  # rows and columns of B3's tile (a block); a warp owns one row of it


def fg_cases(inp):
    """B3's cases (label, fx, fy) at the flagship's shapes: the gated blurred
    profiles of ``warp_inputs``' 16 seeded gts (the report's main case; most
    products are exact zeros), then 16 dense profiles, non-zero everywhere,
    where every box is live on every pixel."""
    import torch
    rng = np.random.RandomState(7)
    dense = [torch.from_numpy(rng.uniform(0.01, 1.0, (16, n)).astype(np.float32))
             .to(inp.fx.device) for n in (inp.w, inp.h)]
    return (("seeded gts' blurred profiles", inp.fx, inp.fy),
            ("dense profiles", *dense))


def hist_cases(inp):
    """B6's cases (label, uint8 image (H, W, 3)): the random image (the
    report's main case), the chain-like image of flat 64x64 blocks, and a
    constant image (every value of a channel in one bin)."""
    import torch
    const = torch.tensor([17, 200, 93], dtype=torch.uint8, device=inp.img3.device)
    return (("random", inp.img3), ("chain-like", inp.flat3),
            ("constant", const.expand(inp.h, inp.w, 3).contiguous()))


def check_fg_maps(got, want, fx, fy):
    """B3 against its plain version: ``best_id`` equal except where two
    masks tie exactly; cover and union within one bf16 step. -> (pixels
    whose id differs, max abs error of cover and union)."""
    import torch
    g = fx.shape[0]
    diff = got[0] != want[0]
    n = int(diff.sum())
    if n:
        ys, xs = diff.nonzero(as_tuple=True)
        ids = [t[ys, xs].long() for t in (got[0], want[0])]
        if not all(bool((i < g).all()) for i in ids):
            raise AssertionError(f"fg_maps: {n} ids differ, some at the sentinel")
        m = [fy[i, ys] * fx[i, xs] for i in ids]
        if not torch.equal(m[0], m[1]):
            raise AssertionError(f"fg_maps: {n} ids differ where the masks do not tie")
    err = 0.0
    for a, b in zip(got[1:], want[1:]):
        d = (a.float() - b.float()).abs()
        err = max(err, float(d.max()))
        if not bool((d <= 2 ** -7 * b.float().abs()).all()):
            raise AssertionError("fg_maps: cover or union off by more than one bf16 step")
    return n, err


def row(name, source, replaces, err, timing, nbytes, cases=None):
    """One kernel's line of the report: ``timing`` from ``time_kernel`` (``ms``
    is ``device_ms``), the bound from the bytes the function must move, and
    for the row shifts the other cases timed in this run."""
    out = {"name": name, "route": "cuda", "source": f"oadg_tpu_torch/ops/csrc/{source}",
           "replaces": replaces, "launches": None, "max_abs_err": err, **timing,
           "bound_ms": bound_ms(nbytes), "bound_by": "bytes"}
    if cases is not None:
        out["cases"] = cases
    return out


def case_row(label, err, timing, nbytes):
    return {"label": label, "max_abs_err": err, "bound_ms": bound_ms(nbytes),
            **{k: timing[k] for k in ("device_ms", "host_us", "spread", "idle_launch_ms",
                                      "plain_ms", "library_ms", "library_host_us",
                                      "library_spread")}}


def shift_grid(off, axis, h, w):
    """The ``F.grid_sample`` grid (1, H, W, 2) that reads each pixel ``off``
    (H, W) pixels along ``axis`` (align_corners=True, zeros outside)."""
    import torch
    ys = torch.arange(h, dtype=torch.float32, device=off.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=off.device)[None, :].expand(h, w)
    if axis == 1:
        xs = xs + off
    else:
        ys = ys + off
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)[None]


ROTATE = 3       # copies of a row shift's inputs, taken in turn by the timed calls


def chain_like_image(rng, h, w):
    """A uint8 image as OA-Mix's chain leaves it in flat scenes: 64x64 blocks
    of one colour each, 8 distinct colours."""
    palette = rng.randint(0, 256, (8, 3)).astype(np.uint8)
    blocks = rng.randint(0, 8, (h // 64, w // 64))
    return np.ascontiguousarray(palette[np.kron(blocks, np.ones((64, 64), np.int64))])


def grid_sampler(img, per_px, axis):
    """The library call beside a row shift: ``F.grid_sample`` of the float32
    NCHW image (``ROTATE`` copies, taken in turn) on the grid of the
    per-pixel offsets ``per_px`` (H, W). -> ``fn(i)``."""
    import torch.nn.functional as F
    h, w = per_px.shape
    grid = shift_grid(per_px, axis, h, w)
    inps = [img.float().permute(2, 0, 1)[None].contiguous() for _ in range(ROTATE)]
    return lambda i: F.grid_sample(inps[i % ROTATE], grid, mode="bilinear",
                                   padding_mode="zeros", align_corners=True)


def warp_inputs(dev):
    """The seeded inputs of B3-B7's cases at the flagship's shapes: a random
    uint8 image and a chain-like one, each also as float32 with B3's alpha
    as fourth channel, 16 gts with B3's profiles and maps (``best_id`` is
    B5's box id and B7's composite id), and the shift tables of a per-box
    rotate of 16 seeded angles."""
    import types
    import torch
    from oadg_tpu_torch.ops import fg_maps as fgm
    h, w = IMG_H, IMG_W
    rng = np.random.RandomState(6)
    inp = types.SimpleNamespace(h=h, w=w)
    inp.img3 = torch.from_numpy(request_image(rng)).to(dev)
    inp.gt = torch.from_numpy(seeded_gts(rng, 1, h, w)[0][0]).to(dev)
    inp.fx, inp.fy = fg_inputs(inp.gt, h, w)
    inp.fg = fgm.FG_MAPS(inp.fx, inp.fy, h, w)
    inp.best_id = inp.fg[0]
    alpha = (inp.fy.amax(0)[:, None] * inp.fx.amax(0)[None, :] * 255).bfloat16().float()[..., None]
    inp.img4 = torch.cat([inp.img3.float(), alpha], -1).contiguous()
    lvl = torch.from_numpy(rng.uniform(0.1, 10.0, 16).astype(np.float32)).to(dev)
    sign = torch.from_numpy(np.where(rng.rand(16) > 0.5, -1.0, 1.0).astype(np.float32)).to(dev)
    rad = torch.deg2rad(torch.floor(lvl * 3.0) * sign)
    cx, cy = (inp.gt[:16, 0] + inp.gt[:16, 2]) / 2, (inp.gt[:16, 1] + inp.gt[:16, 3]) / 2
    inp.ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    inp.xs = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
    inp.table_x = -torch.tan(rad / 2)[None, :] * (inp.ys - cy[None, :])
    inp.table_y = torch.sin(rad)[None, :] * (inp.xs - cx[None, :])
    inp.flat3 = torch.from_numpy(chain_like_image(rng, h, w)).to(dev)
    inp.flat4 = torch.cat([inp.flat3.float(), alpha], -1).contiguous()
    return inp


def piecewise_cases(inp, piecewise):
    """B5's cases (label, image, axis, table, max_shift): the three passes
    of a per-box rotate as the slots chain runs them (x on the uint8 image,
    then column and x on the float32 result of the pass before, made here
    with ``piecewise``), the column pass on the uint8 image, and the x pass
    on the chain-like image. The first is the report's main case."""
    pass1 = piecewise(inp.img3, inp.best_id, inp.table_x, 512, 1)
    pass2 = piecewise(pass1, inp.best_id, inp.table_y, 768, 0)
    return (("x pass, uint8 3-channel", inp.img3, 1, inp.table_x, 512),
            ("column pass, float32 3-channel (a rotate's second pass)", pass1, 0,
             inp.table_y, 768),
            ("x pass, float32 3-channel (a rotate's third pass)", pass2, 1, inp.table_x, 512),
            ("column pass, uint8 3-channel", inp.img3, 0, inp.table_y, 768),
            ("x pass, uint8 3-channel, chain-like image", inp.flat3, 1, inp.table_x, 512))


def piecewise_offsets(best_id, table, ms_max, axis):
    """The offset (H, W) that B5 gives each pixel, for ``grid_sampler``."""
    import torch
    p = torch.clamp(table, -ms_max, ms_max)
    bid = best_id.long().clamp(max=15)
    per_px = torch.gather(p, 1, bid) if axis == 1 else torch.gather(p.T, 0, bid)
    return torch.where(best_id.long() < 16, per_px, torch.zeros_like(per_px))


def merged_cases(inp):
    """B7's cases (label, image, axis, cid, p_bb, p_sl, is_bb, is_bg) on the
    4-channel float32 image with B3's ``best_id`` as the composite id (S =
    1, as the merged chain calls it): per-box x and column passes, a
    background pass, the identity, three slots with mixed flags, and the
    per-box x pass on the chain-like image. The first is the report's main
    case."""
    import torch
    h, w, dev = inp.h, inp.w, inp.img4.device
    a, b = -math.tan(math.radians(15)), math.sin(math.radians(30))
    bg = torch.clamp(a * (inp.ys - h / 2.0), -(int(0.27 * h / 2) + 4), int(0.27 * h / 2) + 4)
    slot = torch.full((h, w), 2, dtype=torch.long, device=dev)
    slot[100:500, 200:900], slot[600:1000, 1100:1900] = 0, 1
    best_id = inp.best_id
    cid3 = torch.where(best_id.long() < 16, slot * 16 + best_id.long(),
                       torch.full_like(slot, 48)).to(torch.int8)
    p_rot_x = torch.clamp(inp.table_x, -512, 512)
    p_rot_y = torch.clamp(inp.table_y, -768, 768)
    zero = lambda n, k: torch.zeros((n, k), device=dev)
    return (
        ("per-box x pass", inp.img4, 1, best_id, p_rot_x, zero(h, 1), [True], [False]),
        ("per-box column pass", inp.img4, 0, best_id, p_rot_y, zero(w, 1), [True], [False]),
        ("background x pass", inp.img4, 1, best_id, zero(h, 16), bg, [False], [True]),
        ("identity", inp.img4, 1, best_id, p_rot_x, bg, [False], [False]),
        ("3 slots x pass", inp.img4, 1, cid3, p_rot_x.repeat(1, 3) * 0.5, bg.repeat(1, 3),
         [True, False, False], [False, False, True]),
        ("3 slots column pass", inp.img4, 0, cid3, p_rot_y.repeat(1, 3) * 0.5,
         torch.clamp(b * (inp.xs - w / 2.0), -516, 516).repeat(1, 3),
         [False, True, False], [True, False, False]),
        ("per-box x pass, chain-like image", inp.flat4, 1, best_id, p_rot_x, zero(h, 1),
         [True], [False]))


def merged_offsets(cid, p_bb, p_sl, is_bb, is_bg, axis):
    """The offset (H, W) that B7 gives each pixel, for ``grid_sampler``."""
    import torch
    from oadg_tpu_torch.ops.warp import _merged_table
    table = _merged_table(p_bb, p_sl, np.asarray(is_bb), np.asarray(is_bg))
    k = cid.long().clamp(0, p_bb.shape[1])
    return torch.gather(table, 1, k) if axis == 1 else torch.gather(table.T, 0, k)


def phase_oamix_kernels():
    """B3-B7 vs their plain versions at the flagship's shapes. The timed
    calls of a kernel take ``ROTATE`` copies of its inputs in turn and keep
    their last results alive, so that a call finds neither its input nor
    the lines it writes in the 50 MB L2 cache."""
    import torch
    from oadg_tpu_torch.ops import fg_maps as fgm
    from oadg_tpu_torch.ops import hist, warp
    dev = torch.device("cuda", 0)
    h, w = IMG_H, IMG_W
    inp = warp_inputs(dev)
    img3, img4, best_id = inp.img3, inp.img4, inp.best_id
    rows = []
    copies = lambda t: [t.clone() for _ in range(ROTATE)]

    # B3: the 16 seeded gts' profiles on 1024x2048 (main), then 16 dense ones
    main, others = None, []
    for label, pfx, pfy in fg_cases(inp):
        got = fgm.FG_MAPS(pfx, pfy, h, w)
        want = fgm.fg_maps_ref(pfx, pfy, h, w)
        torch.cuda.synchronize()
        n_ties, err = check_fg_maps(got, want, pfx, pfy)
        live = {key: float(fgm._live_boxes(pfx, pfy, *tile).sum(-1).float().mean())
                for key, tile in (("tile", FG_TILE), ("row", (1, FG_TILE[1])), ("lane", (1, 8)))}
        t = time_kernel(lambda i: fgm.FG_MAPS(pfx, pfy, h, w),
                        lambda i: fgm.fg_maps_ref(pfx, pfy, h, w), ring=8)
        nbytes = (pfx.numel() + pfy.numel()) * 4 + h * w * (1 + 2 + 2)
        log("kernels", f"fg_maps {label}, G=16 {h}x{w}: live boxes (of 16) a "
                       f"{FG_TILE[0]}x{FG_TILE[1]} tile {live['tile']:.2f}, a row of it "
                       f"{live['row']:.2f}, a lane's 8 pixels {live['lane']:.2f}; best_id "
                       f"differs at {n_ties} exact ties; cover/union max_abs_err {err:.3e} "
                       f"(limit one bf16 step); {timing_text(t)}; bound "
                       f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
        if main is None:
            main, main_live = (err, t, nbytes), live
        else:
            others.append(case_row(label, err, t, nbytes) | {"live_boxes": live})
    rows.append(row("fg_maps", "fg_maps.cu", "oadg_tpu/ops/pallas_fg.py:54", *main,
                    cases=others) | {"live_boxes": main_live})
    in_boxes = int((best_id < 16).sum())

    # B4: x and column passes at the severity-10 rotate and translate shifts
    a, b = -math.tan(math.radians(15)), math.sin(math.radians(30))
    cases = (("x rotate", 1, a, -a * h / 2, int(0.27 * h / 2) + 4),
             ("column rotate", 0, b, -b * w / 2, int(0.50 * w / 2) + 4),
             ("x translate", 1, 0.0, -float(np.floor(9.9 * (w / 3) / 10)), w // 3 + 4),
             ("column translate", 0, 0.0, float(np.floor(9.9 * (h / 3) / 10)), h // 3 + 4))
    main, others = None, []
    for label, axis, k1, k2, ms_max in cases:
        n = h if axis == 1 else w
        shifts, fracs = warp._row_shift_params(k1, k2, n, ms_max, dev)
        off = (shifts.float() + fracs)
        off = off[:, None].expand(h, w) if axis == 1 else off[None, :].expand(h, w)
        for im in (img3, img4):
            got = warp.SHEAR_ROWS(im, shifts, fracs, ms_max, axis)
            want = warp.shear_rows_ref(im, shifts, fracs, ms_max, axis)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            c = im.shape[-1]
            if not err <= TOL_WARP:
                raise AssertionError(f"shear_rows {label} C={c}: {err} > {TOL_WARP}")
            ims = copies(im)
            t = time_kernel(
                lambda i: warp.SHEAR_ROWS(ims[i % ROTATE], shifts, fracs, ms_max, axis),
                lambda i: warp.shear_rows_ref(ims[i % ROTATE], shifts, fracs, ms_max, axis),
                grid_sampler(im, off, axis))
            nbytes = im.numel() * im.element_size() + im.numel() * 4 + n * 8
            log("kernels", f"shear_rows {label} C={c} {im.dtype}: max_abs_err "
                           f"{err:.3e} (limit {TOL_WARP:.0e}); {timing_text(t, 'F.grid_sample')}; "
                           f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
            if label == "x rotate" and c == 4:        # the bg rotate's pass
                main = (err, t, nbytes)
            else:
                others.append(case_row(f"{label} C={c} {im.dtype}", err, t, nbytes))
    rows.append(row("shear_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:131",
                    *main, cases=others))

    # B5 on B3's own best_id, rotate shifts of 16 boxes
    main, others = None, []
    for label, im, axis, table, ms_max in piecewise_cases(inp, warp.PIECEWISE_SHIFT_ROWS):
        fast = warp.PIECEWISE_SHIFT_ROWS.routes["fast"]
        got = warp.PIECEWISE_SHIFT_ROWS(im, best_id, table, ms_max, axis)
        want = warp.piecewise_shift_rows_ref(im, best_id, table, ms_max, axis)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= TOL_WARP:
            raise AssertionError(f"piecewise_shift_rows {label}: {err} > {TOL_WARP}")
        if warp.PIECEWISE_SHIFT_ROWS.routes["fast"] != fast + 1:
            raise AssertionError(f"piecewise_shift_rows {label} did not take the fast route")
        ims, ids = copies(im), copies(best_id)
        t = time_kernel(
            lambda i: warp.PIECEWISE_SHIFT_ROWS(ims[i % ROTATE], ids[i % ROTATE], table,
                                                ms_max, axis),
            lambda i: warp.piecewise_shift_rows_ref(ims[i % ROTATE], ids[i % ROTATE], table,
                                                    ms_max, axis),
            grid_sampler(im, piecewise_offsets(best_id, table, ms_max, axis), axis))
        nbytes = (im.numel() * im.element_size() + best_id.numel() + table.numel() * 4
                  + im.numel() * 4)
        log("kernels", f"piecewise_shift_rows {label}, 16 boxes, {in_boxes} pixels in "
                       f"boxes: max_abs_err {err:.3e} (limit {TOL_WARP:.0e}); "
                       f"{timing_text(t, 'F.grid_sample')}; bound {bound_ms(nbytes):.4f} ms "
                       f"({nbytes / 1e6:.1f} MB, {nbytes / t['device_ms'] / 1e9:.3f} TB/s)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("piecewise_shift_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:647",
                    *main, cases=others))

    # B7
    main, others = None, []
    for label, im, axis, cid, p_bb, p_sl, is_bb, is_bg in merged_cases(inp):
        args = (cid, p_bb, p_sl, is_bb, is_bg, axis)
        fast = warp.MERGED_SHIFT_ROWS.routes["fast"]
        got = warp.MERGED_SHIFT_ROWS(im, *args)
        want = warp.merged_shift_rows_ref(im, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= TOL_WARP:
            raise AssertionError(f"merged_shift_rows {label}: {err} > {TOL_WARP}")
        if warp.MERGED_SHIFT_ROWS.routes["fast"] != fast + 1:
            raise AssertionError(f"merged_shift_rows {label} did not take the fast route")
        if label == "identity" and not torch.equal(got, im):
            raise AssertionError("merged_shift_rows with no flag set is not the identity")
        ims, ids = copies(im), copies(cid)
        t = time_kernel(
            lambda i: warp.MERGED_SHIFT_ROWS(ims[i % ROTATE], ids[i % ROTATE], *args[1:]),
            lambda i: warp.merged_shift_rows_ref(ims[i % ROTATE], ids[i % ROTATE], *args[1:]),
            grid_sampler(im, merged_offsets(*args), axis))
        nbytes = 2 * im.numel() * 4 + cid.numel() + (p_bb.numel() + p_sl.numel()) * 4
        log("kernels", f"merged_shift_rows {label}, S={len(is_bb)}, 16 boxes: max_abs_err "
                       f"{err:.3e} (limit {TOL_WARP:.0e}); {timing_text(t, 'F.grid_sample')}; "
                       f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB, "
                       f"{nbytes / t['device_ms'] / 1e9:.3f} TB/s)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("merged_shift_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:564",
                    *main, cases=others))

    # B6: the three channels' histograms of one 1024x2048 image, random
    # (main), chain-like and constant; 9 copies in turn (57 MB).
    # torch.bincount's times come from phase_profiled.
    main, others = None, []
    for label, im in hist_cases(inp):
        got = hist.HIST256(im, 3)
        want = hist.hist256_ref(im, 3)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hist256 {label}: counts differ from the plain version")
        imgs = [im.clone() for _ in range(9)]
        t = time_kernel(lambda i: hist.HIST256(imgs[i % 9], 3),
                        lambda i: hist.hist256_ref(imgs[i % 9], 3), plain_n=10)
        nbytes = im.numel() + 3 * 256 * 4
        log("kernels", f"hist256 {label} {h}x{w}x3 uint8: counts equal; {timing_text(t)}; "
                       f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
        if main is None:
            main = (0.0, t, nbytes)
        else:
            others.append(case_row(label, 0.0, t, nbytes))
        del imgs
    rows.append(row("hist256", "hist256.cu", "oadg_tpu/ops/pallas_hist.py:73", *main,
                    cases=others))
    torch.cuda.empty_cache()
    return rows


def _set_plain_ms(row, name, case, ms):
    """The plain version's time: the row's own (its f32 report case), or
    that of its bf16 case whose label holds ``case``."""
    if name == "f32":
        row["plain_ms"] = ms
        return
    for c in row["cases"]:
        if c["label"].startswith("bf16") and case in c["label"]:
            c["plain_ms"] = ms
            return
    raise KeyError(f"{row['name']} has no bf16 case {case!r}")


def phase_profiled(rows):
    """The three times that need ``torch.profiler``, made after the path:
    the plain versions of B1 and B2 build small index tensors from host
    lists on every call (such a copy from pageable memory waits for the
    stream) and ``torch.bincount`` reads its input's largest value, so no
    run of them can be queued ahead of the device, and their device time
    is the profiler's sum of their kernels and copies. They come last
    because the profiler's tracing stays attached to the process once it
    has run, and every later launch then costs the host more: OA-Mix and
    the training steps, which the host bounds, are timed before it."""
    import torch
    from oadg_tpu_torch.ops.roi_align import (roi_align_multilevel_ref,
                                              roi_align_multilevel_ref_backward)
    dev = torch.device("cuda", 0)
    by_name = {r["name"]: r for r in rows}
    feats, rois = roi_fwd_inputs(dev)
    for name in DTYPES:
        fs = [f.to(torch_dtype(name)) for f in feats]
        t = device_time(lambda i: roi_align_multilevel_ref(fs, rois, 7, STRIDES, 2, 56), 5,
                        method="profiler")
        _set_plain_ms(by_name["roi_align_fwd"], name, "serving", t["device_ms"])
        log("profiled", f"roi_align_fwd {name} plain version (serving): device "
                        f"{t['device_ms']:.4f} ms (timer profiler), host {t['host_us']:.1f} "
                        "us a call")
    feats, rois, dy = roi_bwd_inputs(dev)
    for name in DTYPES:
        shapes, dt = [f.shape for f in feats], torch_dtype(name)
        # the plain backward reads only the maps' shapes and sums in float32;
        # the autograd function rounds its result once to the maps' dtype
        t = device_time(lambda i: [g.to(dt) for g in roi_align_multilevel_ref_backward(
            dy, shapes, rois, 7, STRIDES, 2, 56)], 3, method="profiler")
        _set_plain_ms(by_name["roi_align_bwd"], name, f"R={rois.shape[0]}", t["device_ms"])
        log("profiled", f"roi_align_bwd {name} plain version (R={rois.shape[0]}): device "
                        f"{t['device_ms']:.4f} ms (timer profiler), host {t['host_us']:.1f} "
                        "us a call")
    del feats, dy
    img3 = torch.from_numpy(request_image(np.random.RandomState(6))).to(dev)
    flats = [(img3.long() + 256 * torch.arange(3, device=dev)).reshape(-1).clone()
             for _ in range(9)]
    bincount = lambda i: torch.bincount(flats[i % 9], minlength=768)
    runs = [device_time(bincount, 50, method="profiler") for _ in range(TIMER_ROUNDS)]
    ms = [r["device_ms"] for r in runs]
    by_name["hist256"].update(
        library_ms=statistics.median(ms), library_spread=[min(ms), max(ms)],
        library_host_us=statistics.median(r["host_us"] for r in runs),
        library_timer="profiler", library_idle_launch_ms=idle_launch_ms(bincount))
    log("profiled", f"hist256's library call: {timing_text(by_name['hist256'], 'torch.bincount')}")
    torch.cuda.empty_cache()


def oamix_wrappers():
    from oadg_tpu_torch.ops import fg_maps, hist, warp
    return {"fg_maps": fg_maps.FG_MAPS, "shear_rows": warp.SHEAR_ROWS,
            "piecewise_shift_rows": warp.PIECEWISE_SHIFT_ROWS, "hist256": hist.HIST256,
            "merged_shift_rows": warp.MERGED_SHIFT_ROWS}


def expected_launches(draws, version, chain="slots"):
    """The launches of B3-B7 that an OA-Mix draw table implies: one B3 per
    view. On the slots chain, per active slot of every chain step, B6 for
    equalize, B5 three times for a per-box rotate and once for a per-box
    shear or translate, B4 likewise for the background ops. On the merged
    chain, B6 once per chain step in which any active slot drew equalize,
    and B7 three times per active slot that drew a rotate (per-box or
    background) and once per shear or translate."""
    from oadg_tpu_torch.ops.oamix_device import MAX_ML, N_SLOTS, num_photometric
    n_photo = num_photometric(version)
    counts = dict.fromkeys(oamix_wrappers(), 0)
    b, v, width = draws["op_idx"].shape[:3]
    for i in range(b):
        for j in range(v):
            counts["fg_maps"] += 1
            for c in range(width):
                for d in range(int(draws["depth"][i, j, c])):
                    ops = [int(draws["op_idx"][i, j, c, d, s]) for s in range(N_SLOTS)
                           if s >= MAX_ML or draws["ml_valid"][i, j, s]]
                    if chain == "merged":
                        counts["hist256"] += 1 in ops
                        counts["merged_shift_rows"] += sum(
                            3 if op in (n_photo, n_photo + 3) else 1
                            for op in ops if op >= n_photo)
                        continue
                    for op in ops:
                        if op == 1:
                            counts["hist256"] += 1
                        elif n_photo <= op < n_photo + 3:
                            counts["piecewise_shift_rows"] += 3 if op == n_photo else 1
                        elif op >= n_photo + 3:
                            counts["shear_rows"] += 3 if op == n_photo + 3 else 1
    return counts


class _CheckedKernel:
    """Stands in for a B3-B7 wrapper: launches the kernel, then holds its
    result against the plain version on the same inputs."""

    def __init__(self, name, kernel, check):
        self.name, self.kernel, self.check = name, kernel, check
        self.errors = []

    def __call__(self, *args):
        out = self.kernel(*args)
        self.errors.append(self.check(out, *args))
        return out


def _check_shear(out, img, shifts, fracs, max_shift, axis):
    from oadg_tpu_torch.ops.warp import shear_rows_ref
    err = float((out - shear_rows_ref(img, shifts, fracs, max_shift, axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"shear_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_piecewise(out, img, bid, shifts, max_shift, axis):
    from oadg_tpu_torch.ops.warp import piecewise_shift_rows_ref
    err = float((out - piecewise_shift_rows_ref(img, bid, shifts, max_shift,
                                                axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"piecewise_shift_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_merged(out, img, cid, p_bb, p_sl, is_bb, is_bg, axis):
    from oadg_tpu_torch.ops.warp import merged_shift_rows_ref
    err = float((out - merged_shift_rows_ref(img, cid, p_bb, p_sl, is_bb, is_bg,
                                             axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"merged_shift_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_hist(out, x, c):
    import torch
    from oadg_tpu_torch.ops.hist import hist256_ref
    if not torch.equal(out, hist256_ref(x, c)):
        raise AssertionError("hist256 in the path differs from the plain version")
    return 0.0


def _check_fg(out, fx, fy, h, w):
    from oadg_tpu_torch.ops.fg_maps import fg_maps_ref
    return check_fg_maps(out, fg_maps_ref(fx, fy, h, w), fx, fy)[1]


def phase_oamix():
    """OA-Mix alone at the flagship's shapes, on each chain: launch counts
    against the drawn table with no host sync, every op in place against
    the plain kernels, the merged chain against the slots chain, and the
    card against the CPU."""
    import copy
    import torch
    from oadg_tpu_torch.ops import fg_maps, hist, warp
    from oadg_tpu_torch.ops.oamix_device import num_photometric, oamix_batch
    dev = torch.device("cuda", 0)
    cfg = flagship_oamix_cfg()
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy(np.stack([request_image(rng) for _ in range(2)])).to(dev)
    gt = torch.from_numpy(seeded_gts(rng, 2, IMG_H, IMG_W)[0]).to(dev)
    gv = torch.ones((2, NUM_GTS), dtype=torch.bool, device=dev)
    shapes = np.array([[IMG_H, IMG_W]] * 2, np.float32)
    gen = torch.Generator().manual_seed(0)
    wrappers = oamix_wrappers()
    outs = {}
    for chain in ("slots", "merged"):
        oamix_batch(imgs, gt, gv, shapes, cfg, generator=gen, chain=chain)      # warm-up
        torch.cuda.synchronize()
        for wr in wrappers.values():
            wr.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = oamix_batch(imgs, gt, gv, shapes, cfg, generator=gen, chain=chain)
            enqueued = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: wr.launches for k, wr in wrappers.items()}
        expected = expected_launches(out["draws"], cfg["version"], chain)
        log("oamix", f"oamix_batch ({cfg['version']}, {chain} chain, 2 images of "
                     f"{IMG_H}x{IMG_W}, 1 view each) under sync debug mode 'error': "
                     f"{wall:.3f} ms wall, {enqueued:.3f} ms to enqueue; launches {launched}, "
                     f"the table implies {expected}")
        if launched != expected:
            raise AssertionError(f"OA-Mix ({chain}) launched {launched}, the table implies "
                                 f"{expected}")
        aug = out["aug"]
        if aug.shape != (2, 1, IMG_H, IMG_W, 3) or aug.dtype != torch.uint8:
            raise AssertionError(f"aug {tuple(aug.shape)} {aug.dtype}")
        for key, n in (("multilevel", 2), ("oamix", 5)):
            boxes, valid = out[f"{key}_boxes"], out[f"{key}_valid"]
            if boxes.shape != (2, n, 4) or valid.dtype != torch.bool or not valid.any():
                raise AssertionError(f"{key} boxes {tuple(boxes.shape)} {valid.dtype}")
            b = boxes[valid]
            if not bool(((b[:, 0] >= 0) & (b[:, 1] >= 0) & (b[:, 2] <= IMG_W)
                         & (b[:, 3] <= IMG_H) & (b[:, 2] > b[:, 0])
                         & (b[:, 3] > b[:, 1])).all()):
                raise AssertionError(f"{key} boxes outside the image")
        changed = float((aug[:, 0] != imgs).float().mean())
        log("oamix", f"{chain}: aug (2, 1, {IMG_H}, {IMG_W}, 3) uint8, {100 * changed:.1f}% "
                     f"of values changed; multilevel valid "
                     f"{out['multilevel_valid'].sum().item()}, oamix valid "
                     f"{out['oamix_valid'].sum().item()}; boxes inside the image")
        outs[chain] = out

    # the merged chain against the slots chain on the slots run's table
    again = oamix_batch(imgs, gt, gv, shapes, cfg, draws=outs["slots"]["draws"],
                        chain="merged")
    diff = (again["aug"].int() - outs["slots"]["aug"].int()).abs()
    share = float((diff > 0).float().mean())
    log("oamix", f"merged vs slots chain on one table, 2 images of {IMG_H}x{IMG_W}: "
                 f"{100 * share:.5f}% of values differ (limit 0.01%), largest difference "
                 f"{int(diff.max())} (limit 1)")
    if share > 1e-4 or int(diff.max()) > 1:
        raise AssertionError(f"merged vs slots: {share} of values differ, max {diff.max()}")

    # every op index in turn on each chain, B3-B7 checked in place
    checks = {"fg_maps": _CheckedKernel("fg_maps", fg_maps.FG_MAPS, _check_fg),
              "shear_rows": _CheckedKernel("shear_rows", warp.SHEAR_ROWS, _check_shear),
              "piecewise_shift_rows": _CheckedKernel(
                  "piecewise_shift_rows", warp.PIECEWISE_SHIFT_ROWS, _check_piecewise),
              "hist256": _CheckedKernel("hist256", hist.HIST256, _check_hist),
              "merged_shift_rows": _CheckedKernel(
                  "merged_shift_rows", warp.MERGED_SHIFT_ROWS, _check_merged)}
    modules = {"fg_maps": (fg_maps, "FG_MAPS"), "shear_rows": (warp, "SHEAR_ROWS"),
               "piecewise_shift_rows": (warp, "PIECEWISE_SHIFT_ROWS"),
               "hist256": (hist, "HIST256"),
               "merged_shift_rows": (warp, "MERGED_SHIFT_ROWS")}
    n_photo = num_photometric(cfg["version"])
    for name, (mod, attr) in modules.items():
        setattr(mod, attr, checks[name])
    try:
        for chain in ("slots", "merged"):
            for k in range(n_photo + 6):
                table = copy.deepcopy(outs["slots"]["draws"])
                table["op_idx"][:] = k
                before = {n: len(c.errors) for n, c in checks.items()}
                oamix_batch(imgs, gt, gv, shapes, cfg, draws=table, chain=chain)
                torch.cuda.synchronize()
                calls = {n: len(c.errors) - before[n] for n, c in checks.items()}
                if k == 1:
                    need = "hist256"
                elif k < n_photo:
                    need = None
                elif chain == "merged":
                    need = "merged_shift_rows"
                else:
                    need = "piecewise_shift_rows" if k < n_photo + 3 else "shear_rows"
                if need and not calls[need]:
                    raise AssertionError(f"op {k} on the {chain} chain did not run {need}")
                log("oamix", f"op {k} in every slot, {chain} chain: checked in place {calls}")
    finally:
        for name, (mod, attr) in modules.items():
            setattr(mod, attr, checks[name].kernel)
    for n, c in checks.items():
        log("oamix", f"{n} in the path: {len(c.errors)} calls, vs plain max_abs_err "
                     f"{max(c.errors):.3e}")

    # the card against the CPU on one table, 256x512, each chain
    h, w = 256, 512
    small = imgs[:1, :h, :w].contiguous()
    gt_s = torch.from_numpy(seeded_gts(rng, 1, h, w)[0])
    gv_s = torch.ones((1, NUM_GTS), dtype=torch.bool)
    draws = None
    for chain in ("slots", "merged"):
        card = oamix_batch(small, gt_s.to(dev), gv_s.to(dev), np.array([[h, w]], np.float32),
                           cfg, draws=draws, chain=chain,
                           generator=None if draws else torch.Generator().manual_seed(1))
        draws = card["draws"]
        cpu = oamix_batch(small.cpu(), gt_s, gv_s, np.array([[h, w]], np.float32), cfg,
                          draws=draws, chain=chain)
        diff = (card["aug"].cpu().int() - cpu["aug"].int()).abs()
        same = float((diff == 0).float().mean())
        log("oamix", f"{chain} chain, card vs CPU, one table on {h}x{w}: {100 * same:.4f}% "
                     f"of values equal (limit 99.5%), largest difference {int(diff.max())}; "
                     f"ops {sorted(set(draws['op_idx'].ravel().tolist()))}")
        if same < 0.995:
            raise AssertionError(f"OA-Mix ({chain}) card vs CPU: {same} of values equal")
        for key in ("multilevel_boxes", "multilevel_valid", "oamix_boxes", "oamix_valid"):
            if not torch.equal(card[key].cpu(), cpu[key]):
                raise AssertionError(f"OA-Mix ({chain}) card vs CPU: {key} differs")
    torch.cuda.empty_cache()


def request_image(rng):
    return rng.randint(0, 256, (IMG_H, IMG_W, 3), dtype=np.uint8)


DTYPES = ("f32", "bf16")


def torch_dtype(name):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


class _EntryDtypes:
    """Stands in for a RoIAlign kernel wrapper on the main path: records the
    dtype of the level maps of each call, then launches the kernel (whose
    wrapper counts the launch)."""

    def __init__(self, kernel):
        self.kernel, self.dtypes = kernel, []

    def __call__(self, feats, *rest):
        self.dtypes.append(feats[0].dtype)
        return self.kernel(feats, *rest)


def phase_slice(rows):
    """3 timed requests per dtype; -> the two handles (f32, bf16)."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    handles = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        t0 = time.perf_counter()
        handle = handles[name] = init_detector(str(FLAGSHIP), device="cuda", seed=0,
                                               dtype=dtype)
        log("slice", f"init_detector (R50-FPN, 8 classes, {name}, channels-last) in "
                     f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.RandomState(1)
        handle.test(prepare_image(request_image(rng), handle.cfg, handle.device))
        torch.cuda.synchronize()                              # warm-up request
        images = [request_image(rng) for _ in range(3)]

        entry = _EntryDtypes(ROI_ALIGN_FWD)
        roi_align.ROI_ALIGN_FWD = entry
        ROI_ALIGN_FWD.launches = 0
        torch.cuda.reset_peak_memory_stats()
        latencies, results = [], []
        try:
            for img in images:
                t0 = time.perf_counter()
                out = handle.test(prepare_image(img, handle.cfg, handle.device))
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
                results.append(out)
        finally:
            roi_align.ROI_ALIGN_FWD = ROI_ALIGN_FWD
        launches = ROI_ALIGN_FWD.launches
        log("slice", f"{name}: 3 requests of {IMG_H}x{IMG_W}: latency ms "
                     f"{[round(x, 3) for x in latencies]}, median "
                     f"{statistics.median(latencies):.3f} ({nvidia_smi_line()}); "
                     f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                     f"GiB (weights included); roi_align_fwd launches {launches} on maps of "
                     f"{sorted(set(map(str, entry.dtypes)))}")
        if launches != 3 or entry.dtypes != [dtype] * 3:
            raise AssertionError(f"{name}: roi_align_fwd launched {launches} times in 3 "
                                 f"requests, on maps {entry.dtypes}")
        rows[0]["launches_serving" if name == "f32" else "launches_serving_bf16"] = launches

        for dets, labels, valid in results:
            if tuple(dets.shape) != (1, 100, 5) or not torch.isfinite(dets).all():
                raise AssertionError(f"bad dets: shape {tuple(dets.shape)}")
            if int(valid.sum()) < 1:
                raise AssertionError("no valid detection")
            if not ((labels[valid] >= 0) & (labels[valid] < handle.num_classes)).all():
                raise AssertionError("label out of range")
        log("slice", f"{name}: dets (1, 100, 5) finite; valid rows per request "
                     f"{[int(v.sum()) for _, _, v in results]}")

        # The same request's RoI head on plain-RoIAlign features from the same
        # maps: a check of the kernel inside the path, not a fallback.
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
        if feats[0].dtype != dtype:
            raise AssertionError(f"{name}: FPN maps are {feats[0].dtype}")
        for what, a, b in (("cls_score", cls_k, cls_p), ("bbox_pred", reg_k, reg_p)):
            check_close("slice", f"{name}: RoI head {what} kernel vs plain RoIAlign", a, b,
                        TOL_HEAD if name == "f32" else TOL_HEAD_BF16)
    return handles


def serving_profile(name):
    """One request of the seeded flagship at ``name`` (after a warm-up)
    under torch.profiler: its wall time, the device's busy share and the
    kernels that take most of it. After every timed run (the profiler slows
    the host's launches for the rest of the process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from oadg_tpu_torch.apis import init_detector, prepare_image
    handle = init_detector(str(FLAGSHIP), device="cuda", seed=0, dtype=torch_dtype(name))
    img = request_image(np.random.RandomState(1))
    handle.test(prepare_image(img, handle.cfg, handle.device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle.test(prepare_image(img, handle.cfg, handle.device))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log("slice-profile", f"{name}: profiled request {wall:.3f} ms wall, device busy "
                         f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        log("slice-profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
                             f"x{e.count:<5d} {e.key[:90]}")
    return busy / wall


def check_close(phase, name, got, want, tol):
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    lim = tol * max(float(want.float().abs().max()), 1e-6)
    log(phase, f"{name}: max_abs_err {err:.3e} (limit {lim:.3e}, "
               f"{err / max(float(want.float().abs().max()), 1e-6):.2e} of the largest)")
    if not err <= lim:
        raise AssertionError(f"{phase} {name} disagrees: {err} > {lim}")


def phase_reference(handles):
    """Each dtype's card model against the same seeded model on the CPU."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    img = request_image(np.random.RandomState(2))[:256, :512]
    for name, handle in handles.items():
        tol = TOL_HEAD if name == "f32" else TOL_BF16_CARD
        cpu = init_detector(str(FLAGSHIP), device="cpu", seed=0, dtype=torch_dtype(name))
        bc = prepare_image(img, cpu.cfg, "cpu")
        bg = prepare_image(img, handle.cfg, handle.device)
        with torch.inference_mode():
            fc = cpu.model.extract_feat(bc["img"])
            fg = handle.model.extract_feat(bg["img"])
            for i, (a, b) in enumerate(zip(fg, fc)):
                check_close("reference", f"{name}: FPN level {i} card vs CPU", a, b, tol)
            boxes, _, _ = handle.model.rpn_head.get_proposals(
                *handle.model.rpn_head(fg), bg["img_shape"])
            rois = handle.model.roi_head.proposals_to_rois(boxes)
            outs = [m.roi_head.bbox_head(m.roi_head.bbox_roi_extractor(f, r))
                    for m, f, r in ((handle.model, fg, rois),
                                    (cpu.model, fc, rois.cpu()))]
        for what, a, b in zip(("cls_score", "bbox_pred"), *outs):
            check_close("reference", f"{name}: RoI head {what} card vs CPU", a, b, tol)


def raw_train_batch(rng, h, w, device):
    """The training step's input: 2 seeded uint8 BGR images of h x w on the
    device with ``NUM_GTS`` seeded gts each, ``img_shape`` on the host (OA-Mix
    draws its boxes from it)."""
    import torch
    images = np.stack([rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)])
    gt, labels = seeded_gts(rng, 2, h, w)
    return {"img_raw": torch.from_numpy(images).to(device),
            "gt_bboxes": torch.from_numpy(gt).to(device),
            "gt_labels": torch.from_numpy(labels).to(device),
            "gt_valid": torch.ones((2, NUM_GTS), dtype=torch.bool, device=device),
            "img_shape": torch.tensor([[h, w]] * 2, dtype=torch.float32)}


def fixed_view_batch(rng, h, w, cfg, device):
    """2 images x 2 views, views-major, through ``prepare_image``: seeded
    uint8 images, view 2 each image with seeded noise (fixed views, for the
    card-vs-CPU step), and 32 seeded gts, the same in both views."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    views = [np.clip(im.astype(np.int16) + rng.randint(-24, 25, im.shape), 0, 255)
             .astype(np.uint8) for im in images]
    parts = [prepare_image(im, cfg, device) for im in images + views]
    gt, labels = seeded_gts(rng, 2, h, w)
    img = torch.cat([b["img"] for b in parts])
    if img.is_cuda:
        img = img.contiguous(memory_format=torch.channels_last)
    return {"img": img,
            "img_shape": torch.cat([b["img_shape"] for b in parts]),
            "gt_bboxes": torch.from_numpy(np.concatenate([gt, gt])).to(device),
            "gt_labels": torch.from_numpy(np.concatenate([labels, labels])).to(device),
            "gt_valid": torch.ones((4, NUM_GTS), dtype=torch.bool, device=device)}


def build_trainer(device, cfg, preprocess=None, dtype=None):
    """The flagship built for OA-DG training with seeded random weights,
    SGD and the config's LR schedule, through the port's entry points, in
    the compute ``dtype`` (None: float32)."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    handle = init_detector(cfg, device=device, seed=0, num_views=cfg["num_views"],
                           dtype=dtype)
    steps_per_epoch = -(-CITYSCAPES_TRAIN_IMAGES // cfg["data"]["samples_per_gpu"])
    step = make_train_step(
        handle.model, build_optimizer(handle.model, cfg["optimizer"]),
        build_lr_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], steps_per_epoch),
        preprocess=preprocess)
    return handle.model, step


class _Checked:
    """Stands in for a kernel wrapper for one step: launches the kernel,
    then holds its result against the plain version on the same inputs, so
    that each kernel is checked inside the path at the path's own shapes.
    ``plain(feats, rois, *rest)`` returns the plain results and the scale of
    the limit. A float32 result within ``TOL_F32`` of the scale; with
    bfloat16 maps within ``TOL_BF16`` of it, plus one bfloat16 step of each
    value for B2's bfloat16 gradient (the rounding of its float32 sum)."""

    def __init__(self, name, kernel, plain):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.calls = []                  # (R, maps' dtype, max abs error, limit, within)

    def __call__(self, feats, rois, *rest):
        import torch
        out = self.kernel(feats, rois, *rest)
        want, scale = self.plain(feats, rois, *rest)
        got = out if isinstance(out, list) else [out]
        want = want if isinstance(want, list) else [want]
        bf16 = feats[0].dtype == torch.bfloat16
        lim = (TOL_BF16 if bf16 else TOL_F32) * scale
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        within = all(bool(((g.float() - w).abs()
                           <= lim + (2 ** -8 * w.abs() if g.dtype == torch.bfloat16 else 0)).all())
                     for g, w in zip(got, want))
        self.calls.append((rois.shape[0], feats[0].dtype, err, lim, within))
        return out


def _plain_fwd(feats, rois, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref
    return (roi_align_multilevel_ref(feats, rois, *cfg),
            max(float(f.float().abs().max()) for f in feats))


def _plain_bwd(feats, rois, dy, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref_backward
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois, *cfg)
    return want, max(float(w.abs().max()) for w in want)


def phase_train(rows, name):
    """Training at ``name`` (f32 or bf16): one model, OA-Mix on either chain,
    warm-up and 3 timed steps each, launches against the drawn tables, one
    step with B1 and B2 checked in place. -> (per chain {"median_ms",
    "peak_gib"}, and ``profile()``, which profiles one step per chain and
    adds its "busy" share)."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.engine import make_oadg_preprocess
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    dev = torch.device("cuda", 0)
    dtype = torch_dtype(name)
    cfg = load_config(FLAGSHIP)
    oamix_cfg = flagship_oamix_cfg()
    t0 = time.perf_counter()
    # one model and optimizer, OA-Mix on either chain: the same entry point
    # with ``chain`` set, switched between the two runs; the preprocess
    # emits the model's dtype, as the JAX package's train API builds it
    current = ["slots"]
    preprocess = {}
    model, step = build_trainer("cuda", cfg, lambda b, g: preprocess[current[0]](b, g),
                                dtype=dtype)
    preprocess.update({chain: make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"],
                                                   out_dtype=model.dtype, chain=chain)
                       for chain in ("slots", "merged")})
    batch = raw_train_batch(np.random.RandomState(3), IMG_H, IMG_W, dev)
    log("train", f"{name}: flagship for training (num_views {cfg['num_views']}, "
                 f"{name} compute, float32 parameters, channels-last), OA-Mix preprocess "
                 f"({oamix_cfg['version']}, out_dtype {model.dtype}), and a uint8 batch of "
                 f"2 images of {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.2f} s")
    params = dict(model.named_parameters())
    frozen = [k for k, p in params.items() if not p.requires_grad]
    if any(p.dtype != torch.float32 for p in params.values()):
        raise AssertionError(f"{name}: a parameter is not float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD,
                    **oamix_wrappers())
    entries = dict(roi_align_fwd=_EntryDtypes(ROI_ALIGN_FWD),
                   roi_align_bwd=_EntryDtypes(ROI_ALIGN_BWD))
    out = {}
    for chain in ("slots", "merged"):
        current[0] = chain
        before = {k: p.detach().clone() for k, p in params.items()}
        step(batch, gen)                                       # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for wr in wrappers.values():
            wr.launches = 0
        for e in entries.values():
            e.dtypes.clear()
        expected = dict(roi_align_fwd=6, roi_align_bwd=6,
                        **dict.fromkeys(oamix_wrappers(), 0))
        times, logs = [], []
        roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = entries.values()
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                logs.append(step(batch, gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                implied = expected_launches(preprocess[chain].draws, oamix_cfg["version"],
                                            chain)
                for k, n in implied.items():
                    expected[k] += n
        finally:
            roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = ROI_ALIGN_FWD, ROI_ALIGN_BWD
        launched = {k: wr.launches for k, wr in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, lv in enumerate(logs):
            log("train", f"{name}, {chain} chain, step {i + 1}: " + ", ".join(
                f"{k} {float(v):.5f}" for k, v in lv.items()))
        median = statistics.median(times)
        log("train", f"{name}, {chain} chain, 3 steps: ms {[round(t, 3) for t in times]}, "
                     f"median {median:.3f}; max_memory_allocated {peak:.2f} GiB; "
                     f"launches {launched}; the tables imply {expected}")
        if launched != expected:
            raise AssertionError(f"3 steps ({name}, {chain}) launched {launched}, "
                                 f"not {expected}")
        for k, e in entries.items():
            if e.dtypes != [dtype] * 6:
                raise AssertionError(f"{name}: {k} entered with maps of {e.dtypes}")
        log("train", f"{name}, {chain} chain: roi_align_fwd and roi_align_bwd each entered "
                     f"6 times with {dtype} maps")
        idle = {"slots": {"merged_shift_rows"},
                "merged": {"shear_rows", "piecewise_shift_rows"}}[chain]
        unlaunched = [k for k, n in launched.items() if not n and k not in idle]
        if unlaunched:
            raise AssertionError(f"3 steps ({name}, {chain}) never launched {unlaunched}")
        for r in rows:
            r[f"launches_{chain}" + ("" if name == "f32" else "_bf16")] = launched[r["name"]]
        for lv in logs:
            if not all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                       for v in lv.values()):
                raise AssertionError(f"a loss is not a finite float32: {lv}")
            if not float(lv["loss_cont"]) > 0:
                raise AssertionError("loss_cont is not positive")
        still = [k for k, p in params.items() if p.requires_grad
                 and torch.equal(p.detach(), before[k])]
        moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
        grads = {p.grad.dtype for p in params.values() if p.grad is not None}
        log("train", f"{name}, {chain} chain: {len(params) - len(frozen)} trainable "
                     f"parameters, {len(still)} unmoved; {len(frozen)} frozen (stem, layer1), "
                     f"{len(moved)} moved; parameters float32, gradients {sorted(map(str, grads))}")
        if still or moved or not frozen or grads != {torch.float32}:
            raise AssertionError(f"unmoved trainable {still[:5]}, moved frozen {moved[:5]}, "
                                 f"gradient dtypes {grads}")
        out[chain] = {"median_ms": median, "peak_gib": peak}
    # each kernel's launches on the path that runs it: the slots run's, and
    # the merged run's for the kernel that only the merged chain launches
    if name == "f32":
        for r in rows:
            r["launches"] = r["launches_slots"] or r["launches_merged"]
    log("train", f"{name}: step medians in this call ({nvidia_smi_line()}): slots chain "
                 f"{out['slots']['median_ms']:.3f} ms, merged chain "
                 f"{out['merged']['median_ms']:.3f} ms")

    # One more step with both kernels checked in place: B1's RoI features
    # and B2's level gradients against the plain versions on the same inputs
    # (the step's FPN maps, rois and dy).
    checks = (_Checked("roi_align_fwd", ROI_ALIGN_FWD, _plain_fwd),
              _Checked("roi_align_bwd", ROI_ALIGN_BWD, _plain_bwd))
    roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = checks
    try:
        step(batch, gen)
    finally:
        roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = ROI_ALIGN_FWD, ROI_ALIGN_BWD
    torch.cuda.synchronize()
    for check in checks:
        for i, (r, maps, err, lim, within) in enumerate(check.calls):
            log("train", f"{name}: {check.name} call {i} in the step (R={r}, 4 images, "
                         f"{maps} maps): vs plain version max_abs_err {err:.3e} (limit "
                         f"{lim:.3e}{' + 2^-8 |value|' if check.name.endswith('bwd') and maps == torch.bfloat16 else ''})")
            if not within or maps != dtype:
                raise AssertionError(f"{check.name} in the step disagrees: {err} > {lim}")
        if len(check.calls) != 2:
            raise AssertionError(f"{len(check.calls)} {check.name} calls in a step")

    def profile():
        """One profiled step per chain (after every timed step of the run:
        the profiler slows the host's launches for the rest of the process)."""
        for chain in ("slots", "merged"):
            current[0] = chain
            out[chain]["busy"] = train_profile(step, batch, gen, chain, name)

    return out, profile


STAGES = ("train_step: oamix", "forward_train: backbone+neck", "forward_train: rpn head+loss",
          "forward_train: proposals", "forward_train: roi head+loss",
          "train_step: backward", "train_step: sgd")


def train_profile(step, batch, gen, chain, dtype_name="f32"):
    """One step (OA-Mix on ``chain``) under torch.profiler, read through the ``record_function``
    spans of ``forward_train`` and ``make_train_step``: per stage the host
    time of its span and the device time of the kernels launched in it, and
    the device's busy share of the step. Autograd launches the backward's
    kernels from its own thread, outside the backward span, so the
    backward's device time is the sum over autograd's ``evaluate_function``
    events. -> the device's busy share of the step's wall time."""
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
        log("train-profile", f"{dtype_name}, {chain} chain, {name}: host "
                             f"{host[name].cpu_time_total / 1e3:.3f} ms, "
                             f"device {dev_ms:.3f} ms ({100 * dev_ms / busy:.1f}% of busy)")
    log("train-profile", f"profiled step ({dtype_name}, {chain} chain) {wall:.3f} ms wall, "
                         f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), of which "
                         f"{busy - spanned:.3f} ms outside the stages")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log("train-profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
                             f"x{e.count:<5d} {e.key[:90]}")
    return busy / wall


def phase_train_reference(name):
    """One step's losses and gradients at ``name`` (f32 or bf16), CPU vs
    card, on 256x512 views."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = torch.device("cuda", 0)
    dtype = torch_dtype(name)
    loss_tol, grad_tol = (1e-3, 1e-3) if name == "f32" else (TOL_BF16_LOSS, TOL_BF16_CARD)
    cfg = load_config(FLAGSHIP)
    card, _ = build_trainer("cuda", cfg, dtype=dtype)
    cpu, _ = build_trainer("cpu", cfg, dtype=dtype)
    batch = fixed_view_batch(np.random.RandomState(4), 256, 512, cfg, "cpu")
    batch["img"] = batch["img"].to(dtype)
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
    log("train-reference", f"{name}: CPU proposals equal to the card's in place: "
                           f"{int(same.sum())} of {int(vc.sum())} valid")
    for k in sorted(lc):
        if "loss" not in k:
            continue
        a, b = float(lc[k].detach()), float(lh[k].detach())
        err = abs(a - b) / max(abs(b), 1e-6)
        log("train-reference", f"{name}: {k}: card {a:.6f} CPU {b:.6f} rel err {err:.2e} "
                               f"(limit {loss_tol:.1e})")
        if not (err <= loss_tol and lc[k].dtype == torch.float32):
            raise AssertionError(f"{k} card vs CPU: {a} vs {b}")
    names = [k for k in ph if k.startswith(("rpn_head.rpn_conv.",
                                            "roi_head.bbox_head.fc_cls."))
             or (k.startswith("backbone.layer4.") and ".conv3." in k)]
    for k in names:
        want = ph[k].grad
        err = float((pc[k].grad.cpu() - want).abs().max())
        lim = grad_tol * float(want.abs().max())
        log("train-reference", f"{name}: grad {k} ({pc[k].grad.dtype}): max_abs_err "
                               f"{err:.3e} (limit {lim:.3e})")
        if not (err <= lim and pc[k].grad.dtype == torch.float32):
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
    rows = phase_kernels() + phase_oamix_kernels()
    if "--kernels-only" in sys.argv[1:]:        # the kernels' phases alone: no result line
        phase_profiled(rows)
        print(json.dumps({"kernels": rows}), flush=True)
        print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
        return 0
    handles = phase_slice(rows)
    phase_reference(handles)
    del handles
    phase_oamix()
    trains = {name: phase_train(rows, name) for name in DTYPES}
    for _, profile in trains.values():
        profile()
    summary = {name: out for name, (out, _) in trains.items()}
    for name in DTYPES:
        summary[name]["serving_busy"] = serving_profile(name)
    del trains
    torch.cuda.empty_cache()
    log("train", f"per dtype and chain ({nvidia_smi_line()}): {json.dumps(summary)}")
    for name in DTYPES:
        phase_train_reference(name)
    phase_profiled(rows)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
