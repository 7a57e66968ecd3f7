#!/usr/bin/env python3
"""The RoIAlign kernels (B1 forward, B2 backward) of this checkout against
those of another checkout of the repository, on one NVIDIA card, in one
process.

    git archive --prefix=_archive/parent/ <commit> | tar -x     # _archive/ is git-ignored
    python3 tools/torch_compare_roi_align.py --parent _archive/parent

The other checkout's ``oadg_tpu_torch`` is imported under another name, so
its wrappers launch its own ``csrc/roi_align_fwd.cu`` and ``roi_align_bwd.cu``
(built into its own ``_build/``). Per case of ``chip_smoke.py``'s
``roi_cases`` (flagship shapes: B1 at serving and at the step's two calls,
B2 at R=2088, the step's two calls and clustered positives; f32 and bf16):
the two results must agree to ``chip_smoke.py``'s kernel tolerance (the two
designs sum in other orders), and the other checkout's wrapper and this
checkout's are timed in turns (other, this, this, other; three rounds) with
``chip_smoke.py``'s timer: ``device_ms`` per launch of a run of launches
queued while the device was kept busy, ``host_us`` per call of the wrapper.
Prints one line per case, then one JSON line of all cases, then the card's
``nvidia-smi`` line. Imports nothing of JAX.
"""
import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_other(path):
    """``<path>/oadg_tpu_torch/ops/roi_align.py`` as
    ``oadg_tpu_torch_other.ops.roi_align`` (the package imports its own
    modules relatively)."""
    pkg = Path(path).resolve() / "oadg_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "oadg_tpu_torch_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return importlib.import_module("oadg_tpu_torch_other.ops.roi_align")


def agree(name, label, a, b):
    """The two checkouts' results within the kernel tolerance of
    ``chip_smoke.py`` (f32: 1e-5 of the largest magnitude; bf16 gradients:
    each is within one bf16 step of its f32 sum, so two bf16 steps of each
    other, plus 1e-4 of the largest magnitude). -> max abs difference."""
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    scale = max(float(x.float().abs().max()) for x in a)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
    if "bf16" in label and name == "roi_align_bwd":
        ok = all(bool(((x.float() - y.float()).abs()
                       <= 2 ** -7 * y.float().abs() + cs.TOL_BF16 * scale).all())
                 for x, y in zip(a, b))
    else:
        ok = err <= cs.TOL_F32 * scale
    if not ok:
        raise AssertionError(f"{name} {label}: the two checkouts differ by {err}")
    return err


def compare(name, label, nbytes, other, this, n):
    """One case: agreement, then the two in turns. -> the case's record."""
    import torch
    err = agree(name, label, other(0), this(0))
    torch.cuda.synchronize()
    got = cs.in_turns({"other": other, "this": this}, n)
    bound = cs.bound_ms(nbytes)
    rec = {"kernel": name, "case": label, "bound_ms": bound, "bytes": nbytes,
           "max_abs_diff": err, **{f"{who}_{key}": got[who][key] for who in got
                                   for key in ("device_ms", "host_us", "spread")}}
    o, t = got["other"]["device_ms"], got["this"]["device_ms"]
    cs.log("compare", f"{name} {label}: max abs difference {err:.3e}; device ms other "
                      f"{o:.4f} this {t:.4f} ({o / t:.2f}x faster; bound {bound:.4f}: this "
                      f"{t / bound:.2f}x its bound, {nbytes / t / 1e9:.3f} TB/s; other "
                      f"{o / bound:.2f}x); rounds other {got['other']['spread']}, this "
                      f"{got['this']['spread']}; host us a call other "
                      f"{got['other']['host_us']:.1f} this {got['this']['host_us']:.1f}")
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other checkout (holds oadg_tpu_torch/)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    from oadg_tpu_torch.ops import roi_align as this
    other = load_other(args.parent)
    cs.phase_device()
    for mod in (this, other):
        for wrapper in (mod.ROI_ALIGN_FWD, mod.ROI_ALIGN_BWD):
            wrapper.library.build()
            cs.log("build", f"{wrapper.library.source} -> "
                            f"{wrapper.library.library_path().name}")
    dev = torch.device("cuda", 0)
    fwd_cases, bwd_cases = cs.roi_cases(dev)
    recs = []
    for label, fs, rois in fwd_cases:
        recs.append(compare(
            "roi_align_fwd", label, cs.roi_fwd_bytes(fs, rois)[0],
            lambda i: other.ROI_ALIGN_FWD(fs, rois, 7, cs.STRIDES, 2, 56),
            lambda i: this.ROI_ALIGN_FWD(fs, rois, 7, cs.STRIDES, 2, 56), 30))
    for label, fs, rois, dy in bwd_cases:
        recs.append(compare(
            "roi_align_bwd", label, cs.roi_bwd_bytes(fs, rois)[0],
            lambda i: other.ROI_ALIGN_BWD(fs, rois, dy, 7, cs.STRIDES, 2, 56),
            lambda i: this.ROI_ALIGN_BWD(fs, rois, dy, 7, cs.STRIDES, 2, 56), 20))
    print(json.dumps({"cases": recs}), flush=True)
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
