#!/usr/bin/env python3
"""The row-shift kernels (B4, B5, B7) of this checkout against those of
another checkout of the repository, on one NVIDIA card, in one process.

    git archive --prefix=_archive/parent/ <commit> | tar -x     # _archive/ is git-ignored
    python3 tools/torch_compare_shift_rows.py --parent _archive/parent

The other checkout's ``oadg_tpu_torch`` is imported under another name, so
its wrappers launch its own ``csrc/shift_rows.cu`` (built into its own
``_build/``). Per case of ``chip_smoke.py``'s phase 3 (flagship shapes,
1024x2048): the two results must be equal bit for bit, and the other
checkout's wrapper, this checkout's wrapper and ``F.grid_sample`` are timed
in turns (other, this, library, library, this, other; three rounds) with
``chip_smoke.py``'s timer: ``device_ms`` per launch of a run of launches
queued while the device was kept busy, ``host_us`` per call of the wrapper.
Prints one line per case, then one JSON line of all cases, then the card's
``nvidia-smi`` line. Imports nothing of JAX.
"""
import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_other(path):
    """``<path>/oadg_tpu_torch/ops/warp.py`` as ``oadg_tpu_torch_other.ops.warp``
    (the package imports its own modules relatively)."""
    pkg = Path(path).resolve() / "oadg_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "oadg_tpu_torch_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return importlib.import_module("oadg_tpu_torch_other.ops.warp")


def compare(name, label, nbytes, other, this, library, n):
    """One case: equal bits, then the three in turns. -> the case's record."""
    import torch
    a, b = other(0), this(0)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name} {label}: the two checkouts' results differ by "
                             f"{float((a - b).abs().max())}")
    del a, b
    got = cs.in_turns({"other": other, "this": this, "library": library}, n, ring=cs.ROTATE)
    bound = cs.bound_ms(nbytes)
    rec = {"kernel": name, "case": label, "bound_ms": bound, "bytes": nbytes, **{
        f"{who}_{key}": got[who][key] for who in got for key in ("device_ms", "host_us", "spread")}}
    cs.log("compare", f"{name} {label}: equal bits; device ms other {got['other']['device_ms']:.4f}"
                      f" this {got['this']['device_ms']:.4f} F.grid_sample "
                      f"{got['library']['device_ms']:.4f} (bound {bound:.4f}: this is "
                      f"{got['this']['device_ms'] / bound:.2f}x its bound, "
                      f"{got['this']['device_ms'] / got['library']['device_ms']:.2f}x the "
                      f"library call, {nbytes / got['this']['device_ms'] / 1e9:.3f} TB/s; other "
                      f"{got['other']['device_ms'] / bound:.2f}x, "
                      f"{got['other']['device_ms'] / got['library']['device_ms']:.2f}x); "
                      f"rounds other {got['other']['spread']}, this {got['this']['spread']}; "
                      f"host us a call other {got['other']['host_us']:.1f} this "
                      f"{got['this']['host_us']:.1f} F.grid_sample {got['library']['host_us']:.1f}")
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other checkout (holds oadg_tpu_torch/)")
    parser.add_argument("--launches", type=int, default=50, help="launches per timed run")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    from oadg_tpu_torch.ops import warp as this
    other = load_other(args.parent)
    cs.phase_device()
    for lib in (this._LIBRARY, other._LIBRARY):
        lib.build()
        cs.log("build", f"{lib.source} -> {lib.library_path().name}")
    dev = torch.device("cuda", 0)
    inp = cs.warp_inputs(dev)
    rot = cs.ROTATE
    copies = lambda t: [t.clone() for _ in range(rot)]
    n = args.launches
    recs = []

    h, w = inp.h, inp.w
    a = -math.tan(math.radians(15))
    shifts, fracs = this._row_shift_params(a, -a * h / 2, h, int(0.27 * h / 2) + 4, dev)
    ms_max = int(0.27 * h / 2) + 4
    ims = copies(inp.img4)
    off = (shifts.float() + fracs)[:, None].expand(h, w)
    recs.append(compare(
        "shear_rows", "x rotate C=4 float32", 2 * inp.img4.numel() * 4 + h * 8,
        lambda i: other.SHEAR_ROWS(ims[i % rot], shifts, fracs, ms_max, 1),
        lambda i: this.SHEAR_ROWS(ims[i % rot], shifts, fracs, ms_max, 1),
        cs.grid_sampler(inp.img4, off, 1), n))

    for label, im, axis, table, ms_max in cs.piecewise_cases(inp, this.PIECEWISE_SHIFT_ROWS):
        ims, ids = copies(im), copies(inp.best_id)
        nbytes = (im.numel() * im.element_size() + inp.best_id.numel() + table.numel() * 4
                  + im.numel() * 4)
        recs.append(compare(
            "piecewise_shift_rows", label, nbytes,
            lambda i: other.PIECEWISE_SHIFT_ROWS(ims[i % rot], ids[i % rot], table, ms_max, axis),
            lambda i: this.PIECEWISE_SHIFT_ROWS(ims[i % rot], ids[i % rot], table, ms_max, axis),
            cs.grid_sampler(im, cs.piecewise_offsets(inp.best_id, table, ms_max, axis), axis), n))

    for label, im, axis, cid, p_bb, p_sl, is_bb, is_bg in cs.merged_cases(inp):
        ims, ids = copies(im), copies(cid)
        rest = (p_bb, p_sl, is_bb, is_bg, axis)
        nbytes = 2 * im.numel() * 4 + cid.numel() + (p_bb.numel() + p_sl.numel()) * 4
        recs.append(compare(
            "merged_shift_rows", label, nbytes,
            lambda i: other.MERGED_SHIFT_ROWS(ims[i % rot], ids[i % rot], *rest),
            lambda i: this.MERGED_SHIFT_ROWS(ims[i % rot], ids[i % rot], *rest),
            cs.grid_sampler(im, cs.merged_offsets(cid, *rest), axis), n))

    print(json.dumps({"cases": recs}), flush=True)
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
