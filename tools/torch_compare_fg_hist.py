#!/usr/bin/env python3
"""The OA-Mix foreground-map kernel (B3) and the equalize histogram (B6) of
this checkout against those of another checkout of the repository, on one
NVIDIA card, in one process.

    git archive --prefix=_archive/parent/ <commit> | tar -x     # _archive/ is git-ignored
    python3 tools/torch_compare_fg_hist.py --parent _archive/parent

The other checkout's ``oadg_tpu_torch`` is imported under another name, so
its wrappers launch its own ``csrc/fg_maps.cu`` and ``csrc/hist256.cu``
(built into its own ``_build/``). Per case of ``chip_smoke.py``'s
``fg_cases`` (B3 at 1024x2048: the seeded gts' blurred profiles, dense
profiles) and ``hist_cases`` (B6 on 1024x2048x3 uint8: random, chain-like,
constant): B3's three maps must be equal value for value (the two kernels
compute the same float32 operations in the same order, so only a zero's
sign may differ) and B6's counts equal; then the other checkout's wrapper
and this checkout's are timed in turns (other, this, this, other; three
rounds) with ``chip_smoke.py``'s timer: ``device_ms`` per launch of a run of
launches queued while the device was kept busy, ``host_us`` per call of the
wrapper. Last, the time of the zero fill that the other checkout's B6
wrapper enqueues (``torch.zeros`` of its table) and of a memset of as many
bytes as B3 writes (its stores alone) by the same timer. Then the
path: OA-Mix on each chain through both checkouts on one draw table (views
equal bit for bit, B3 and B6 launched as often) and one training step from
the same seeded weights (losses equal). Prints one line per case, then one
JSON line of all cases, then the card's ``nvidia-smi`` line. Imports
nothing of JAX.
"""
import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_other(path):
    """``<path>/oadg_tpu_torch`` as ``oadg_tpu_torch_other`` (the package
    imports its own modules relatively). -> its (fg_maps, hist) modules;
    the rest of it is importable under that name."""
    pkg = Path(path).resolve() / "oadg_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "oadg_tpu_torch_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module("oadg_tpu_torch_other.ops.fg_maps"),
            importlib.import_module("oadg_tpu_torch_other.ops.hist"))


def same_maps(a, b):
    """B3's maps of the two checkouts: ``best_id`` equal, cover and union
    equal value for value (-0 == +0)."""
    import torch
    return torch.equal(a[0], b[0]) and all(bool((x.float() == y.float()).all())
                                           for x, y in zip(a[1:], b[1:]))


def compare(name, label, nbytes, other, this, n, ring):
    """One case, the results already checked: the two in turns. -> the
    case's record."""
    got = cs.in_turns({"other": other, "this": this}, n, ring)
    bound = cs.bound_ms(nbytes)
    rec = {"kernel": name, "case": label, "bound_ms": bound, "bytes": nbytes,
           **{f"{who}_{key}": got[who][key] for who in got
              for key in ("device_ms", "host_us", "spread")}}
    o, t = got["other"]["device_ms"], got["this"]["device_ms"]
    cs.log("compare", f"{name} {label}: equal; device ms other {o:.4f} this {t:.4f} "
                      f"({o / t:.2f}x faster; bound {bound:.4f}: this {t / bound:.2f}x its "
                      f"bound, {nbytes / t / 1e9:.3f} TB/s; other {o / bound:.2f}x); rounds "
                      f"other {got['other']['spread']}, this {got['this']['spread']}; host us "
                      f"a call other {got['other']['host_us']:.1f} this "
                      f"{got['this']['host_us']:.1f}")
    return rec


def build_trainer(pkg, cfg, oamix_cfg, chain):
    """The flagship built for OA-DG training by package ``pkg`` (this
    checkout's ``oadg_tpu_torch`` or the other's), seeded weights, SGD and
    the LR schedule, OA-Mix on ``chain``: as ``chip_smoke.build_trainer``."""
    apis = importlib.import_module(f"{pkg}.apis")
    engine = importlib.import_module(f"{pkg}.engine")
    handle = apis.init_detector(cfg, device="cuda", seed=0, num_views=cfg["num_views"])
    steps = -(-cs.CITYSCAPES_TRAIN_IMAGES // cfg["data"]["samples_per_gpu"])
    return engine.make_train_step(
        handle.model, engine.build_optimizer(handle.model, cfg["optimizer"]),
        engine.build_lr_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], steps),
        preprocess=engine.make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"], chain=chain))


def compare_path(wrappers):
    """The path through both checkouts on one draw table: OA-Mix's views
    on each chain (``make_oadg_preprocess`` with one generator seed, so one
    table) must be equal bit for bit and launch B3 and B6 as often, and one
    training step on the slots chain from the same seeded weights must give
    equal losses. -> the records."""
    import torch
    from oadg_tpu_torch.config import load_config
    cfg = load_config(cs.FLAGSHIP)
    oamix_cfg = cs.flagship_oamix_cfg()
    batch = cs.raw_train_batch(np.random.RandomState(9), cs.IMG_H, cs.IMG_W, "cuda")
    recs = []
    for chain in ("slots", "merged"):
        views, launches = {}, {}
        for who, pkg in (("other", "oadg_tpu_torch_other"), ("this", "oadg_tpu_torch")):
            engine = importlib.import_module(f"{pkg}.engine")
            pre = engine.make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"], chain=chain)
            before = [w.launches for w in wrappers[who]]
            views[who] = pre(dict(batch), torch.Generator().manual_seed(3))
            torch.cuda.synchronize()
            launches[who] = [w.launches - b for w, b in zip(wrappers[who], before)]
        same = all(torch.equal(views["this"][k], views["other"][k]) for k in views["this"])
        cs.log("compare", f"OA-Mix, {chain} chain, one draw table, 2 images of {cs.IMG_H}x"
                          f"{cs.IMG_W}: views and boxes equal {same}; B3, B6 launches "
                          f"other {launches['other']}, this {launches['this']}")
        if not same or launches["this"] != launches["other"]:
            raise AssertionError(f"OA-Mix ({chain}): the two checkouts differ")
        recs.append({"path": f"oamix {chain}", "equal": same, "launches": launches["this"]})
    losses = {}
    for who, pkg in (("other", "oadg_tpu_torch_other"), ("this", "oadg_tpu_torch")):
        step = build_trainer(pkg, cfg, oamix_cfg, "slots")
        losses[who] = {k: float(v) for k, v in step(dict(batch),
                                                    torch.Generator().manual_seed(4)).items()}
        del step
        torch.cuda.empty_cache()
    diff = max(abs(losses["this"][k] - losses["other"][k]) for k in losses["this"])
    cs.log("compare", f"one training step, slots chain, same weights and table: losses "
                      f"{losses['this']}; largest difference from the other checkout {diff}")
    if set(losses["this"]) != set(losses["other"]) or diff != 0.0:
        raise AssertionError(f"training step: the two checkouts' losses differ by {diff}")
    recs.append({"path": "training step losses", "equal": True, "losses": losses["this"]})
    return recs


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other checkout (holds oadg_tpu_torch/)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 1
    from oadg_tpu_torch.ops import fg_maps as this_fg
    from oadg_tpu_torch.ops import hist as this_hist
    other_fg, other_hist = load_other(args.parent)
    cs.phase_device()
    for wrapper in (this_fg.FG_MAPS, this_hist.HIST256, other_fg.FG_MAPS,
                    other_hist.HIST256):
        wrapper.library.build()
        cs.log("build", f"{wrapper.library.source} -> {wrapper.library.library_path().name}")
    inp = cs.warp_inputs(torch.device("cuda", 0))
    h, w = inp.h, inp.w
    recs = []
    for label, fx, fy in cs.fg_cases(inp):
        a, b = other_fg.FG_MAPS(fx, fy, h, w), this_fg.FG_MAPS(fx, fy, h, w)
        torch.cuda.synchronize()
        if not same_maps(a, b):
            raise AssertionError(f"fg_maps {label}: the two checkouts' maps differ")
        recs.append(compare("fg_maps", label, (fx.numel() + fy.numel()) * 4 + h * w * 5,
                            lambda i: other_fg.FG_MAPS(fx, fy, h, w),
                            lambda i: this_fg.FG_MAPS(fx, fy, h, w), 50, 8))
    for label, im in cs.hist_cases(inp):
        imgs = [im.clone() for _ in range(9)]
        a, b = other_hist.HIST256(im, 3), this_hist.HIST256(im, 3)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"hist256 {label}: the two checkouts' counts differ")
        recs.append(compare("hist256", label, im.numel() + 3 * 256 * 4,
                            lambda i: other_hist.HIST256(imgs[i % 9], 3),
                            lambda i: this_hist.HIST256(imgs[i % 9], 3), 50, 3))
        del imgs
    dev = inp.img3.device
    fill = cs.device_time(lambda i: torch.zeros((3, 256), dtype=torch.int32, device=dev), 50)
    cs.log("compare", f"the other B6 wrapper's zero fill, torch.zeros((3, 256)): device "
                      f"{fill['device_ms']:.4f} ms, host {fill['host_us']:.1f} us a call")
    maps = [torch.empty(h * w * 5, dtype=torch.uint8, device=dev) for _ in range(8)]
    floor = cs.device_time(lambda i: maps[i % 8].zero_(), 50, ring=8)
    cs.log("compare", f"B3's stores alone: zero_() of {h * w * 5 / 1e6:.1f} MB (8 buffers in "
                      f"turn): device {floor['device_ms']:.4f} ms")
    recs += [{"kernel": "torch.zeros((3, 256), int32)", "case": "B6's zero fill",
              "device_ms": fill["device_ms"], "host_us": fill["host_us"]},
             {"kernel": "zero_()", "case": "B3's 5 bytes a pixel",
              "device_ms": floor["device_ms"]}]
    recs += compare_path({"this": (this_fg.FG_MAPS, this_hist.HIST256),
                          "other": (other_fg.FG_MAPS, other_hist.HIST256)})
    print(json.dumps({"cases": recs}), flush=True)
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
