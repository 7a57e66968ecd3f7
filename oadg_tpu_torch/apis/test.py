"""Test APIs (port of ``oadg_tpu/apis/test.py:15,27,66`` and of the model
and loader builders of ``tools/test.py``): the test step over a loader,
its padded outputs turned into the reference's per-image per-class numpy
detection lists.

A test-time augmentation batch (a ``MultiScaleFlipAug`` pipeline with
several scales or ``flip=True``) goes to the model's ``aug_test`` through
the test step (``make_test_step``).

Multi-process testing (``multi_gpu_test``, ``:154``): each rank runs its
slice of the loader (``build_dataloader`` takes the rank from
``torch.distributed``), then ``collect_results_allgather`` (``:76-150``)
all-gathers the ranks' results and restores the dataset's order on every
rank.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.bbox.transforms import bbox2result
from ..data import build_dataloader, build_dataset, static_hw_from_pipeline
from ..engine.train_step import make_test_step
from ..parallel import get_dist_info, is_distributed
from .inference import _num_classes, init_detector


def fetch_dets(dets: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               masks: Optional[torch.Tensor] = None):
    """The test step's (N, K, 5), (N, K), (N, K) device tensors -> numpy
    float32 dets, int64 labels and bool valid, in one device-to-host copy
    (labels are small integers, exact in float32). A Mask R-CNN's fourth
    output, its (N, K, 28, 28) mask probabilities, stays on the device: the
    results are scored by their boxes (the JAX package has no ``segm``
    metric)."""
    packed = torch.cat([dets.float(), labels[..., None].float(),
                        valid[..., None].float()], -1).cpu().numpy()
    return packed[..., :5], packed[..., 5].astype(np.int64), packed[..., 6] > 0


def refuse_instance_outputs(model) -> None:
    """Raise ``ValueError`` for SOLO, YOLACT and PanopticFPN: their test
    call returns masks, labels and scores (SOLO), four outputs (YOLACT) or
    a pair of the boxes and the stuff probabilities (PanopticFPN), which
    the box results of ``run_test`` cannot hold. The JAX package's
    ``run_test`` and ``inference_detector`` unpack three outputs as boxes:
    they read SOLO's masks as boxes and raise on YOLACT's four and on
    PanopticFPN's two (``oadg_tpu/apis/test.py:57``); it has no ``segm`` or
    PQ test path."""
    what = getattr(model, "instance_outputs", "")
    if what:
        raise ValueError(f"{type(model).__name__}'s test call returns {what}, not boxes: "
                         "the box test path cannot score it (the JAX package misreads or "
                         "refuses it and has no segm metric); call DetectorHandle.test")


def dets_to_results(dets, labels, valid, num_classes: int) -> List[List[np.ndarray]]:
    """(N, K, 5), (N, K), (N, K) numpy -> per image, per class (n, 5) arrays."""
    return [bbox2result(dets[i][valid[i]], labels[i][valid[i]], num_classes)
            for i in range(dets.shape[0])]


def run_test(test_fn: Callable, loader, num_classes: int,
             progress: bool = False) -> List[List[np.ndarray]]:
    """Run ``test_fn`` (``make_test_step``, which also takes a test-time
    augmentation batch) over ``loader``'s batches -> the reference's
    results: per image, per class (n, 5) float32 [x1, y1, x2, y2, score]
    arrays, in the loader's order."""
    results: List[List[np.ndarray]] = []
    for bi, batch in enumerate(loader):
        # ``batch`` stays referenced until the copy back has waited for the
        # step, so its pinned pages outlive the asynchronous upload.
        results.extend(dets_to_results(*fetch_dets(*test_fn(batch)), num_classes))
        if progress:
            print(f"\rtest batch {bi + 1}", end="", flush=True)
    if progress:
        print()
    return results


def single_gpu_test(model_state: Dict, data_loader, show: bool = False,
                    out_dir: Optional[str] = None, progress: bool = False,
                    **kwargs) -> List[List[np.ndarray]]:
    """The reference's signature: ``model_state`` is ``load_model_state``'s
    dict (``test_fn``, ``num_classes``)."""
    if show or out_dir:
        raise NotImplementedError("drawing detections needs core/visualization, "
                                  "which is not ported yet (ROADMAP A, 'Long tail')")
    refuse_instance_outputs(getattr(model_state.get("handle"), "model", None))
    return run_test(model_state["test_fn"], data_loader, model_state["num_classes"],
                    progress=progress)


def _allgather_tables(table: np.ndarray) -> List[np.ndarray]:
    """Every rank's (n_r, 7) float32 table, in rank order: padded with -2
    rows to the largest n_r and all-gathered (CUDA tensors on NCCL, CPU
    tensors on gloo)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    world = get_dist_info()[1]
    count = torch.tensor([table.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    m = int(max(int(c) for c in counts))
    padded = np.concatenate([table, np.full((m - table.shape[0], 7), -2.0, np.float32)])
    mine = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [p.cpu().numpy() for p in parts]


def collect_results_allgather(results: Sequence, indices: Sequence[int], dataset_len: int,
                              num_classes: int) -> List[List[np.ndarray]]:
    """The ranks' results -> the whole dataset's, in its order, on every
    rank (``oadg_tpu/apis/test.py:76-150``; the reference's tmpdir pickle
    exchange, ``collect_results_cpu``, without a shared file system):

    1. this rank's detections (``results[k]`` is dataset image
       ``indices[k]``'s) become a float32 table of ``[ds_index, cls, score,
       x1, y1, x2, y2]`` rows, each image led by a presence row (cls -1);
    2. the tables are padded to the largest and all-gathered
       (``_allgather_tables``; without a process group the one table);
    3. decoded rank-major: an image's first copy (the lowest rank's, then
       the first within it) wins over the loader's wraparound duplicates.

    An image no rank processed gets empty arrays."""
    rows = [np.zeros((0, 7), np.float32)]
    for res, ds_i in zip(results, indices):
        rows.append(np.asarray([[float(ds_i), -1, 0, 0, 0, 0, 0]], np.float32))
        for c, arr in enumerate(res):
            if len(arr):
                a = np.asarray(arr, np.float32)              # (k, 5) x1 y1 x2 y2 score
                rows.append(np.concatenate(
                    [np.full((len(a), 1), float(ds_i), np.float32),
                     np.full((len(a), 1), float(c), np.float32), a[:, 4:5], a[:, :4]], 1))
    table = np.concatenate(rows, 0)
    blocks = _allgather_tables(table) if is_distributed() else [table]

    claimed = set()
    per_img: Dict[int, List[List[List[float]]]] = {}
    for blk in blocks:
        accepting: Dict[int, bool] = {}          # a presence row precedes its detections
        for row in blk:
            ds_i = int(row[0])
            if row[1] == -2.0 or ds_i < 0 or ds_i >= dataset_len:
                continue                         # padding
            if row[1] == -1.0:
                accepting[ds_i] = ds_i not in claimed
                if accepting[ds_i]:
                    claimed.add(ds_i)
                    per_img[ds_i] = [[] for _ in range(num_classes)]
                continue
            if accepting.get(ds_i):
                per_img[ds_i][int(row[1])].append([row[3], row[4], row[5], row[6], row[2]])
    return [[np.asarray(per_img[i][c] if i in per_img else [], np.float32).reshape(-1, 5)
             for c in range(num_classes)] for i in range(dataset_len)]


def multi_gpu_test(model_state: Dict, data_loader,
                   progress: bool = False) -> List[List[np.ndarray]]:
    """Distributed testing (``oadg_tpu/apis/test.py:154``; reference
    ``mmdet/apis/test.py:541``): this rank's slice of ``data_loader``
    through ``model_state``'s ``test_fn``, then every rank's results
    collected in the dataset's order (``collect_results_allgather``, keyed
    by the loader's ``result_indices``). One process whose loader keeps
    the dataset's order gets ``run_test``'s list as it is."""
    refuse_instance_outputs(getattr(model_state.get("handle"), "model", None))
    results = run_test(model_state["test_fn"], data_loader, model_state["num_classes"],
                       progress=progress and get_dist_info()[0] == 0)
    if hasattr(data_loader, "result_indices"):
        indices = [int(i) for i in np.asarray(data_loader.result_indices())[:len(results)]]
    else:
        indices = list(range(len(results)))
    n = len(data_loader.dataset) if hasattr(data_loader, "dataset") else len(results)
    if not is_distributed() and indices == list(range(len(results))):
        return results
    return collect_results_allgather(results, indices, n, model_state["num_classes"])


def load_model_state(cfg, checkpoint, device="cuda", dtype=None) -> Dict:
    """The config's detector for testing on ``device`` (``cuda`` unless
    told otherwise), in compute ``dtype`` (None: float32), with the weights
    of ``checkpoint`` (a ``torch.save``d ``state_dict``) or, for None or
    ``"none"``, seeded ones as ``init_detector`` makes them -> ``{handle,
    test_fn, num_classes}``."""
    if checkpoint in (None, "none"):
        checkpoint = None
    handle = init_detector(cfg, checkpoint=checkpoint, device=device, dtype=dtype)
    return dict(handle=handle, test_fn=make_test_step(handle.model),
                num_classes=_num_classes(handle.cfg))


def build_test_loader(cfg, test_cfg=None, pin_memory: bool = False, split: str = "test"):
    """One test set in test mode -> (dataset, loader): ``test_cfg`` (one
    dataset config, as ``tools/test.py:55`` takes it: a domain of the DWD
    config's ``data.test`` list) or else ``cfg.data[split]`` (``test``, or
    ``val`` for the evaluation after each training epoch); one image a
    batch, the config's ``workers_per_gpu`` threads, dataset order, the
    canvas of the pipeline's ``MultiScaleFlipAug`` scale, the images in
    pinned memory with ``pin_memory``."""
    if test_cfg is None:
        test_cfg = cfg["data"][split]
        if isinstance(test_cfg, (list, tuple)):
            raise ValueError(f"data.{split} is a list of {len(test_cfg)} dataset configs: "
                             "pass one of them as test_cfg (tools/torch_test_dwd.py "
                             "tests each)")
    tc = dict(test_cfg)
    tc["test_mode"] = True
    dataset = build_dataset(tc)
    static = None
    for p in tc.get("pipeline") or []:
        if p.get("type") == "MultiScaleFlipAug":
            static = static_hw_from_pipeline(
                [dict(type="Resize", img_scale=p.get("img_scale"))])
    loader = build_dataloader(dataset, samples_per_gpu=1,
                              workers_per_gpu=cfg["data"].get("workers_per_gpu", 2),
                              shuffle=False, static_hw=static, pin_memory=pin_memory)
    return dataset, loader
