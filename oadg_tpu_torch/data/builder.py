"""Dataset and loader builders (port of ``oadg_tpu/data/builder.py:21-256``).

``StaticBatcher`` collates pipeline outputs into one numpy batch: images
zero-padded onto one canvas (``static_hw``, or the batch's largest image
rounded up to ``divisor``), ground truth padded to ``max_gt`` with a
validity mask, each sample's metadata under ``metas``; a test-time
augmentation sample (``MultiScaleFlipAug`` with several scales or
``flip=True``) gives one such batch a view. Samples marked
``norm_on_device`` (the ``OAMix`` op's training samples) ship only the
``img_raw`` canvas, in the samples' own dtype (uint8, or float32 after a
float op such as ``PhotoMetricDistortion``), no float32 ``img``: the train
step normalizes on the card. ``PrefetchLoader`` builds batches in worker threads (the decoder's and
numpy's inner loops release the interpreter lock) and yields them in batch
order; batches are grouped by the dataset's aspect-ratio ``flag``; a
shuffled order is a function of the seed and the epoch (``set_epoch``). The
batches equal the JAX package's key by key. With ``pin_memory`` the image
stack is allocated in page-locked memory, so that the step's upload to the
card is an asynchronous copy.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..utils.registry import DATASETS, build_from_cfg

def build_dataset(cfg, default_args=None):
    """``cfg`` (``type`` and its arguments) -> the registered dataset."""
    return build_from_cfg(dict(cfg), DATASETS, default_args)


def static_hw_from_pipeline(pipeline, divisor: int = 32):
    """The static batch canvas (h, w): the largest scale of the pipeline's
    ``Resize`` rounded up to ``divisor`` (``oadg_tpu/apis/train.py:41``);
    None without a ``Resize`` scale."""
    r = next((p for p in pipeline or [] if isinstance(p, dict)
              and p.get("type") == "Resize"), None)
    if r is None or r.get("img_scale") is None:
        return None
    scales = r["img_scale"] if isinstance(r["img_scale"], list) else [r["img_scale"]]
    long_edge = max(max(s) for s in scales)
    short_edge = max(min(s) for s in scales)
    rnd = lambda v: -(-v // divisor) * divisor          # noqa: E731
    return (rnd(short_edge), rnd(long_edge))


class StaticBatcher:
    """Collate pipeline outputs into a static-shape batch dict: ``img``
    (B, H, W, C) float32 or, for ``norm_on_device`` samples, ``img_raw``
    (B, H, W, C) in the samples' dtype alone; ``img_shape`` (B, 2), ``scale_factor`` (B, 4),
    with boxes ``gt_bboxes`` (B, max_gt, 4), ``gt_labels``, ``gt_valid``,
    with masks ``gt_masks`` (B, max_gt, M0, M0) float32, zero-filled (M0 of
    the first sample, 56 when it has no instance), and ``metas``."""

    def __init__(self, static_hw, max_gt: int = 128, divisor: int = 32,
                 pin_memory: bool = False):
        self.static_hw = static_hw
        self.max_gt = max_gt
        self.divisor = divisor
        self.pin_memory = pin_memory

    def _canvas(self, shape, dtype=np.float32) -> np.ndarray:
        if not self.pin_memory:
            return np.empty(shape, dtype)
        import torch
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(shape, dtype=tdtype, pin_memory=True).numpy()

    def _stack(self, images, h, w, dtype) -> np.ndarray:
        """The images zero-padded onto one (B, h, w, ...) canvas of ``dtype``."""
        out = self._canvas((len(images), h, w) + images[0].shape[2:], dtype)
        for i, im in enumerate(images):
            hi, wi = im.shape[:2]
            out[i, :hi, :wi] = im
            out[i, hi:] = 0
            out[i, :hi, wi:] = 0
        return out

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        if samples and samples[0].get("__tta__"):
            return self._collate_views(samples)
        b = len(samples)
        if self.static_hw is not None:
            h, w = self.static_hw
        else:
            d = self.divisor
            h = -(-max(s["img"].shape[0] for s in samples) // d) * d
            w = -(-max(s["img"].shape[1] for s in samples) // d) * d
        norm_on_device = bool(samples[0].get("norm_on_device"))
        if "img_raw" in samples[0] and not norm_on_device:
            raise NotImplementedError("img_raw without norm_on_device comes from the host "
                                      "OA-Mix, which the port has not yet "
                                      "(ROADMAP A, 'Data layer leftovers')")
        batch = {
            "img_shape": np.asarray(
                [s["img_metas"]["img_shape"][:2] for s in samples], np.float32),
            "scale_factor": np.stack([
                np.asarray(s["img_metas"].get("scale_factor", [1, 1, 1, 1]),
                           np.float32).reshape(-1)[:4] for s in samples]),
        }
        if norm_on_device:                # in the samples' own dtype, as the JAX collate
            raws = [s["img_raw"] for s in samples]
            batch["img_raw"] = self._stack(raws, h, w, np.result_type(*raws))
        else:
            batch["img"] = self._stack([s["img"] for s in samples], h, w, np.float32)
        if "gt_bboxes" in samples[0]:
            g = self.max_gt
            gt = np.zeros((b, g, 4), np.float32)
            lbl = np.zeros((b, g), np.int32)
            valid = np.zeros((b, g), bool)
            for i, s in enumerate(samples):
                n = min(len(s["gt_bboxes"]), g)
                gt[i, :n] = s["gt_bboxes"][:n]
                lbl[i, :n] = s["gt_labels"][:n]
                valid[i, :n] = True
            batch.update(gt_bboxes=gt, gt_labels=lbl, gt_valid=valid)
            if "gt_masks" in samples[0]:          # box-cropped (n, M0, M0) each
                first = samples[0]["gt_masks"]
                m0 = first.shape[-1] if first.size else 56
                gm = np.zeros((b, g, m0, m0), np.float32)
                for i, s in enumerate(samples):
                    n = min(len(s["gt_masks"]), g)
                    gm[i, :n] = s["gt_masks"][:n]
                batch["gt_masks"] = gm
        batch["metas"] = [s["img_metas"] for s in samples]
        return batch

    def _collate_views(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        """``MultiScaleFlipAug`` samples of several views (each key a list,
        one entry a view; ``:40-56``) -> ``__tta_views__``, one batch a view
        collated as any other (its own canvas), ``__tta_metas__``, the
        views' ``(flip, flip_direction)``, and ``metas``, the first view's
        metadata of each sample."""
        views, metas = [], []
        for vi in range(len(samples[0]["img"])):
            views.append(self([{k: (s[k][vi] if isinstance(s[k], list) else s[k])
                                for k in s if k != "__tta__"} for s in samples]))
            m0 = samples[0]["img_metas"][vi]
            metas.append((bool(m0.get("flip", False)),
                          str(m0.get("flip_direction", "horizontal"))))
        return {"__tta_views__": views, "__tta_metas__": tuple(metas),
                "metas": [s["img_metas"][0] for s in samples]}


class PrefetchLoader:
    """Iterator over grouped static batches, built by ``num_workers``
    threads and yielded strictly in batch order. ``shuffle`` draws the
    order from ``seed``; without it batches follow the dataset's order
    within each ``flag`` group. ``rank`` / ``world_size`` take a
    rank-strided slice of the batch list (padded so that every rank steps
    the same number of times).

    The shuffled orders are one stream of ``RandomState(seed)``, one draw an
    iteration, as in the JAX package; iteration ``e`` (counting from 0)
    yields draw ``e``, replayed from the seed. ``set_epoch(e)`` makes the
    next iteration yield draw ``e`` whatever came before, so that a run
    resumed at epoch ``e`` sees the order the uninterrupted run saw. (The JAX loader restarts its stream in a new
    process, so a JAX run resumed at epoch ``e`` replays draw 0.)"""

    def __init__(self, dataset, samples_per_gpu: int, num_workers: int = 2,
                 shuffle: bool = True, seed: Optional[int] = None,
                 static_hw=None, max_gt: int = 128, drop_last: bool = True,
                 prefetch: int = 4, rank: int = 0, world_size: int = 1,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.bs = samples_per_gpu
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.epoch = 0            # the draw the next iteration yields
        self.last_epoch = None    # the draw the last iteration yielded
        self.batcher = StaticBatcher(static_hw, max_gt=max_gt, pin_memory=pin_memory)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rank = rank
        self.world_size = max(1, world_size)

    def __len__(self):
        n = len(self.dataset)
        per = n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs
        if self.world_size > 1:
            per = (per + self.world_size - 1) // self.world_size
        return per

    def set_epoch(self, epoch: int):
        """The next iteration yields the order of epoch ``epoch``."""
        self.epoch = int(epoch)

    def _epoch_batches(self) -> List[np.ndarray]:
        batches = self._draw(self.epoch)
        self.last_epoch = self.epoch
        self.epoch += 1
        return batches

    def _draw(self, epoch: int) -> List[np.ndarray]:
        """The batches of draw ``epoch`` of the seed's stream."""
        if self.shuffle:
            self.rng = np.random.RandomState(self.seed)
            for _ in range(epoch):
                self._batch_indices()
        return self._batch_indices()

    def result_indices(self) -> np.ndarray:
        """The dataset indices of this rank's batches, in the order the last
        iteration yielded them (before any iteration: the next one's), the
        wraparound padding included: the key ``multi_gpu_test`` restores the
        dataset's order by (``oadg_tpu/data/builder.py:168-177``)."""
        batches = self._draw(self.epoch if self.last_epoch is None else self.last_epoch)
        if not batches:
            return np.zeros(0, np.int64)
        return np.concatenate([np.asarray(b, np.int64) for b in batches])

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        flag = getattr(self.dataset, "flag", np.zeros(n, np.uint8))
        batches = []
        for group in np.unique(flag):
            idxs = np.where(flag == group)[0]
            if self.shuffle:
                self.rng.shuffle(idxs)
            pad = (-len(idxs)) % self.bs           # fill the group's last batch
            if pad and not self.drop_last:
                idxs = np.concatenate([idxs, idxs[:pad]])
            full = len(idxs) // self.bs * self.bs
            batches.extend(np.split(idxs[:full], max(full // self.bs, 1))
                           if full else [])
        if self.shuffle:
            order = self.rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        if self.world_size > 1:
            pad = (-len(batches)) % self.world_size
            batches = batches + batches[:pad]
            batches = batches[self.rank::self.world_size]
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._epoch_batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        it_lock = threading.Lock()
        it = iter(enumerate(batches))

        def worker():
            while not stop.is_set():
                with it_lock:
                    try:
                        bi, idxs = next(it)
                    except StopIteration:
                        break
                try:
                    q.put((bi, self.batcher([self.dataset[int(i)] for i in idxs])))
                except Exception as exc:           # handed to the consumer, raised there
                    q.put((bi, exc))
                    break
            q.put(None)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        # Workers finish out of order: early arrivals wait in ``buf`` so that
        # batches come out in batch order (results align with the dataset).
        done = 0
        buf: Dict[int, Any] = {}
        next_bi = 0
        try:
            while next_bi < len(batches):
                if next_bi in buf:
                    b = buf.pop(next_bi)
                    if isinstance(b, Exception):
                        raise b
                    yield b
                    next_bi += 1
                    continue
                if done >= len(threads):
                    raise RuntimeError(f"the loader's workers stopped before batch {next_bi}")
                item = q.get()
                if item is None:
                    done += 1
                    continue
                buf[item[0]] = item[1]
        finally:
            stop.set()
            for t in threads:
                while t.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=0.1)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 2,
                     num_gpus: int = 1, dist: bool = False, shuffle: bool = True,
                     seed: Optional[int] = None, static_hw=None, max_gt: int = 128,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     pin_memory: bool = False, **kwargs) -> PrefetchLoader:
    """The reference's builder signature -> a ``PrefetchLoader`` that drops
    the last partial batch only when it shuffles. ``rank`` and
    ``world_size`` default to ``torch.distributed``'s (one process without a
    group), as the JAX package takes them from ``jax.process_*``
    (``:244-251``): each rank loads its slice of the batches, and
    ``samples_per_gpu`` is per rank. ``dist`` and ``num_gpus`` are
    accepted for the signature and read from the group instead."""
    if rank is None or world_size is None:
        from ..parallel import get_dist_info
        g_rank, g_world = get_dist_info()
        rank = g_rank if rank is None else rank
        world_size = g_world if world_size is None else world_size
    return PrefetchLoader(dataset, samples_per_gpu, num_workers=workers_per_gpu,
                          shuffle=shuffle, seed=seed, static_hw=static_hw,
                          max_gt=max_gt, drop_last=shuffle, rank=rank,
                          world_size=world_size, pin_memory=pin_memory)
