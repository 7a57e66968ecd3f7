"""Samplers (port of ``oadg_tpu/data/samplers.py``; reference
``mmdet/datasets/samplers/``): ``GroupSampler``, ``DistributedGroupSampler``,
``DistributedSampler``, ``InfiniteBatchSampler`` and
``InfiniteGroupBatchSampler``, each a stream of one ``np.random.RandomState``
seeded with ``seed``, so that it yields the JAX package's indices one for
one for the same seed, rank and world size.

Nothing in the port draws its order from them: ``PrefetchLoader`` groups,
shuffles and slices its batches itself, in the JAX package's
``PrefetchLoader``'s order, which these samplers do not yield. They are
the reference's sampler interface for code that builds samplers directly
(as in the JAX package, where they serve the same purpose only). The
distributed ones take ``rank`` and ``num_replicas`` as given.
"""
from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


def _flag(dataset) -> np.ndarray:
    return getattr(dataset, "flag", np.zeros(len(dataset), np.uint8))


class GroupSampler:
    """Aspect-ratio-grouped order (reference ``group_sampler.py:10``): each
    group shuffled and padded to a multiple of ``samples_per_gpu`` with its
    own first indices, then the batches permuted."""

    def __init__(self, dataset, samples_per_gpu: int = 1, seed: int = 0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.flag = _flag(dataset)
        self.rng = np.random.RandomState(seed)
        sizes = np.bincount(self.flag)
        self.num_samples = int(sum(int(np.ceil(s / samples_per_gpu)) * samples_per_gpu
                                   for s in sizes))

    def __iter__(self) -> Iterator[int]:
        indices = []
        for g in np.unique(self.flag):
            idx = np.where(self.flag == g)[0]
            self.rng.shuffle(idx)
            pad = (-len(idx)) % self.samples_per_gpu
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            indices.append(idx)
        batches = np.concatenate(indices).reshape(-1, self.samples_per_gpu)
        order = self.rng.permutation(len(batches))
        return iter(batches[order].reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class DistributedGroupSampler(GroupSampler):
    """The group order's every ``num_replicas``-th index from ``rank``
    (reference ``group_sampler.py:51``)."""

    def __init__(self, dataset, samples_per_gpu: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        super().__init__(dataset, samples_per_gpu, seed)
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(np.ceil(super().__len__() / num_replicas))

    def __iter__(self):
        return iter(list(super().__iter__())[self.rank::self.num_replicas])

    def __len__(self):
        return self.num_samples


class DistributedSampler:
    """The dataset's order (shuffled with ``shuffle``), every
    ``num_replicas``-th index from ``rank``."""

    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return iter(idx[self.rank::self.num_replicas].tolist())

    def __len__(self):
        return int(np.ceil(len(self.dataset) / self.num_replicas))


class InfiniteBatchSampler:
    """Endless batches of ``batch_size`` from a stream of permutations, the
    rank's every ``num_replicas``-th index of each (reference
    ``infinite_sampler.py:98``)."""

    def __init__(self, dataset, batch_size: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def _stream(self):
        n = len(self.dataset)
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            yield from order[self.rank::self.num_replicas].tolist()

    def __iter__(self):
        stream = self._stream()
        while True:
            yield list(itertools.islice(stream, self.batch_size))


class InfiniteGroupBatchSampler(InfiniteBatchSampler):
    """Endless batches of one aspect-ratio group each (reference
    ``infinite_sampler.py:10``): the stream's indices fill a bucket a
    group, and a full bucket is yielded."""

    def __iter__(self):
        flag = _flag(self.dataset)
        buckets = {g: [] for g in np.unique(flag)}
        stream = self._stream()
        while True:
            i = next(stream)
            g = flag[i]
            buckets[g].append(i)
            if len(buckets[g]) == self.batch_size:
                yield buckets[g]
                buckets[g] = []
