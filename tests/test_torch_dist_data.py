"""Data parallel on the CPU: the samplers, the loader's rank slices, result
collection, ``multi_gpu_test``, the launchers' environments and the train
and test tools with ``--launcher``, against the JAX package where it has
the counterpart (``oadg_tpu/data/samplers.py``, ``PrefetchLoader``,
``oadg_tpu/apis/test.py:76-177``; ``tests/test_multihost.py:21-51``,
``tests/test_dist_eval.py``).

One 2-process gloo group for the file (``torch_dist_cases``), joined
through ``init_distributed`` from SLURM's environment: ``multi_gpu_test``
over 11 images (one rank gets a wraparound duplicate), the loader's length
and ``result_indices`` taken from the group, and the two tools on the tiny
OA-DG config (``torch_data_cases.tiny_train_cfg``: 4 PNGs, 2 a rank, 2
epochs of one step, an evaluation after each).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import torch_data_cases
import torch_dist_cases as dc
from oadg_tpu.apis.test import collect_results_allgather as jax_collect
from oadg_tpu.data import samplers as jax_samplers
from oadg_tpu.data.builder import PrefetchLoader as JaxPrefetchLoader
from oadg_tpu_torch.apis import collect_results_allgather, load_model_state, single_gpu_test
from oadg_tpu_torch.apis.test import build_test_loader, multi_gpu_test
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.data import build_dataloader, samplers
from oadg_tpu_torch.parallel import get_dist_info, init_distributed, is_distributed
from oadg_tpu_torch.parallel import launcher_env

torch.set_num_threads(2)
COLLECT_IMAGES = 11


class FlagDataset:
    """31 samples in two aspect groups (``flag``), each its index."""

    def __init__(self, n=31):
        self.flag = (np.arange(n) % 3 == 0).astype(np.uint8)

    def __len__(self):
        return len(self.flag)

    def __getitem__(self, i):
        return {"idx": np.array([i])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_data")
    cfg = torch_data_cases.tiny_train_cfg(tmp / "data")
    config = str(tmp / "tiny.py")
    cfg.dump(config)
    job = dict(tasks=["collect", "syncnorm", "tools"],
               collect=dict(n=COLLECT_IMAGES, indices=[[3, 0, 6, 1], [5, 2, 4, 0, 1]]),
               tools=dict(config=config, work_dir=str(tmp / "work"), out=str(tmp / "r.pkl"),
                          robust_out=str(tmp / "robust.pkl")))
    out = dc.spawn(job, 2, tmp, launcher="slurm", timeout=600)
    return dict(ranks=out, job=job, config=config, tmp=tmp)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["GroupSampler", "DistributedGroupSampler",
                                  "DistributedSampler", "InfiniteBatchSampler",
                                  "InfiniteGroupBatchSampler"])
def test_samplers_match_jax(name, world):
    """Each sampler yields the JAX package's indices for the same seed, rank
    and world size (the infinite ones: their first 40 batches), with the
    same length."""
    ds = FlagDataset()
    for rank in range(world):
        if name == "GroupSampler":
            if rank:
                continue
            kw = dict(samples_per_gpu=world + 1, seed=7)
        elif name == "DistributedGroupSampler":
            kw = dict(samples_per_gpu=2, num_replicas=world, rank=rank, seed=7)
        elif name == "DistributedSampler":
            kw = dict(num_replicas=world, rank=rank, seed=7)
        else:
            kw = dict(batch_size=3, num_replicas=world, rank=rank, seed=7)
        got, want = getattr(samplers, name)(ds, **kw), getattr(jax_samplers, name)(ds, **kw)
        if name.startswith("Infinite"):
            it_g, it_w = iter(got), iter(want)
            assert [next(it_g) for _ in range(40)] == [next(it_w) for _ in range(40)]
        else:
            assert list(got) == list(want) and list(got) == list(want)   # two epochs
            assert len(got) == len(want)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_rank_slices_match_jax(world, shuffle):
    """``build_dataloader``'s batches, ``__len__`` and ``result_indices`` on
    each rank equal the JAX ``PrefetchLoader``'s for the same seed, rank and
    world; the ranks step equally often and together cover the one-process
    batches (``tests/test_multihost.py:21-51``)."""
    ds = FlagDataset()

    def batches(loader):
        loader.batcher = lambda s: {"idx": np.concatenate([x["idx"] for x in s])}
        return [tuple(b["idx"].tolist()) for b in loader]

    per_rank = []
    for rank in range(world):
        got = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=1, shuffle=shuffle,
                               seed=42, rank=rank, world_size=world)
        want = JaxPrefetchLoader(ds, samples_per_gpu=2, num_workers=1, shuffle=shuffle,
                                 seed=42, drop_last=shuffle, rank=rank, world_size=world)
        np.testing.assert_array_equal(got.result_indices(), want.result_indices())
        assert len(got) == len(want)
        b = batches(got)
        assert b == batches(want)
        assert len(b) == len(got)
        # after an iteration: the order it yielded
        np.testing.assert_array_equal(got.result_indices(),
                                      np.asarray([i for bt in b for i in bt], np.int64))
        per_rank.append(b)
    assert len({len(b) for b in per_rank}) == 1
    solo = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=1, shuffle=shuffle,
                            seed=42, rank=0, world_size=1)
    assert set().union(*map(set, per_rank)) == set(batches(solo))


def test_loader_takes_the_rank_from_the_group(ranks):
    """Without ``rank`` / ``world_size`` the loader takes the group's:
    ``multi_gpu_test``'s loader of 11 images, one a batch, steps 6 times on
    each rank, rank 1's last batch wrapping around to image 0."""
    want = [JaxPrefetchLoader(dc.IndexDataset(COLLECT_IMAGES), samples_per_gpu=1,
                              shuffle=False, drop_last=False, rank=r, world_size=2)
            for r in range(2)]
    for r, out in enumerate(ranks["ranks"]):
        assert out["group"] == dict(rank=r, world=2, backend="gloo")
        assert out["collect"]["len"] == len(want[r]) == 6
        np.testing.assert_array_equal(out["collect"]["result_indices"],
                                      want[r].result_indices())
    assert list(ranks["ranks"][1]["collect"]["result_indices"]) == [1, 3, 5, 7, 9, 0]
    assert not is_distributed() and get_dist_info() == (0, 1)
    loader = build_dataloader(dc.IndexDataset(4), samples_per_gpu=2, shuffle=False)
    assert (loader.rank, loader.world_size) == (0, 1)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["order_restore", "wraparound_duplicates"])
def test_collect_results_match_jax(case):
    """One process: ``collect_results_allgather`` restores the dataset's
    order and keeps the first copy of a wraparound duplicate, as the JAX
    function does (``tests/test_dist_eval.py``'s fake results)."""
    if case == "order_restore":
        n, idxs = 7, [3, 0, 6, 1, 5, 2, 4]
        results = [dc.fake_result(i) for i in idxs]
    else:
        n, idxs = 4, [0, 1, 2, 3, 0, 1]
        results = [dc.fake_result(i) for i in range(4)] + [
            [np.full((1, 5), -99, np.float32) for _ in range(3)]] * 2
    got = collect_results_allgather(results, idxs, n, 3)
    _same_results(got, jax_collect(results, idxs, n, 3))
    _same_results(got, [dc.fake_result(i) for i in range(n)])


def test_collect_results_over_two_ranks(ranks):
    """Two ranks' results, rank 1 with duplicates of rank 0's images and
    images 7-10 on no rank: every rank gets the JAX function's list for the
    ranks' tables in rank order (rank 0's copies win; missing images
    empty)."""
    idx = ranks["job"]["collect"]["indices"]
    results = [dc.fake_result(i) for r in range(2) for i in idx[r]]
    want = jax_collect(results, idx[0] + idx[1], COLLECT_IMAGES, 3)
    for out in ranks["ranks"]:
        _same_results(out["collect"]["gathered"], want)


def test_multi_gpu_test_equals_single_gpu_test(ranks):
    """``multi_gpu_test`` over 11 images on 2 ranks gives both ranks the list
    ``single_gpu_test`` gives over the whole loader in one process."""
    loader = build_dataloader(dc.IndexDataset(COLLECT_IMAGES), samples_per_gpu=1,
                              workers_per_gpu=1, shuffle=False)
    want = single_gpu_test(dict(test_fn=dc.fake_test_fn, num_classes=3), loader)
    _same_results(want, [dc.fake_result(i) for i in range(COLLECT_IMAGES)])
    _same_results(multi_gpu_test(dict(test_fn=dc.fake_test_fn, num_classes=3), loader), want)
    for out in ranks["ranks"]:
        _same_results(out["collect"]["merged"], want)


def test_train_and_test_tools_with_launcher(ranks):
    """``tools/torch_train.py --launcher pytorch`` on 2 ranks: one step an
    epoch (4 images, 2 a rank), rank 0 alone writes the checkpoints and the
    logs, both ranks end with the whole val set's results; ``torch_test.py
    --launcher pytorch`` on the checkpoint writes (rank 0) the results the
    one-process test of the same checkpoint gives."""
    r0, r1 = (r["tools"] for r in ranks["ranks"])
    assert r0["loader_len"] == r1["loader_len"] == 1
    assert r0["iters"] == r1["iters"] == 2 and r0["saved"]
    _same_results(r1["val"], r0["val"])
    assert r0["metrics"] is not None and r1["metrics"] is None
    work = ranks["job"]["tools"]["work_dir"]
    with open(os.path.join(work, "log.json")) as f:
        lines = [line for line in f.read().splitlines() if line]
    assert len(lines) == 4                         # 2 train and 2 val lines, once
    cfg = load_config(ranks["config"])
    _, loader = build_test_loader(cfg)
    state = load_model_state(cfg, os.path.join(work, "epoch_2.pth"), device="cpu")
    with open(ranks["job"]["tools"]["out"], "rb") as f:
        _same_results(pickle.load(f), single_gpu_test(state, loader))


def test_robustness_tool_with_launcher(ranks, tmp_path):
    """``tools/torch_test_robustness.py --launcher pytorch`` on 2 ranks
    writes (rank 0) the pickle and returns the P / mPC / rPC that the
    one-process run of the tool gives on the same checkpoint."""
    r0, r1 = (r["tools"]["robust"] for r in ranks["ranks"])
    assert r1 is None and r0 is not None
    tool = dc._tool("torch_test_robustness")
    ckpt = os.path.join(ranks["job"]["tools"]["work_dir"], "epoch_2.pth")
    want = tool.main([ranks["config"], ckpt, "--device", "cpu", "--corruptions",
                      "gaussian_noise", "--severities", "0", "1",
                      "--out", str(tmp_path / "one.pkl")])
    assert len(r0) == len(want)
    for got, w in zip(r0, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(w))
    with open(ranks["job"]["tools"]["robust_out"], "rb") as f, \
            open(tmp_path / "one.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)


def test_sync_norm_hook_averages_live_bn_statistics_over_the_ranks(ranks):
    """``SyncNormHook`` over 2 processes: every live BN's stored mean and
    variance become the ranks' average on both ranks (mmdet's behaviour; the
    port's SyncBN keeps them equal already, so in training it keeps them)."""
    got = [r["syncnorm"] for r in ranks["ranks"]]
    assert got[0].keys() == got[1].keys() and len(got[0]) == 4
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
    n = got[0]["0.running_mean"].numel()
    assert torch.equal(got[0]["0.running_mean"], torch.arange(n) + 5.0)
    assert torch.equal(got[0]["1.running_var"], torch.full((2,), 1.5))


@pytest.mark.parametrize("tool", ["torch_train", "torch_test", "torch_test_dwd",
                                  "torch_test_robustness"])
def test_tools_refuse_a_launcher_without_its_environment(tool, monkeypatch):
    for names in dc.LAUNCHER_ENV.values():
        for k in names:
            monkeypatch.delenv(k, raising=False)
    argv = ["c.py"] + ([] if tool == "torch_train" else ["none"])
    with pytest.raises(RuntimeError, match="no launcher environment"):
        dc._tool(tool).main(argv + ["--launcher", "slurm", "--device", "cpu"])
    assert not is_distributed()


@pytest.mark.parametrize("launcher", ["pytorch", "slurm", "mpi"])
def test_launcher_environments(launcher):
    """Each launcher's rank, world size and local rank are read; another
    launcher's variables are not; an unknown launcher raises."""
    env = dc.launcher_environ(launcher, 3, 4, 1234)
    env[dc.LAUNCHER_ENV[launcher][2]] = "1"
    assert launcher_env(launcher, env) == (3, 4, 1)
    others = [k for k in dc.LAUNCHER_ENV if k != launcher]
    assert all(launcher_env(o, env) is None for o in others)
    with pytest.raises(ValueError):
        launcher_env("ssh", env)


def test_init_distributed_without_a_launcher_does_nothing(monkeypatch):
    for names in dc.LAUNCHER_ENV.values():
        for k in names:
            monkeypatch.delenv(k, raising=False)
    for launcher in dc.LAUNCHER_ENV:
        assert init_distributed(launcher, device="cpu") == (0, 1)
    assert not is_distributed()


def test_train_detector_distributed_needs_a_group():
    """``train_detector(distributed=True)`` without a process group refuses
    before building anything (the tools join one with ``--launcher``)."""
    from oadg_tpu_torch.apis import train_detector
    with pytest.raises(ValueError, match="init_distributed"):
        train_detector(torch.nn.Linear(1, 1), {}, {}, distributed=True)


def test_helpers_without_a_group_are_identities():
    """One process, no group: ``sharded_batch()`` shards nothing, and
    ``shard_sum``, ``gather_rows``, ``all_reduce_sum_grad`` and
    ``row_counts`` return their input."""
    from oadg_tpu_torch.parallel import (all_reduce_sum_grad, batch_is_sharded, gather_rows,
                                         row_counts, shard_sum, sharded_batch)
    assert not is_distributed()
    x = torch.arange(6.0).reshape(3, 2)
    with sharded_batch():
        assert not batch_is_sharded()
        assert shard_sum(x) is x and gather_rows(x) is x and all_reduce_sum_grad(x) is x
        assert row_counts(3, "cpu") == [3]
    assert not batch_is_sharded()
