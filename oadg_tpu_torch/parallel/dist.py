"""Data parallel over ``torch.distributed`` (counterpart of
``oadg_tpu/parallel/mesh.py``).

The JAX package runs data parallel as one program over a mesh: the
single-device step jitted with the batch sharded on the ``data`` axis, so
every loss normalizer, the supervised-contrastive loss (which pairs rows
across images) and live BatchNorm's statistics are global, and the
gradient is the global batch's. The port computes the same thing with one
process a rank:

- each rank's loss is its share of the global loss: the sum of its own
  rows' terms over the *global* normalizer (``all_reduce_sum`` of the
  ranks' counts), the contrastive rows gathered from every rank
  (``gather_rows``) and live BN's sums all-reduced;
- after the backward, ``sum_gradients`` sums the gradients across ranks,
  which makes them the gradient of the global loss (no average: every
  share is already divided by the global normalizer).

The global batch is the rank-ordered concatenation of each rank's images,
both views of an image on its own rank.

Whether a forward runs on one rank's shard of the global batch is the
train step's decision, not the process group's: ``make_train_step`` runs
``forward_train`` inside ``sharded_batch()``, and the losses and live BN
reduce over the ranks only there (``batch_is_sharded``). Outside it a
forward sees its whole batch, whatever group is initialized. The counts
that divide (pixels, rows, weights) are the ranks' real ones, summed, so
the ranks may hold shards of different sizes.

Every helper is the identity when no process group is initialized, so the
one-process path is the plain one. With a group, of any size, the
collectives run (NCCL on the card, gloo on the CPU); a collective that
fails raises.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# launcher -> (rank, world size, local rank) environment variables
_LAUNCHER_ENV = {
    "pytorch": ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    "mpi": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
}


def is_distributed() -> bool:
    """True when a process group is initialized (whatever its size)."""
    return dist.is_available() and dist.is_initialized()


def get_dist_info() -> Tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def launcher_env(launcher: str, environ=None) -> Optional[Tuple[int, int, int]]:
    """``(rank, world, local rank)`` from ``launcher``'s environment
    (``pytorch``: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``;
    ``slurm``: ``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_LOCALID``;
    ``mpi``: OpenMPI's ``OMPI_COMM_WORLD_*``), None when it is not set."""
    if launcher not in _LAUNCHER_ENV:
        raise ValueError(f"launcher {launcher!r}: one of {sorted(_LAUNCHER_ENV)}")
    env = os.environ if environ is None else environ
    rank_k, world_k, local_k = _LAUNCHER_ENV[launcher]
    if rank_k not in env or world_k not in env:
        return None
    return int(env[rank_k]), int(env[world_k]), int(env.get(local_k, 0))


def init_distributed(launcher: str = "pytorch", backend: Optional[str] = None,
                     device: str = "cuda") -> Tuple[int, int]:
    """Join the process group that ``launcher`` started (reference
    ``mmcv.runner.init_dist``; ``tools/torch_train.py --launcher``) ->
    ``(rank, world size)``.

    The rank, world size and local rank come from the launcher's
    environment (``launcher_env``); the rendezvous is
    ``tcp://MASTER_ADDR:MASTER_PORT`` (127.0.0.1 and 29500 unless set;
    SLURM's and MPI's launchers set neither, so export them). ``backend``
    defaults to ``nccl`` on ``device="cuda"``, which also binds this
    process to card ``local rank``, and ``gloo`` on the CPU. Without the
    launcher's environment nothing is initialized and ``(0, 1)`` returned;
    an initialized group is returned as it is."""
    if is_distributed():
        return get_dist_info()
    info = launcher_env(launcher)
    if info is None:
        return 0, 1
    rank, world, local_rank = info
    on_cuda = str(device).startswith("cuda")
    backend = backend or ("nccl" if on_cuda else "gloo")
    if on_cuda:
        torch.cuda.set_device(local_rank)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kwargs)
    return rank, world


def join_launcher(launcher: str, device: str = "cuda",
                  local_rank: Optional[int] = None) -> Tuple[int, str]:
    """The tools' ``--launcher``: join ``launcher``'s group
    (``init_distributed``; ``local_rank``, the old ``--local_rank``
    argument, where the environment has no ``LOCAL_RANK``) -> ``(rank, the
    device this process runs on)``: ``cuda:<local rank>`` for ``cuda``,
    else ``device``. Without the launcher's environment it raises."""
    if local_rank is not None:
        os.environ.setdefault("LOCAL_RANK", str(local_rank))
    rank, _ = init_distributed(launcher, device=device)
    if not is_distributed():
        raise RuntimeError(f"--launcher {launcher}: no launcher environment (RANK / "
                           "WORLD_SIZE and their kin) is set")
    if str(device) == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    return rank, device


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; no gradient): for
    normalizers and logged values. ``t`` itself without a group."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's ``t`` (``sizes[k]`` rows on rank ``k``)
    concatenated on dim 0 in rank order, each padded to the largest for
    the ``all_gather``. Backward: the incoming gradient summed over the
    ranks (each rank's loss share reads every rank's rows), then this
    rank's slice of it."""

    @staticmethod
    def forward(ctx, t, sizes):
        rank = dist.get_rank()
        ctx.lo, ctx.n = sum(sizes[:rank]), t.shape[0]
        top = max(sizes)
        if t.shape[0] < top:
            t = torch.cat([t, t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))])
        parts = [torch.empty_like(t) for _ in sizes]
        dist.all_gather(parts, t.contiguous())
        return torch.cat([part[:k] for part, k in zip(parts, sizes)], 0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad[ctx.lo:ctx.lo + ctx.n], None


def row_counts(n: int, device) -> List[int]:
    """Every rank's ``n``, in rank order (one ``all_gather`` of a count on
    ``device`` unless the group has one rank). ``[n]`` without a group."""
    world = get_dist_info()[1]
    if world == 1:
        return [int(n)]
    mine = torch.tensor([int(n)], dtype=torch.long, device=device)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [int(c) for c in torch.cat(parts).tolist()]


def gather_rows(t: torch.Tensor, sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``t`` (n, ...) of every rank -> (sum of the ranks' n, ...) in rank
    order, with the gradient routed back to each rank's own rows
    (``_GatherRows``; a tensor without a gradient, integers too, gathers
    the same way). ``sizes``, every rank's n where the caller knows them,
    saves ``row_counts``' gather. ``t`` itself without a group.
    (``torch.distributed.nn.functional.all_gather`` is not used: off NCCL
    its backward goes through ``all_to_all``, which gloo lacks.)"""
    if not is_distributed():
        return t
    sizes = row_counts(t.shape[0], t.device) if sizes is None else [int(k) for k in sizes]
    return _GatherRows.apply(t, sizes)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks with its gradient: every rank reads the sum,
    so the gradient of the global loss by one rank's term is the sum of the
    ranks' incoming gradients."""

    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` through which the gradient flows (SyncBN's
    per-channel sums). ``t`` itself without a group."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)


_SHARDED = [False]


@contextlib.contextmanager
def sharded_batch():
    """Inside: the model's forward runs on this rank's shard of the global
    batch (``make_train_step`` enters it around ``forward_train``), so that
    ``batch_is_sharded()`` holds under a process group and the losses and
    live BN reduce over the ranks."""
    prev, _SHARDED[0] = _SHARDED[0], True
    try:
        yield
    finally:
        _SHARDED[0] = prev


def batch_is_sharded() -> bool:
    """True inside ``sharded_batch()`` under a process group (of any size)."""
    return _SHARDED[0] and is_distributed()


def shard_sum(t: torch.Tensor) -> torch.Tensor:
    """A loss normalizer over the global batch: ``all_reduce_sum(t)`` when
    the batch is sharded (``batch_is_sharded``), else ``t``."""
    return all_reduce_sum(t) if batch_is_sharded() else t


def shard_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """A global sum that carries a gradient (CARL's weight mass):
    ``all_reduce_sum_grad(t)`` when the batch is sharded, else ``t``."""
    return all_reduce_sum_grad(t) if batch_is_sharded() else t


def gather_views_major(t: torch.Tensor, num_views: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows ``t`` (n, ...) of a views-major batch (``num_views``
    equal chunks, each over this rank's images in order) -> the global
    batch's rows in the one-process order (views-major over the
    rank-ordered images: view 0 of every rank's images, then view 1, ...)
    and the positions of this rank's rows in it (n,). A rank's chunks
    gathered as they lie would interleave the views ([rank 0 view 0, rank 0
    view 1, rank 1 view 0, ...]), and a stable rank over rows that tie
    across views would then land on other rows. Without a sharded batch:
    ``t`` and ``arange(n)``. No gradient flows back."""
    n = t.shape[0]
    if not batch_is_sharded():
        return t, torch.arange(n, device=t.device)
    rank = dist.get_rank()
    sizes = row_counts(n, t.device)
    if any(k % num_views for k in sizes):
        raise ValueError(f"rows {sizes} do not split into {num_views} views on every rank")
    parts = [torch.split(part, k // num_views)
             for part, k in zip(torch.split(gather_rows(t.detach(), sizes), sizes), sizes)]
    out = torch.cat([p[v] for v in range(num_views) for p in parts])
    chunk, lo = sum(sizes) // num_views, sum(sizes[:rank]) // num_views
    mine = torch.cat([torch.arange(v * chunk + lo, v * chunk + lo + n // num_views,
                                   device=t.device) for v in range(num_views)])
    return out, mine


def sum_gradients(params: Iterable[torch.nn.Parameter]):
    """Sum the gradients of the trainable ``params`` over the ranks in
    place: one flat buffer a dtype, one ``all_reduce(SUM)`` each, which
    also carries a presence flag a parameter. A gradient missing on a rank
    counts as zeros; a parameter with a gradient on no rank keeps none (so
    that the optimizer skips it, as in one process). Every rank passes the
    same parameters. Nothing without a group."""
    if not is_distributed():
        return
    by_dtype = {}
    for p in params:
        if p.requires_grad:
            by_dtype.setdefault(p.dtype, []).append(p)
    for group in by_dtype.values():
        flags = torch.tensor([p.grad is not None for p in group], dtype=group[0].dtype,
                             device=group[0].device)
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in group] + [flags])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        present = (flat[-len(group):] > 0).tolist()
        offset = 0
        for p, has in zip(group, present):
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p) if has else None
            offset += n


def broadcast_state(model: torch.nn.Module):
    """Every parameter and buffer of ``model`` from rank 0 (mmdet's DDP wrap
    does this once at construction): the ranks start from one state whatever
    each loaded. Nothing without a group."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
