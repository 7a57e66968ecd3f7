"""The 2-process gloo runs of the data-parallel tests (``test_torch_dist_step.py``,
``test_torch_dist_data.py``) on the CPU.

``spawn(job, world, tmp_path, launcher)`` saves ``job`` (a dict: ``tasks``,
the names of ``TASKS`` to run, and their inputs), starts ``world``
processes of this file with ``launcher``'s environment (torchrun's, SLURM's
or OpenMPI's rank variables, ``MASTER_ADDR`` and a free localhost port), each
of which joins the gloo group through ``parallel.init_distributed``, runs
the tasks in order and saves their results; it returns each rank's results.
A process that fails or outlives ``timeout`` fails the caller. Nothing here
imports JAX.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCHER_ENV = {
    "pytorch": ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    "mpi": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
}


def launcher_environ(launcher, rank, world, port):
    """The environment ``launcher`` gives rank ``rank``: its rank variables,
    ``MASTER_ADDR`` and ``MASTER_PORT``, and none of another launcher's."""
    env = {k: v for k, v in os.environ.items()
           if not any(k in names for names in LAUNCHER_ENV.values())}
    rank_k, world_k, local_k = LAUNCHER_ENV[launcher]
    env.update({rank_k: str(rank), world_k: str(world), local_k: str(rank),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    return env


def start(job, world, tmp_path, launcher="pytorch"):
    """Save ``job`` and start the ``world`` ranks -> a handle for ``finish``."""
    path = os.path.join(str(tmp_path), "job.pt")
    torch.save(job, path)
    port = free_port()
    procs = []
    for r in range(world):
        env = launcher_environ(launcher, r, world, port)
        env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), launcher,
                                       path], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    return path, procs


def finish(handle, timeout=300):
    """Wait for the ranks (killing them after ``timeout`` seconds) -> each
    rank's results; a rank that failed fails the caller."""
    path, procs = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(len(procs))]


def spawn(job, world, tmp_path, launcher="pytorch", timeout=300):
    return finish(start(job, world, tmp_path, launcher), timeout)


def plain(o):
    """Config dicts of either package -> plain dicts and lists (a job file
    must unpickle without the JAX package)."""
    if isinstance(o, dict):
        return {k: plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(plain(v) for v in o)
    return o


def rank_rows(n_images, views, rank, world):
    """The rows of rank ``rank`` in a views-major batch of ``n_images`` an
    view: its ``n_images // world`` images, every view."""
    b = n_images // world
    return [v * n_images + rank * b + i for v in range(views) for i in range(b)]


def image_rows(n_images, rank, world):
    b = n_images // world
    return list(range(rank * b, (rank + 1) * b))


def local_draws(given, n_images, views, rank, world):
    """Rank ``rank``'s rows of the global batch's draws: per image and
    view (``rpn.*``, ``random_boxes``) or per clean image (``rcnn.*``,
    ``cont``)."""
    out = {}
    for k, u in given.items():
        rows = (rank_rows(n_images, views, rank, world) if u.shape[0] == n_images * views
                else image_rows(n_images, rank, world))
        out[k] = u[rows]
    return out


def local_batch(batch, n_images, views, rank, world):
    rows = rank_rows(n_images, views, rank, world)
    return {k: v[rows] for k, v in batch.items()}


def run_step(model, state, batch, draws, optimizer_cfg, grad_clip, lr=0.01):
    """One ``make_train_step`` step of ``model`` (a detector) from ``state``
    on ``batch`` with the uniforms ``draws`` -> log values, the gradients the
    optimizer was handed, the parameters and buffers after the step."""
    from oadg_tpu_torch.engine import build_optimizer, make_train_step
    from oadg_tpu_torch.engine import train_step as train_step_mod
    from oadg_tpu_torch.utils.draws import UniformDraws
    model.load_state_dict(state, strict=True)
    opt = build_optimizer(model, optimizer_cfg, grad_clip=grad_clip)
    grads = {}
    real_step = opt.step

    def step_and_record(*a, **k):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return real_step(*a, **k)

    opt.step = step_and_record
    real_draws = train_step_mod.UniformDraws
    train_step_mod.UniformDraws = lambda generator: UniformDraws(given=draws)
    try:
        step = make_train_step(model, opt, lambda t: lr)
        log = step(batch, torch.Generator())
    finally:
        train_step_mod.UniformDraws = real_draws
    return dict(log={k: float(v) for k, v in log.items()}, grads=grads,
                state={k: v.detach().clone() for k, v in model.state_dict().items()})


def task_flagship(job, rank, world):
    from oadg_tpu_torch.apis import init_detector
    j = job["flagship"]
    model = init_detector({"model": j["model"]}, device="cpu", num_views=2).model
    return run_step(model, j["state"], local_batch(j["batch"], j["images"], 2, rank, world),
                    local_draws(j["draws"], j["images"], 2, rank, world),
                    j["optimizer"], j["grad_clip"])


def task_yolo(job, rank, world):
    from oadg_tpu_torch.apis import init_detector
    j = job["yolo"]
    model = init_detector({"model": j["model"]}, device="cpu", num_views=2).model
    return run_step(model, j["state"], local_batch(j["batch"], j["images"], 2, rank, world),
                    local_draws(j["draws"], j["images"], 2, rank, world),
                    j["optimizer"], j["grad_clip"])


def sup_rows(layout, splits, rank):
    """Rank ``rank``'s rows of the global ``supcontrast`` rows (layout
    ``(R, V, P)``) when rank k holds ``splits[k] = (r_k, p_k)`` roi and
    random rows a view."""
    big_r, v, big_p = layout
    r, p = splits[rank]
    r0 = sum(s[0] for s in splits[:rank])
    p0 = sum(s[1] for s in splits[:rank])
    return ([vi * big_r + r0 + i for vi in range(v) for i in range(r)]
            + [big_r * v + vi * big_p + p0 + i for vi in range(v) for i in range(p)])


def task_supcontrast(job, rank, world):
    """``supcontrast`` of this rank's rows of the global rows, for each of
    the job's splits of them over the ranks: its value and the gradient of
    the global loss by its rows; and, outside ``sharded_batch()``, the
    value on the first split's rows alone."""
    from oadg_tpu_torch.models.losses import supcontrast
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["supcontrast"]
    v = j["layout"][1]
    out = dict(splits=[])
    for splits in j["splits"]:
        rows = sup_rows(j["layout"], splits, rank)
        feats = j["feats"][rows].clone().requires_grad_(True)
        r, p = splits[rank]
        with sharded_batch():
            loss = supcontrast(feats, j["labels"][rows], j["valid"][rows], (r, v, p),
                               temper=0.06, min_samples=j["min_samples"])
        loss.backward()
        out["splits"].append(dict(loss=float(loss), grad=feats.grad, rows=rows))
    rows = sup_rows(j["layout"], j["splits"][0], rank)
    r, p = j["splits"][0][rank]
    out["unsharded"] = float(supcontrast(j["feats"][rows], j["labels"][rows],
                                         j["valid"][rows], (r, v, p), temper=0.06,
                                         min_samples=j["min_samples"]))
    return out


def task_mask_loss(job, rank, world):
    """``FCNMaskHead.loss`` on this rank's rows: its share and its rows'
    gradient."""
    from oadg_tpu_torch.models.roi_heads.mask_heads import FCNMaskHead
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["mask_loss"]
    n = j["pred"].shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)
    head = FCNMaskHead(num_convs=0, in_channels=4, conv_out_channels=4,
                       num_classes=j["pred"].shape[1], device="cpu")
    pred = j["pred"][sl].clone().requires_grad_(True)
    with sharded_batch():
        loss = head.loss(pred, j["targets"][sl], j["labels"][sl], j["pos"][sl])
    loss.backward()
    return dict(loss=float(loss), grad=pred.grad)


def task_bbox_loss(job, rank, world):
    """``Shared2FCBBoxHead.loss`` on this rank's rows (``job['bbox_loss']
    ['bounds']``: the ranks hold different numbers of rows): its shares and
    its rows' gradients."""
    from oadg_tpu_torch.models.roi_heads.bbox_heads import Shared2FCBBoxHead
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["bbox_loss"]
    sl = slice(*j["bounds"][rank])
    head = Shared2FCBBoxHead(in_channels=1, fc_out_channels=4, roi_feat_size=1,
                             num_classes=j["cls"].shape[1] - 1, device="cpu")
    cls = j["cls"][sl].clone().requires_grad_(True)
    reg = j["reg"][sl].clone().requires_grad_(True)
    with sharded_batch():
        losses = head.loss(cls, reg, j["labels"][sl], j["label_w"][sl], j["targets"][sl],
                           j["bbox_w"][sl])
    (losses["loss_cls"] + losses["loss_bbox"]).backward()
    return dict(losses={k: float(v) for k, v in losses.items()}, cls=cls.grad, reg=reg.grad)


def retina_head():
    """A RetinaNet head of 3 classes on 2 levels (strides 8 and 16), one
    anchor a cell: what ``task_retina_loss`` and its test build."""
    from oadg_tpu_torch.models.dense_heads.retina_head import RetinaHead
    return RetinaHead(num_classes=3, in_channels=4, feat_channels=4, stacked_convs=1,
                      anchor_generator=dict(type="AnchorGenerator", octave_base_scale=4,
                                            scales_per_octave=1, ratios=[1.0],
                                            strides=[8, 16]), device="cpu")


def task_retina_loss(job, rank, world):
    """``RetinaHead.loss`` on this rank's image inside ``sharded_batch()``:
    its shares and its maps' gradients."""
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["retina_loss"]
    sl = slice(rank, rank + 1)
    cls = [c[sl].clone().requires_grad_(True) for c in j["cls"]]
    reg = [r[sl].clone().requires_grad_(True) for r in j["reg"]]
    with sharded_batch():
        losses = retina_head().loss((cls, reg), j["gt"][sl], j["gt_valid"][sl],
                                    j["gt_labels"][sl])
    sum(losses.values()).backward()
    return dict(losses={k: float(v) for k, v in losses.items()},
                cls=[c.grad for c in cls], reg=[r.grad for r in reg])


class NeckHead(torch.nn.Module):
    """A neck and a dense head as one head: ``forward`` is the head's on the
    neck's maps, ``loss`` the head's."""

    def __init__(self, neck, head):
        super().__init__()
        self.neck, self.head = neck, head

    def init_weights(self, gen):
        self.head.init_weights(gen)

    def forward(self, feats):
        return self.head(self.neck(feats))

    def loss(self, *args, **kw):
        return self.head.loss(*args, **kw)


def dense_head(spec):
    """A dense head of ``spec`` (a ``dense_loss`` entry: its config, views
    and seeded state (None: as built); with a ``neck`` config, a
    ``NeckHead``) on the CPU."""
    from oadg_tpu_torch.models import dense_heads, necks  # noqa: F401  (registers them)
    from oadg_tpu_torch.utils.registry import HEADS, NECKS, build_from_cfg
    head = build_from_cfg(dict(spec["cfg"], num_views=spec["views"]), HEADS, dict(device="cpu"))
    if spec.get("neck"):
        head = NeckHead(build_from_cfg(dict(spec["neck"]), NECKS, dict(device="cpu")), head)
    if spec["state"] is not None:
        head.load_state_dict(spec["state"], strict=True)
    return head


def task_dense_loss(job, rank, world):
    """Each of ``job['dense_loss']``'s heads' ``loss`` on this rank's images
    (every view) inside ``sharded_batch()``: its shares and its inputs'
    gradients: the maps' (``cls`` / ``reg`` given), or the features' (``feats``
    given: the head's forward runs inside too, its live BNs' statistics
    the global batch's; LD's ``soft`` teacher logits handed on, and the
    DETR heads' ``img_shapes``)."""
    from oadg_tpu_torch.parallel import sharded_batch
    out = {}
    for name, j in job["dense_loss"].items():
        rows = rank_rows(j["images"], j["views"], rank, world)
        gts = (j["gt"][rows], j["gt_valid"][rows], j["gt_labels"][rows])
        if "feats" in j:
            feats = [f[rows].clone().requires_grad_(True) for f in j["feats"]]
            extra = {"soft_targets": [s[rows] for s in j["soft"]]} if "soft" in j else {}
            if "masks" in j:
                extra["gt_masks"] = j["masks"][rows]
            if "img_shapes" in j:
                extra["img_shapes"] = j["img_shapes"][rows]
            with sharded_batch():
                head = dense_head(j)
                losses = head.loss(head(feats), *gts, **extra)
            sum(losses.values()).backward()
            out[name] = dict(losses={k: float(v) for k, v in losses.items()}, rows=rows,
                             feats=[f.grad for f in feats])
            continue
        cls = [c[rows].clone().requires_grad_(True) for c in j["cls"]]
        reg = [r[rows].clone().requires_grad_(True) for r in j["reg"]]
        with sharded_batch():
            losses = dense_head(j).loss((cls, reg), *gts)
        sum(losses.values()).backward()
        out[name] = dict(losses={k: float(v) for k, v in losses.items()}, rows=rows,
                         cls=[c.grad for c in cls], reg=[r.grad for r in reg])
    return out


def pisa_roi_head(j):
    """``job['pisa_roi']``'s PISA RoI head (its views, seeded state)."""
    from oadg_tpu_torch.models import roi_heads  # noqa: F401  (registers the heads)
    from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg
    m = j["model"]
    head = build_from_cfg(dict(m["roi_head"], train_cfg=m["train_cfg"]["rcnn"],
                               test_cfg=m["test_cfg"]["rcnn"], num_views=j["views"]), HEADS,
                          dict(device="cpu"))
    head.load_state_dict(j["state"], strict=True)
    return head


def pisa_roi_loss(j, rows, images):
    """The PISA RoI head's losses on ``rows`` of the views-major inputs,
    with the draws of ``images``; -> (losses, the maps that require grad,
    the head)."""
    from oadg_tpu_torch.utils.draws import UniformDraws
    head = pisa_roi_head(j)
    feats = [f[rows].clone().requires_grad_(True) for f in j["feats"]]
    losses = head.loss(feats, j["props"][rows], j["prop_valid"][rows], j["gt"][rows],
                       j["gt_valid"][rows], j["labels"][rows],
                       UniformDraws(given={k: u[images] for k, u in j["draws"].items()}))
    return losses, feats, head


def task_pisa_roi(job, rank, world):
    """``PISARoIHead.loss`` on this rank's image (both views) inside
    ``sharded_batch()``: its shares, its maps' and its parameters'
    gradients."""
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["pisa_roi"]
    with sharded_batch():
        losses, feats, head = pisa_roi_loss(j, rank_rows(j["images"], j["views"], rank, world),
                                            image_rows(j["images"], rank, world))
    sum(v for k, v in losses.items() if "loss" in k).backward()
    return dict(losses={k: float(v) for k, v in losses.items()}, feats=[f.grad for f in feats],
                params={k: p.grad for k, p in head.named_parameters() if p.grad is not None})


def task_bn(job, rank, world):
    """Live ``BatchNorm`` on this rank's input (the ranks' shapes differ),
    inside ``sharded_batch()``: the output, the input's gradient of
    ``(y * coef).sum()`` and the stored statistics after it; and outside
    it, under the same group, the stored statistics of a fresh BN."""
    from oadg_tpu_torch.models.layers import BatchNorm
    from oadg_tpu_torch.parallel import sharded_batch
    j = job["bn"]
    x = j["x"][rank].clone().requires_grad_(True)
    bn = BatchNorm(x.shape[1]).train()
    with sharded_batch():
        y = bn(x)
    (y * j["coef"][rank]).sum().backward()
    local = BatchNorm(x.shape[1]).train()
    local(j["x"][rank])
    return dict(y=y.detach(), grad=x.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone(), local_mean=local.running_mean.clone(),
                local_var=local.running_var.clone())


def task_yolo_local_bn(job, rank, world):
    """The control of the YOLOv3 step: the same 2-rank step with live BN's
    sums left unreduced (per-rank statistics, as a DDP wrap without SyncBN
    computes them)."""
    from oadg_tpu_torch.models import layers
    real = layers.all_reduce_sum_grad
    layers.all_reduce_sum_grad = lambda t: t
    try:
        return task_yolo(job, rank, world)
    finally:
        layers.all_reduce_sum_grad = real


def task_collect(job, rank, world):
    """``multi_gpu_test`` over a loader of ``job['collect']['n']`` images,
    one a batch (as ``build_test_loader``'s), with a test step whose detections encode each image's
    index; and ``collect_results_allgather`` of given results."""
    from oadg_tpu_torch.apis.test import collect_results_allgather, multi_gpu_test
    from oadg_tpu_torch.data import build_dataloader
    j = job["collect"]
    loader = build_dataloader(IndexDataset(j["n"]), samples_per_gpu=1, workers_per_gpu=1,
                              shuffle=False)
    state = dict(test_fn=fake_test_fn, num_classes=3)
    merged = multi_gpu_test(state, loader)
    mine = [fake_result(i) for i in j["indices"][rank]]
    gathered = collect_results_allgather(mine, j["indices"][rank], j["n"], 3)
    return dict(merged=merged, gathered=gathered, len=len(loader),
                result_indices=loader.result_indices())


def task_syncnorm(job, rank, world):
    """``SyncNormHook.after_train_epoch`` on a model whose live BN holds
    rank-dependent stored statistics -> the statistics after it."""
    from types import SimpleNamespace

    from oadg_tpu_torch.core.hook import SyncNormHook
    from oadg_tpu_torch.models.layers import BatchNorm
    model = torch.nn.Sequential(BatchNorm(3), BatchNorm(2))
    with torch.no_grad():
        for i, m in enumerate(model):
            m.running_mean.copy_(torch.arange(m.running_mean.numel()) + 10.0 * rank + i)
            m.running_var.fill_(1.0 + rank)
    SyncNormHook().after_train_epoch(SimpleNamespace(model=model))
    return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}


def _tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_tool",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def task_tools(job, rank, world):
    """``tools/torch_train.py --launcher pytorch`` on the job's config (in
    this process, on the group it joined), then ``tools/torch_test.py
    --launcher pytorch`` on the last checkpoint with ``--out`` and
    ``tools/torch_test_robustness.py --launcher pytorch`` on it (one
    corruption, severities 0 and 1)."""
    j = job["tools"]
    runner = _tool("torch_train").main([j["config"], "--launcher", "pytorch", "--device", "cpu",
                                        "--work-dir", j["work_dir"], "--seed", "0"])
    ckpt = os.path.join(j["work_dir"], f"epoch_{runner.max_epochs}.pth")
    metrics = _tool("torch_test").main([j["config"], ckpt, "--launcher", "pytorch",
                                        "--device", "cpu", "--eval", "bbox",
                                        "--out", j["out"]])
    robust = _tool("torch_test_robustness").main(
        [j["config"], ckpt, "--launcher", "pytorch", "--device", "cpu", "--corruptions",
         "gaussian_noise", "--severities", "0", "1", "--out", j["robust_out"]])
    return dict(iters=runner.iter, val=runner.last_val_results, metrics=metrics,
                loader_len=len(runner.loader), saved=os.path.exists(ckpt), robust=robust)


TASKS = dict(flagship=task_flagship, yolo=task_yolo, yolo_local_bn=task_yolo_local_bn,
             supcontrast=task_supcontrast, mask_loss=task_mask_loss,
             bbox_loss=task_bbox_loss, retina_loss=task_retina_loss,
             dense_loss=task_dense_loss, pisa_roi=task_pisa_roi, bn=task_bn,
             collect=task_collect, tools=task_tools,
             syncnorm=task_syncnorm)


class IndexDataset:
    """``n`` 8x8 test samples, each marked by its index in ``img_shape``'s
    width (8 + i), so a test step can read which image it got."""

    def __init__(self, n):
        self.n = n
        self.flag = np.zeros(n, np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"img": np.zeros((8, 8, 3), np.float32),
                "img_metas": dict(img_shape=(8, 8 + i, 3), scale_factor=[1, 1, 1, 1])}


def fake_result(i, num_classes=3):
    """Per-class (k, 5) float32 detections keyed by the image index (the
    JAX package's ``tests/test_dist_eval.py:_fake_result``)."""
    out = []
    for c in range(num_classes):
        k = (i + c) % 3
        out.append(np.zeros((0, 5), np.float32) if k == 0 else
                   np.arange(k * 5, dtype=np.float32).reshape(k, 5) + i * 100 + c)
    return out


def fake_test_fn(batch):
    """A test step whose (N, K, 5) detections are ``fake_result`` of each
    image's index (read from ``img_shape``)."""
    ids = [int(w) - 8 for w in batch["img_shape"][:, 1]]
    k = 4
    dets = torch.zeros(len(ids), k, 5)
    labels = torch.zeros(len(ids), k, dtype=torch.long)
    valid = torch.zeros(len(ids), k, dtype=torch.bool)
    for n, i in enumerate(ids):
        j = 0
        for c, arr in enumerate(fake_result(i)):
            for row in arr:
                dets[n, j] = torch.from_numpy(row)
                labels[n, j] = c
                valid[n, j] = True
                j += 1
    return dets, labels, valid


def main(launcher, job_path):
    import torch.distributed as dist

    from oadg_tpu_torch.parallel import init_distributed
    torch.set_num_threads(2)
    rank, world = init_distributed(launcher, device="cpu")
    try:
        job = torch.load(job_path, weights_only=False)
        out = {name: TASKS[name](job, rank, world) for name in job["tasks"]}
        out["group"] = dict(rank=rank, world=world, backend=dist.get_backend())
        torch.save(out, f"{job_path}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
