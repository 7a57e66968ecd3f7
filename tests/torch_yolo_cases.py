"""Shared inputs of the YOLOv3 tests (``test_torch_yolo.py`` on the CPU,
``test_torch_cuda.py`` on the card): the tiny OA-DG YOLOv3 detector (full
Darknet-53, the neck and head narrowed as ``tests/test_yolo_cont.py``'s
``HEAD_CFG``), seeded batches, a tiny training config on disk, and the JAX
side's variables and training forward with a fixed sampling key. JAX is
imported only by the functions that run it, so the card tests, where there
is no JAX, use the rest."""
import copy

import numpy as np
import pytest
import torch

YOLO_OADG = "configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py"
YOLO_BASE = "configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e.py"
NC = 8
KEY_SEED = 21
ANCHORS = dict(type="YOLOAnchorGenerator",
               base_sizes=[[(116, 90), (156, 198), (373, 326)],
                           [(30, 61), (62, 45), (59, 119)],
                           [(10, 13), (16, 30), (33, 23)]],
               strides=[32, 16, 8])
HEAD_CFG = dict(num_classes=NC, in_channels=[32, 24, 16], out_channels=[36, 28, 20],
                anchor_generator=ANCHORS, bbox_coder=dict(type="YOLOBBoxCoder"),
                featmap_strides=[32, 16, 8])
CONT_KW = dict(jsd_conf_weight=20.0, jsd_cls_weight=5.0,
               cont_cfg=dict(loss_weight=1.0, dim=32, temperature=0.06),
               max_cont_anchors=64)
LOSS_KEYS = ["loss_cls", "loss_conf", "loss_xy", "loss_wh", "loss_csconf",
             "loss_cscls", "loss_cont"]


def model_cfg(cont=True):
    """The YOLOv3 config's model with the neck and head narrowed (full
    Darknet-53, no pretrained init)."""
    from oadg_tpu_torch.config import load_config
    m = copy.deepcopy(dict(load_config(YOLO_OADG if cont else YOLO_BASE)["model"]))
    m["backbone"] = dict(m["backbone"], init_cfg=None)
    m["neck"] = dict(m["neck"], out_channels=[32, 24, 16])
    m["bbox_head"] = dict(m["bbox_head"], **HEAD_CFG, **(CONT_KW if cont else {}))
    return m


def gts(rng, n, g, h, w, pad=1):
    """(n, g) seeded boxes inside h x w, labels and validity (the last
    ``pad`` of the second image invalid)."""
    x1 = rng.uniform(0, w * 0.6, (n, g))
    y1 = rng.uniform(0, h * 0.6, (n, g))
    bw = rng.uniform(w * 0.1, w * 0.5, (n, g))
    bh = rng.uniform(h * 0.1, h * 0.5, (n, g))
    gt = np.stack([x1, y1, np.minimum(x1 + bw, w), np.minimum(y1 + bh, h)], -1)
    valid = np.ones((n, g), bool)
    if n > 1 and pad:
        valid[1, -pad:] = False
        gt[1, -pad:] = 0
    return (gt.astype(np.float32), rng.randint(0, NC, (n, g)).astype(np.int32), valid)


def views_batch(seed=0, b=2, v=2, h=64, w=64, g=5):
    """A views-major batch: view 2 is view 1 plus noise; gts tiled."""
    rng = np.random.RandomState(seed)
    img = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    imgs = [img] + [img + rng.normal(0, 0.3, img.shape).astype(np.float32)
                    for _ in range(v - 1)]
    gt, lbl, valid = gts(rng, b, g, h, w)
    return {"img": np.concatenate(imgs),
            "gt_bboxes": np.tile(gt, (v, 1, 1)), "gt_labels": np.tile(lbl, (v, 1)),
            "gt_valid": np.tile(valid, (v, 1)),
            "img_shape": np.array([[h, w]] * (b * v), np.float32)}


def tiny_train_cfg(root, **options):
    """The OA-DG YOLOv3 config at a tiny size for training: ``model_cfg()``,
    the 4 PNGs of ``torch_data_cases.TRAIN_SIZES`` under ``root`` as its
    train, val and test sets, the config's train pipeline with ``Resize``
    over (64, 64) .. (96, 96) (canvas 96x96), the test scale (96, 96),
    batches of 2 from one loader thread, 16 gts a batch row, 2 epochs logged
    every iteration, a 3-iteration warmup; ``options`` are merged last."""
    import torch_data_cases
    from oadg_tpu_torch.config import load_config
    ann_file, img_prefix = torch_data_cases.write_dataset(
        str(root), sizes=torch_data_cases.TRAIN_SIZES)
    cfg = load_config(YOLO_OADG)
    cfg["model"] = model_cfg()
    opts = {"data.samples_per_gpu": 2, "data.workers_per_gpu": 1,
            "data.train.ann_file": ann_file, "data.train.img_prefix": img_prefix,
            "data.train.pipeline.4.img_scale": [(64, 64), (96, 96)],
            "max_gt": 16, "runner.max_epochs": 2, "log_config.interval": 1,
            "lr_config.warmup_iters": 3}
    for split in ("val", "test"):
        opts.update({f"data.{split}.ann_file": ann_file, f"data.{split}.img_prefix": img_prefix,
                     f"data.{split}.pipeline.1.img_scale": (96, 96)})
    opts.update(options)
    cfg.merge_from_dict(opts)
    return cfg


def randomize(variables, seed=3):
    """Random BN affines and stored statistics everywhere, and prediction
    convs of std 0.3, so that objectness and class scores are far apart."""
    import jax
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(params, stats):
        for k, sub in params.items():
            if k.startswith("FrozenBN"):
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif k.startswith("conv_pred"):
                sub["Conv_0"]["kernel"] = rng.normal(
                    0, 0.3, sub["Conv_0"]["kernel"].shape).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, stats.get(k, {}))

    walk(v["params"], v["batch_stats"])
    return v


def jax_detector(model, num_views, dtype=None):
    from oadg_tpu.models import build_detector as jax_build_detector
    kw = {} if dtype is None else dict(dtype=dtype)
    return jax_build_detector(model, num_views=num_views, **kw)


def jax_variables(det, batch):
    import jax
    import jax.numpy as jnp
    jb = {"img": jnp.asarray(batch["img"]), "img_shape": jnp.asarray(batch["img_shape"])}
    return randomize(jax.jit(lambda r, b: det.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, jb))


def jax_train(det, variables, batch):
    """The JAX ``forward_train`` with ``make_rng`` returning ``KEY`` ->
    (losses, gradients, new batch_stats) as numpy trees."""
    import jax
    import jax.numpy as jnp
    from oadg_tpu.models.detectors.single_stage import SingleStageDetector as JaxSingleStage
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        losses, new = det.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jb, "train", mutable=["batch_stats"])
        return sum(v for k, v in losses.items() if "loss" in k), (losses, new["batch_stats"])

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxSingleStage, "make_rng", lambda self, name: jax.random.PRNGKey(KEY_SEED))
    try:
        (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    finally:
        mp.undo()
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)      # noqa: E731
    return as_np(losses), as_np(grads), as_np(stats)


def cont_draws(b, num_priors):
    """The uniforms the JAX head draws from the sampling key for its cont
    rows."""
    import jax
    return {"cont": torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(KEY_SEED), (b, num_priors))))}


def torch_batch(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["img"] = t["img"].permute(0, 3, 1, 2).contiguous()
    return t


def to_np(t):
    return t.detach().float().numpy()


def nhwc(t):
    return to_np(t).transpose(0, 2, 3, 1)


def port_state(jax_vars, scope, prefix):
    """The port's state dict of the JAX module under ``scope`` (a detector
    scope name: ``backbone_m``, ``neck_m``, ``head``), keys without
    ``prefix``."""
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    sd = jax_variables_to_state_dict(
        {c: {scope: jax_vars[c]} for c in ("params", "batch_stats") if c in jax_vars})
    return {k[len(prefix):]: v for k, v in sd.items()}


def close(got, want, rtol, floor):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max())
