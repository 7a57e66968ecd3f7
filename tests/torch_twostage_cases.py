"""Shared cases of the two-stage family's parity tests
(``test_torch_cascade.py``, ``test_torch_htc_scnet.py``,
``test_torch_roi_variants.py``): the seven configs made tiny, seeded FPN
maps, gts and proposals, the JAX RoI heads built alone (their losses and
gradients jitted once), the uniforms that the JAX samplers draw from their
keys, and the port's RoI heads loaded with the JAX weights."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "cascade": "configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py",
    "htc": "configs/htc/htc_r50_fpn_1x_coco.py",
    "scnet": "configs/scnet/scnet_r50_fpn_1x_coco.py",
    "dynamic": "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py",
    "double_head": "configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py",
    "ms_rcnn": "configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py",
    "pisa": "configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py",
}
C = 16                      # FPN and RoI channels
N, G, P = 2, 4, 40          # images, gts (one padded in image 1), proposals an image
H = W = 64                  # image size; FPN levels 16, 8, 4, 2, 1 cells a side
NUM_CLASSES = 8
SAMPLES = 32                # the rcnn samplers' num (8 positive slots an image)
MASK_ROI_14 = dict(type="SingleRoIExtractor",
                   roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
                   out_channels=C, featmap_strides=[4, 8, 16, 32])


def load_model(name, package):
    """The config's ``model`` through ``package``'s loader ("jax" or
    "torch")."""
    path = os.path.join(ROOT, CONFIGS[name])
    if package == "jax":
        from oadg_tpu.config import Config
        return Config.fromfile(path, import_custom_modules=False)["model"]
    from oadg_tpu_torch.config import load_config
    return load_config(path)["model"]


def tiny_roi(model):
    """The model's RoI head, train and test configs made tiny in place: 16
    channels, FCs of 32, 8 classes, mask heads of 2 convs, a semantic head
    of 2 convs and 5 classes, samplers of ``SAMPLES``, 20 detections."""
    rh = model["roi_head"]
    rh["bbox_roi_extractor"]["out_channels"] = C
    heads = rh["bbox_head"]
    for h in heads if isinstance(heads, list) else [heads]:
        h.update(in_channels=C, fc_out_channels=32, num_classes=NUM_CLASSES)
        if "conv_out_channels" in h:
            h["conv_out_channels"] = 32
    if rh.get("mask_roi_extractor"):
        rh["mask_roi_extractor"]["out_channels"] = C
    for key, extra in (("mask_head", dict(num_convs=2, num_classes=NUM_CLASSES)),
                       ("semantic_head", dict(num_convs=2, num_classes=5)),
                       ("glbctx_head", dict(num_classes=NUM_CLASSES)),
                       ("mask_iou_head", dict(fc_out_channels=32, num_classes=NUM_CLASSES))):
        if rh.get(key):
            rh[key].update(in_channels=C, conv_out_channels=C, **extra)
    rcnn = model["train_cfg"]["rcnn"]
    for tc in rcnn if isinstance(rcnn, list) else [rcnn]:
        tc["sampler"]["num"] = SAMPLES
    model["test_cfg"]["rcnn"]["max_per_img"] = 20
    return model


def tiny_model(model):
    """``tiny_roi`` and an R18-FPN of 16 channels with a small RPN budget:
    the whole detector made tiny."""
    tiny_roi(model)
    model["backbone"].update(depth=18, base_channels=16, stem_channels=16, init_cfg=None)
    model["neck"].update(in_channels=[16, 32, 64, 128], out_channels=C)
    model["rpn_head"].update(in_channels=C, feat_channels=C)
    model["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                              nms=dict(iou_threshold=0.7), min_bbox_size=0)
    model["train_cfg"]["rpn"]["sampler"]["num"] = 32
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    return model


def inputs(seed=0):
    """Seeded numpy inputs of a RoI head: FPN maps NHWC (5 levels), gts,
    labels, validity, proposals (half of them jittered gts) and their
    validity (3 padded an image), box-cropped gt masks (N, G, 28, 28) and a
    (N, H, W) label map with some 255 pixels."""
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (N, H >> (2 + i), W >> (2 + i), C)).astype(np.float32)
             for i in range(5)]
    xy = rng.uniform(0, 36, (N, G, 2))
    wh = rng.uniform(12, 28, (N, G, 2))
    gt = np.concatenate([xy, np.minimum(xy + wh, 63.0)], -1).astype(np.float32)
    gt_valid = np.ones((N, G), bool)
    gt_valid[1, -1] = False
    gt[1, -1] = 0
    labels = rng.randint(0, NUM_CLASSES, (N, G)).astype(np.int32)
    k = rng.randint(0, G - 1, (N, P // 2))
    base = np.take_along_axis(gt, k[..., None].repeat(4, -1), 1)
    size = np.concatenate([base[..., 2:] - base[..., :2]] * 2, -1)
    spread = rng.uniform(0.02, 0.3, (N, P // 2, 1))        # IoUs from ~0.4 to ~0.95
    near = base + rng.uniform(-1, 1, (N, P // 2, 4)) * spread * size
    rxy = rng.uniform(0, 48, (N, P - P // 2, 2))
    rwh = rng.uniform(6, 30, (N, P - P // 2, 2))
    far = np.concatenate([rxy, np.minimum(rxy + rwh, 64.0)], -1)
    props = np.clip(np.concatenate([near, far], 1), 0, 64).astype(np.float32)
    prop_valid = np.ones((N, P), bool)
    prop_valid[:, -3:] = False
    yy, xx = (np.mgrid[0:28, 0:28] + 0.5) / 28
    c = rng.uniform(0.35, 0.65, (N, G, 2, 1, 1))
    r = rng.uniform(0.25, 0.5, (N, G, 2, 1, 1))
    masks = ((((xx - c[:, :, 0]) / r[:, :, 0]) ** 2 + ((yy - c[:, :, 1]) / r[:, :, 1]) ** 2)
             <= 1).astype(np.float32)
    seg = rng.randint(0, 5, (N, H, W)).astype(np.int32)
    seg[:, :6] = 255
    return dict(feats=feats, gt=gt, gt_valid=gt_valid, labels=labels, props=props,
                prop_valid=prop_valid, masks=masks, seg=seg)


def jax_head(model):
    """The JAX RoI head of ``model`` built alone, as the JAX detector builds
    it (``two_stage.py:86-100``)."""
    from oadg_tpu.utils.registry import HEADS, build_from_cfg
    import oadg_tpu.models  # noqa: F401  (registers the heads)
    roi = dict(model["roi_head"])
    return build_from_cfg(dict(roi, type=roi.pop("type"), train_cfg=model["train_cfg"]["rcnn"],
                               test_cfg=model["test_cfg"]["rcnn"], num_views=1), HEADS)


def port_head(model):
    """The port's RoI head of ``model`` on the CPU."""
    from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg
    import oadg_tpu_torch.models  # noqa: F401  (registers the heads)
    return build_from_cfg(dict(model["roi_head"], train_cfg=model["train_cfg"]["rcnn"],
                               test_cfg=model["test_cfg"]["rcnn"], num_views=1), HEADS,
                          dict(device="cpu"))


def randomize(params, seed=1):
    """Seeded nonzero values for every JAX leaf (biases too), scaled as
    LeCun-normal by fan-in, so that every weight and gradient is checked."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        fan_in = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 16
        return jnp.asarray(rng.normal(0, 1 / np.sqrt(fan_in), x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, params)


def port_state(params):
    """JAX head params -> the port head's state dict (``roi_head.`` dropped)."""
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    sd = jax_variables_to_state_dict(
        {"params": {"roi": jax.tree_util.tree_map(np.asarray, params)}}, roi_channels=C)
    return {k[len("roi_head."):]: v for k, v in sd.items()}


def pair_draws(key, n, size):
    """The uniforms ``RandomSampler.sample`` draws from ``key`` split over
    ``n`` images: (pos (n, size), neg (n, size)), as torch tensors."""
    pos, neg = [], []
    for k in jax.random.split(key, n):
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kp, (size,))))
        neg.append(np.asarray(jax.random.uniform(kn, (size,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def cascade_draws(rng, stages=3, mask=False):
    """The cascade's draws ``rcnn.s{k}.pos`` / ``.neg`` from ``rng`` split
    over the stages (``cascade_roi_head.py:114-120``); with ``mask`` HTC's
    ``rcnn.mask{k}.*`` from ``fold_in(rng, 7)`` (``htc_scnet_heads.py:183``).
    Stage 0 samples G + P candidates, later stages G + SAMPLES."""
    out = {}
    groups = [("s", rng)] + ([("mask", jax.random.fold_in(rng, 7))] if mask else [])
    for tag, key in groups:
        for k, sk in enumerate(jax.random.split(key, stages)):
            size = G + (P if k == 0 and tag == "s" else SAMPLES)
            out[f"rcnn.{tag}{k}.pos"], out[f"rcnn.{tag}{k}.neg"] = pair_draws(sk, N, size)
    return out


def standard_draws(rng, b=N):
    """``StandardRoIHead``'s ``rcnn.pos`` / ``rcnn.neg`` from ``rng``."""
    pos, neg = pair_draws(rng, b, G + P)
    return {"rcnn.pos": pos, "rcnn.neg": neg}


def to_torch(case):
    """The numpy inputs as the port takes them (maps NCHW, requiring grad)."""
    feats = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
             for f in case["feats"]]
    t = {k: torch.from_numpy(v) for k, v in case.items() if k != "feats"}
    t["labels"] = t["labels"].long()
    return feats, t


def close_grads(got, want, rtol=0.0, rel=1e-4, err_msg=""):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel * max(np.abs(want).max(), 1e-12), err_msg=err_msg)
