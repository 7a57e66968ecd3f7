"""Shared fixtures of the one-stage family's CPU parity tests
(``tests/test_torch_onestage_heads.py``, ``tests/test_torch_onestage_parts.py``,
``tests/test_torch_onestage_heads2.py``, ``tests/test_torch_onestage_parts2.py``,
``tests/test_torch_onestage_heads3.py``, ``tests/test_torch_onestage_parts3.py``,
``tests/test_torch_onestage_heads4.py``, ``tests/test_torch_onestage_parts4.py``,
``tests/test_torch_onestage_heads5.py``, ``tests/test_torch_onestage_parts5.py``).

``tiny_model(name)``: the published config of each of the twenty one-stage
configs (``FIRST``: the family's first seven; ``SECOND``: FoveaBox, FSAF,
FreeAnchor, PISA-RetinaNet and LD; ``THIRD``: GA-RetinaNet, SABL-RetinaNet,
NAS-FPN and NAS-FCOS; ``FOURTH``: RepPoints, CenterNet, CornerNet and
CentripetalNet; ``FIFTH``: YOLOF, YOLOX-S, SSD300, SOLO and YOLACT) with its
backbone cut to ResNet-18 and
its neck and head to 16 channels (the R18-FPN-16 of
``tests/test_p2_zoo.py``), 8 classes; its losses, assigners, anchors and
test settings kept; LD's teacher narrowed the same way; NAS-FPN's neck at
two stacks, NAS-FCOS's neck at ``start_level=1`` (the port refuses the
config's 0, ROADMAP C). CenterNet keeps its R18 (no neck; the head takes
its 128 channels to 16); CornerNet and CentripetalNet take the narrowed
Hourglass of ``tests/test_p2_backbones_necks.py:66-74`` (``HOURGLASS``: two
levels of 8 and 16 channels, one block each, 8 output channels), which
both share. ``FIFTH``: YOLOF on R18's C5 (512 channels) with its
DilatedEncoder at 16 channels (8 in its blocks) on ``YOLOF_HW`` (128x192,
a 4x6 map); YOLOX-S's CSPDarknet at ``widen_factor`` 0.125 (8 to 128
channels, the depths as published) and its PAFPN and head at 16; SSD300
whole (no width knob) at 300x300, one image; SOLO with two GN convs a tower
and the grids ``(12, 9, 8, 6, 4)`` of ``tests/test_p2_zoo.py:98-103``
(each below P2's 16x24, so that the category resize shrinks every level);
YOLACT with 8 prototypes. The NAS necks max-pool their top levels: their
batches are ``NAS_HW`` (128x192), where P7 is 1x2. ``randomize`` fills
a JAX variable tree (from ``jax.eval_shape``) with seeded numpy weights
(LeCun-normal kernels, small biases, GN and the per-level scales near 1,
random frozen-BN statistics) that the port loads through
``jax_variables_to_state_dict``. ``jax_backbone`` and ``jax_head_run``
are the JAX side of the heads' tests: the R18-FPN's features once per
backbone and neck variant, and a head's forward, loss, gradients and
``get_bboxes`` in one jit.
"""
import os.path as osp

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = {
    "fcos": "configs/fcos/fcos_r50_fpn_1x_coco.py",
    "atss": "configs/atss/atss_r50_fpn_1x_coco.py",
    "gfl": "configs/gfl/gfl_r50_fpn_1x_coco.py",
    "vfnet": "configs/vfnet/vfnet_r50_fpn_1x_coco.py",
    "tood": "configs/tood/tood_r50_fpn_1x_coco.py",
    "paa": "configs/paa/paa_r50_fpn_1x_coco.py",
    "autoassign": "configs/autoassign/autoassign_r50_fpn_8x2_1x_coco.py",
    "fovea": "configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py",
    "fsaf": "configs/fsaf/fsaf_r50_fpn_1x_coco.py",
    "free_anchor": "configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py",
    "pisa_retina": "configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py",
    "ld": "configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py",
    "ga_retina": "configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py",
    "sabl_retina": "configs/sabl/sabl_retinanet_r50_fpn_1x_coco.py",
    "nas_fpn": "configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py",
    "nas_fcos": "configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py",
    "reppoints": "configs/reppoints/reppoints_moment_r50_fpn_1x_coco.py",
    "centernet": "configs/centernet/centernet_resnet18_140e_coco.py",
    "cornernet": "configs/cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py",
    "centripetalnet":
        "configs/centripetalnet/centripetalnet_hourglass104_mstest_16x6_210e_coco.py",
    "yolof": "configs/yolof/yolof_r50_c5_8x8_1x_coco.py",
    "yolox": "configs/yolox/yolox_s_8x8_300e_coco.py",
    "ssd": "configs/ssd/ssd300_coco.py",
    "solo": "configs/solo/solo_r50_fpn_1x_coco.py",
    "yolact": "configs/yolact/yolact_r50_1x8_coco.py",
}
FIRST = ("atss", "autoassign", "fcos", "gfl", "paa", "tood", "vfnet")
SECOND = ("fovea", "free_anchor", "fsaf", "ld", "pisa_retina")
THIRD = ("ga_retina", "nas_fcos", "nas_fpn", "sabl_retina")
FOURTH = ("centernet", "centripetalnet", "cornernet", "reppoints")
FIFTH = ("solo", "ssd", "yolact", "yolof", "yolox")
HOURGLASS = dict(downsample_times=2, stage_channels=(8, 8, 16), stage_blocks=(1, 1, 1),
                 feat_channel=8)
HW = (64, 96)
NAS_HW = (128, 192)
YOLOF_HW = (128, 192)
SSD_HW = (300, 300)
SOLO_GRIDS = (12, 9, 8, 6, 4)
NUM_CLASSES = 8


def tiny_model(name):
    """The config's model (a plain dict) narrowed: R18, FPN and head at 16
    channels, one conv a tower (TOOD two), 8 classes, 20 detections; LD's
    teacher likewise."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(osp.join(ROOT, CONFIGS[name]))
    m = cfg.model
    if name in FIFTH:
        return _plain(_fifth(name, m))
    if name in FOURTH and name != "reppoints":
        if name == "centernet":
            m.bbox_head.update(feat_channels=16)
        else:
            m.backbone.update(HOURGLASS)
            m.bbox_head.update(in_channels=8)
        m.bbox_head.update(num_classes=NUM_CLASSES)
        m.test_cfg.update(max_per_img=20)
        return _plain(m)
    parts = [m] + ([m.teacher_config.model] if name == "ld" else [])
    for part in parts:
        part.backbone.update(depth=18, init_cfg=None)
        part.neck.update(in_channels=[64, 128, 256, 512], out_channels=16)
        if name.startswith("nas"):                     # the maps the neck takes: C3..C5
            part.neck.update(in_channels=[128, 256, 512], start_level=1)
        if name == "nas_fpn":
            part.neck.update(stack_times=2)
        part.bbox_head.update(in_channels=16, feat_channels=16, num_classes=NUM_CLASSES,
                              stacked_convs=2 if name == "tood" else 1)
        if name == "reppoints":
            part.bbox_head.update(point_feat_channels=16)
    m.test_cfg.update(max_per_img=20)
    return _plain(m)


def _fifth(name, m):
    m.bbox_head.update(num_classes=NUM_CLASSES)
    m.test_cfg.update(max_per_img=20)
    if name == "ssd":
        return m
    if name == "yolox":
        m.backbone.update(widen_factor=0.125)
        m.neck.update(in_channels=[32, 64, 128], out_channels=16)
        m.bbox_head.update(in_channels=16, feat_channels=16)
        return m
    m.backbone.update(depth=18, init_cfg=None)
    if name == "yolof":
        m.neck.update(in_channels=512, out_channels=16, block_mid_channels=8)
        m.bbox_head.update(in_channels=16)
        return m
    m.neck.update(in_channels=[64, 128, 256, 512], out_channels=16)
    m.bbox_head.update(in_channels=16, feat_channels=16)
    if name == "solo":
        m.bbox_head.update(stacked_convs=2, num_grids=list(SOLO_GRIDS))
    else:
        m.bbox_head.update(num_protos=8)
    return m


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def batch(seed=4, n=2, g=4, hw=HW):
    """``n`` images of ``hw`` with ``g`` seeded gts each (the last of the
    last image padding), numpy, NHWC."""
    rng = np.random.RandomState(seed)
    h, w = hw
    x1 = rng.uniform(0, w - 30, (n, g))
    y1 = rng.uniform(0, h - 30, (n, g))
    gt = np.stack([x1, y1, np.minimum(x1 + rng.uniform(10, 50, (n, g)), w),
                   np.minimum(y1 + rng.uniform(10, 40, (n, g)), h)], -1).astype(np.float32)
    valid = np.ones((n, g), bool)
    valid[n - 1, -1] = False
    gt[n - 1, -1] = 0
    labels = rng.randint(0, NUM_CLASSES, (n, g)).astype(np.int32)
    labels[n - 1, -1] = 0
    return {"img": rng.normal(0, 1, (n, h, w, 3)).astype(np.float32),
            "gt_bboxes": gt, "gt_labels": labels, "gt_valid": valid,
            "img_shape": np.array([[h, w]] * n, np.float32),
            "scale_factor": np.ones((n, 4), np.float32)}


def with_masks(b, seed=9, m0=28):
    """``b`` with seeded box-cropped gt masks (N, G, m0, m0): a blob per gt
    (values in [0, 1], most of them 0 or 1)."""
    rng = np.random.RandomState(seed)
    n, g = b["gt_labels"].shape
    yy, xx = np.mgrid[0:m0, 0:m0] / (m0 - 1) - 0.5
    r = rng.uniform(0.25, 0.5, (n, g, 1, 1))
    cx, cy = (rng.uniform(-0.15, 0.15, (n, g, 1, 1)) for _ in range(2))
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    return dict(b, gt_masks=np.clip((r - d) * 20, 0, 1).astype(np.float32))


def randomize(variables, seed=2):
    """Seeded numpy weights on the tree of ``variables`` (shapes only)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        shape, name = tuple(leaf.shape), path[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(2.0 / fan_in) if path[-2].endswith("dconv") else 1 / np.sqrt(fan_in)
            return rng.normal(0, std, shape)
        if name in ("scales", "reg_scales", "scales_refine"):
            return rng.uniform(0.8, 1.2, shape)
        if name == "center_prior_mean":
            return rng.normal(0, 0.3, shape)
        if name == "center_prior_sigma":
            return rng.uniform(0.8, 1.5, shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, shape)
        if name == "l2_norm_scale_p":
            return rng.uniform(15, 25, shape)
        if name == "moment_transfer":
            return rng.normal(0, 0.1, shape)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.05, shape)
        raise KeyError("/".join(path))

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if hasattr(v, "items")
                else fill(path + (k,), v).astype(np.float32) for k, v in tree.items()}

    return walk(variables)


_BACKBONES = {}


def jax_backbone(model, jb):
    """The JAX R18-FPN's seeded variables and features, once a variant and
    batch."""
    import jax
    from oadg_tpu.models import build_detector as jax_build_detector
    key = (repr((model["backbone"], model["neck"])), np.asarray(jb["img"]).tobytes())
    if key not in _BACKBONES:
        jdet = jax_build_detector(model)
        extract = lambda m, x: m.extract_feat(x)                      # noqa: E731
        shapes = jax.eval_shape(lambda r, x: jdet.init(r, x, method=extract),
                                jax.random.PRNGKey(0), jb["img"])
        variables = {"params": randomize(shapes["params"]),
                     "batch_stats": randomize(shapes["batch_stats"], 3)}
        feats = jax.jit(lambda v, x: jdet.apply(v, x, method=extract))(variables, jb["img"])
        _BACKBONES[key] = variables, feats
    return _BACKBONES[key]


def jax_head_run(jdet, variables, feats, jb, soft=None):
    """JAX's head on ``feats``, in one jit: its losses (``soft``, the
    teacher's bin logits, handed to LD's as ``soft_targets``), the gradients
    w.r.t. the head's parameters, its outputs and ``get_bboxes``."""
    import jax
    extra = {} if soft is None else {"soft_targets": soft}

    def head_run(hp, feats, b):
        def loss_fn(hp):
            v = {"params": dict(variables["params"], head=hp),
                 "batch_stats": variables["batch_stats"]}
            outs = jdet.apply(v, feats, method=lambda m, f: m.head(f))
            losses = jdet.apply(v, outs, b["gt_bboxes"], b["gt_valid"], b["gt_labels"],
                                method=lambda m, o, g, gv, gl: m.head.loss(o, g, gv, gl, None,
                                                                           **extra))
            return sum(losses.values()), (losses, outs)

        (_, (losses, outs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(hp)
        dets = jdet.apply(variables, outs, b["img_shape"], b["scale_factor"],
                          method=lambda m, o, s, f: m.head.get_bboxes(o, s, f))
        return losses, grads, outs, dets

    return jax.jit(head_run)(variables["params"]["head"], feats, jb)
