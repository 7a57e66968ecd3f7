"""Data parallel on the CPU: the port's training step over a 2-process gloo
group against its one-process step and the JAX single-device step on the
same global batch.

JAX's data-parallel step is the single-device step on the global batch
(``tests/test_multihost.py:185-222``), so every loss normalizer, the
supervised-contrastive loss and live BN's statistics are global there; the
port's ranks must compute exactly that (``oadg_tpu_torch/parallel/dist.py``).

- The tiny flagship (``__graft_entry__._flagship_model_cfg(tiny=True)``,
  the case of ``test_torch_train_step.py``) on 4 images x 2 views of 64x96,
  rank r holding images 2r and 2r+1 (both views) and its rows of the draws
  JAX makes from its fixed sampling keys; SGD with ``grad_clip`` at a
  ``max_norm`` the global gradient exceeds, so the clip's scale is the
  global norm's.
- The tiny YOLOv3 (``torch_yolo_cases.model_cfg()``: full Darknet-53, live
  BNs in the neck and head) on 4 images x 2 views of 64x64: SyncBN.
- PISA-RetinaNet's, FreeAnchor's and FSAF's losses and PISA Faster
  R-CNN's RoI head on one image a rank, with IoUs that tie across views
  and across the ranks' images: the shares sum to the one-process losses,
  the gradients are the one-process ones (the global IoU rank gathered in
  the one-process order; the heads' global normalizers).
- The one-stage family's other heads (``FEAT_HEADS``: FCOS, ATSS, GFL,
  VFNet, TOOD, PAA, AutoAssign, FoveaBox, LD, GA, SABL, NAS-FPN's
  RetinaSepBNHead, whose per-level BNs are SyncBN, RepPoints, CenterNet,
  and CornerNet's and CentripetalNet's heads, whose corner pools' BNs are
  SyncBN and whose per-image means are the global batch's; DETR's and
  Deformable DETR's, one Hungarian assignment an image and per-image means)
  run from seeded features, one image a rank: the losses' shares and the
  features' gradients (TOOD's normalizers carry their gradient across the
  ranks).
- ``supcontrast``, the mask loss, the box head's loss and live BN alone,
  on seeded rows, the ranks' shards of equal and of unequal sizes; and
  outside ``sharded_batch()``, under the same live group, the loss and the
  statistics of the rank's own batch.
- The control: the YOLOv3 step with per-rank BN statistics (no SyncBN)
  misses the one-process step.

Tolerances. The 2-rank step against the one-process step (the same
arithmetic summed in another order): losses rtol 1e-5; the flagship's
gradients rtol 1e-5 with an absolute floor of 5e-7 x each tensor's largest
(measured 1.7e-7, ``rpn_head.rpn_conv.weight``: the convolutions' weight
gradients summed over 2 x 4 images instead of 8), the parameters and
buffers after the step rtol 1e-5 with a floor of 1e-7 x the largest
(measured 1.6e-8: zero-initialized biases move by the gradient alone).
YOLOv3's live BNs amplify that reassociation layer by layer (their
backward subtracts the batch means of the incoming gradient): gradients
rtol 1e-4 with a floor of 1e-4 x the largest (measured 2.3e-5), the state
after the step rtol 1e-5 with a floor of 3e-6 (measured 7.6e-7, a neck
BN's stored variance). The ``FEAT_HEADS`` features' gradients: rtol 1e-5
with a floor of ``FEAT_GRAD_FLOOR`` x each tensor's largest. Against JAX,
those of ``test_torch_train_step.py``
(losses 1e-4, gradients 1e-3 with a floor of 1e-5 x the largest) and of
``test_torch_yolo_slice.py`` for YOLOv3 (gradients a floor of 3e-4 x the
largest; BN statistics 1e-4 with a floor of 1e-5).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_cases as dc
import torch_yolo_cases as yc
from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.models.losses import supcontrast
from oadg_tpu_torch.models.roi_heads.mask_heads import FCNMaskHead
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from oadg_tpu_torch.utils.registry import HEADS, build_from_cfg
from test_torch_train_step import _randomize

torch.set_num_threads(2)
WORLD = 2
B, V, H, W, G = 4, 2, 64, 96, 5
KEYS = [jax.random.PRNGKey(11), jax.random.PRNGKey(12), jax.random.PRNGKey(13)]
FLAGSHIP = "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"
MAX_NORM = 1e-3                    # below the flagship's gradient norm: the step clips
SUP_LAYOUT = (12, 2, 8)            # global (R, V, P)
SUP_SPLITS = [[(6, 4), (6, 4)],    # (roi, random) rows a view on each rank
              [(8, 3), (4, 5)]]
MASK_ROWS = 10
BBOX_BOUNDS = [(0, 5), (5, 8)]     # 5 box-head rows on rank 0, 3 on rank 1


def _batch():
    rng = np.random.RandomState(0)
    img = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    img = np.concatenate([img, img + rng.normal(0, 0.2, img.shape).astype(np.float32)])
    x1 = rng.uniform(0, 50, (B, G))
    y1 = rng.uniform(0, 30, (B, G))
    gt = np.stack([x1, y1, np.minimum(x1 + rng.uniform(10, 50, (B, G)), W),
                   np.minimum(y1 + rng.uniform(10, 34, (B, G)), H)], -1)
    valid = np.ones((B, G), bool)
    valid[1, -1] = valid[3, -2:] = False
    gt[~valid] = 0
    return {"img": img,
            "gt_bboxes": np.tile(gt.astype(np.float32), (V, 1, 1)),
            "gt_labels": np.tile(rng.randint(0, 8, (B, G)).astype(np.int32), (V, 1)),
            "gt_valid": np.tile(valid, (V, 1)),
            "img_shape": np.array([[H, W]] * (B * V), np.float32)}


def _jax_draws(num_anchors, num_cand, num_boxes):
    """The uniforms JAX draws from ``KEYS`` for the global batch (as
    ``test_torch_train_step._jax_draws``, at B images)."""
    def pair(key, size):
        kp, kn = jax.random.split(key)
        return jax.random.uniform(kp, (size,)), jax.random.uniform(kn, (size,))

    rpn = [pair(k, num_anchors) for k in jax.random.split(KEYS[0], B * V)]
    roi = [pair(k, num_cand) for k in jax.random.split(KEYS[1], B)]
    boxes = [[jax.random.uniform(s, (num_boxes,)) for s in jax.random.split(k, 4)]
             for k in jax.random.split(KEYS[2], B * V)]
    as_t = lambda x: torch.from_numpy(np.asarray(x))            # noqa: E731
    return {"rpn.pos": as_t([p for p, _ in rpn]), "rpn.neg": as_t([n for _, n in rpn]),
            "rcnn.pos": as_t([p for p, _ in roi]), "rcnn.neg": as_t([n for _, n in roi]),
            "random_boxes": as_t(boxes)}


def _torch_batch(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["img"] = t["img"].permute(0, 3, 1, 2).contiguous()
    return t


def _flagship_jax(model, batch, variables):
    jdet = jax_build_detector(model, num_views=V)
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 3]

    def loss_fn(params, b):
        losses = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]}, b,
                            "train")
        return sum(v for k, v in losses.items() if "loss" in k), losses

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        mp.undo()
    return ({k: float(v) for k, v in losses.items()},
            jax_variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)},
                                        roi_channels=16))


def _sup_inputs():
    rng = np.random.RandomState(5)
    r, v, p = SUP_LAYOUT
    n = (r + p) * v
    labels = np.concatenate([rng.randint(0, 4, r * v), np.full(p * v, 4)])
    labels[: r * v: 3] = 4                     # background roi rows
    valid = rng.uniform(size=n) > 0.1
    return dict(layout=SUP_LAYOUT, splits=SUP_SPLITS, min_samples=3,
                feats=torch.from_numpy(rng.normal(0, 1, (n, 8)).astype(np.float32)),
                labels=torch.from_numpy(labels), valid=torch.from_numpy(valid))


def _mask_inputs():
    rng = np.random.RandomState(6)
    pos = np.zeros(MASK_ROWS, bool)
    pos[[0, 1, 2, 3, 6]] = True                # 4 positives on rank 0, 1 on rank 1
    return dict(pred=torch.from_numpy(rng.normal(0, 2, (MASK_ROWS, 3, 4, 4)).astype(np.float32)),
                targets=torch.from_numpy((rng.uniform(size=(MASK_ROWS, 4, 4)) > 0.5)
                                         .astype(np.float32)),
                labels=torch.from_numpy(rng.randint(0, 3, MASK_ROWS)),
                pos=torch.from_numpy(pos))


def _bbox_inputs():
    rng = np.random.RandomState(7)
    n, c = BBOX_BOUNDS[-1][1], 3
    labels = rng.randint(0, c + 1, n)
    labels[[1, 6]] = c                         # background rows
    label_w = np.ones(n, np.float32)
    label_w[[2, 7]] = 0.0                      # padding rows
    pos = (labels < c) & (label_w > 0)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))    # noqa: E731
    return dict(bounds=BBOX_BOUNDS, cls=f(rng.normal(0, 1, (n, c + 1))),
                reg=f(rng.normal(0, 1, (n, 4 * c))), labels=torch.from_numpy(labels),
                label_w=f(label_w), targets=f(rng.normal(0, 1, (n, 4))),
                bbox_w=f(np.repeat(pos[:, None], 4, 1)))


def _retina_inputs():
    """2 images of 64x64 for a 2-level RetinaNet head: the maps, and gts that
    give the images different numbers of positive anchors (4 gts and 1)."""
    rng = np.random.RandomState(9)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))    # noqa: E731
    gt = np.array([[[4, 4, 20, 20], [30, 8, 46, 24], [8, 36, 40, 60], [36, 36, 52, 52]],
                   [[10, 10, 42, 42], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]])
    valid = np.array([[True] * 4, [True, False, False, False]])
    return dict(cls=[f(rng.normal(0, 1, (2, 3, s, s))) for s in (8, 4)],
                reg=[f(rng.normal(0, 0.5, (2, 4, s, s))) for s in (8, 4)],
                gt=f(gt), gt_valid=torch.from_numpy(valid),
                gt_labels=torch.from_numpy(rng.randint(0, 3, (2, 4))))


DENSE_HEADS = {
    # RetinaNet's anchors on 2 levels (strides 8, 16), 3 ratios: 240 anchors
    # an image, more than FreeAnchor's bag of 50
    "pisa_retina": dict(type="PISARetinaHead"),
    "free_anchor": dict(type="FreeAnchorRetinaHead",
                        bbox_coder=dict(type="DeltaXYWHBBoxCoder", target_means=[0.] * 4,
                                        target_stds=[0.1, 0.1, 0.2, 0.2]),
                        loss_bbox=dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.75)),
    "fsaf": dict(type="FSAFHead", strides=[8, 16]),
}
ANCHORS = dict(type="AnchorGenerator", octave_base_scale=4, scales_per_octave=1,
               ratios=[0.5, 1.0, 2.0], strides=[8, 16])
# The one-stage family's heads that take ``shard_sum`` normalizers, each with
# its published config's head (``torch_onestage_cases.tiny_model``) at 8
# channels and 3 classes, run from seeded features of five levels of a 64x64
# image (its forward and loss on each rank's image): NAS-FPN's is
# RetinaSepBNHead, whose per-level BNs are SyncBN there, as the corner
# heads' pools' are.
FEAT_HEADS = ("atss", "autoassign", "fcos", "fovea", "ga_retina", "gfl", "ld", "nas_fpn", "paa",
              "sabl_retina", "tood", "vfnet", "reppoints", "centernet", "cornernet",
              "centripetalnet", "yolof", "yolox", "ssd", "solo", "yolact", "detr",
              "deformable_detr")
# the DETR heads of ``torch_detr_cases`` at 8 channels (the deformable one on
# the three levels of its ChannelMapper), 6 queries; their losses read the
# images' shapes
DETR_HEADS = {"detr": dict(in_channels=8), "deformable_detr": dict(num_levels=3)}
# YOLOF's head runs behind its DilatedEncoder (8 channels, 4 in its blocks),
# both with live BNs (SyncBN here), on one stride-32 map; YOLOX's three
# levels; SSD's six at SSD300's sizes; SOLO's and YOLACT's losses take the
# images' seeded gt masks, YOLACT's mask loss is a mean over the global
# batch's images
NECKS = {"yolof": dict(type="DilatedEncoder", in_channels=8, out_channels=8,
                       block_mid_channels=4)}
# the maps a head takes where they are not five levels of 32x32 to 2x2:
# CenterNet's one stride-8 map, the corner heads' two stacks at stride 4;
# RepPoints' top level at 4x4 (on 2x2 its GNs after the DCNs hold 8 values
# a group, and the DCN's gradient summed over 1 image instead of 2 moves
# the features' gradient there by 8.5e-5 of its largest)
FEAT_SIZES = {"centernet": (8,), "cornernet": (16, 16), "centripetalnet": (16, 16),
              "reppoints": (32, 16, 8, 4, 4), "yolof": (4,), "yolox": (8, 4, 2),
              "ssd": (38, 19, 10, 5, 3, 1), "solo": (16, 8, 4, 2, 1), "yolact": (8, 4, 2, 1, 1),
              "detr": (4,), "deformable_detr": (8, 4, 2)}
# gts centred on points of GA's levels 0 and 1 (its loc and shape
# positives are a gt's level's points inside its central fifth)
# the features' gradients pass the head's convs and GNs, summed over 2 x 1
# images instead of 2 in one batch: rtol 1e-5 with a floor of this times
# each tensor's largest (measured 1.1e-5 of the largest, TOOD's stride-16
# level; the others 4e-6 and below)
FEAT_GRAD_FLOOR = 5e-5
FEAT_GT = np.array([[[26, 26, 46, 46], [20, 4, 60, 44], [8, 36, 40, 60], [36, 36, 52, 52]],
                    [[50, 34, 70, 54], [10, 30, 40, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                   np.float32)


def _dense_inputs():
    """2 images of 64x64 for each head of ``DENSE_HEADS`` (3 classes, 4
    channels): seeded maps, gts giving the images different numbers of
    positives and gts (4 and 2, two padded; the first gt in both images, so
    that IoUs tie across the ranks' images), seeded weights. PISA-RetinaNet
    takes 2 views of each image (views-major, the same gts on both), so its
    IoUs tie across the views too; the others one."""
    rng = np.random.RandomState(10)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))    # noqa: E731
    gt = np.array([[[4, 4, 30, 28], [30, 8, 60, 40], [8, 36, 40, 60], [36, 36, 52, 52]],
                   [[4, 4, 30, 28], [20, 30, 60, 62], [0, 0, 0, 0], [0, 0, 0, 0]]])
    valid = np.array([[True] * 4, [True, True, False, False]])
    labels = rng.randint(0, 3, (2, 4))
    out = {}
    for name, cfg in DENSE_HEADS.items():
        views = 2 if name == "pisa_retina" else 1
        head_cfg = dict(cfg, num_classes=3, in_channels=4, feat_channels=4, stacked_convs=1)
        if name != "fsaf":
            head_cfg["anchor_generator"] = ANCHORS
        a = 1 if name == "fsaf" else 3
        n = 2 * views
        shapes = build_from_cfg(dict(head_cfg, num_views=views), HEADS,
                                dict(device="cpu")).state_dict()
        reg = [rng.normal(0, 0.5, (n, 4 * a, s, s)) for s in (8, 4)]
        if name == "fsaf":                          # positive distances, 4 strides a unit
            reg = [np.abs(r) + 0.2 for r in reg]
        out[name] = dict(
            cfg=head_cfg, views=views, images=2,
            state={k: f(rng.normal(0, 0.1, v.shape)) for k, v in shapes.items()},
            cls=[f(rng.normal(0, 1, (n, 3 * a, s, s))) for s in (8, 4)], reg=[f(r) for r in reg],
            gt=f(np.tile(gt, (views, 1, 1))), gt_valid=torch.from_numpy(np.tile(valid, (views, 1))),
            gt_labels=torch.from_numpy(np.tile(labels, (views, 1))))
    for name in FEAT_HEADS:
        out[name] = _feat_head_inputs(name, rng)
    return out


def _feat_head_inputs(name, rng):
    """A ``FEAT_HEADS`` entry: its head config, the head's own seeded init,
    features of 2 images (8 channels; maps 8x8 to 1x1), ``FEAT_GT`` and
    seeded labels, and LD's teacher bin logits (``soft``)."""
    import torch_detr_cases as detr_cases
    import torch_onestage_cases as oc
    from oadg_tpu_torch.models.layers import init_default_
    if name in DETR_HEADS:
        model = detr_cases.torch_model(name)
        cfg = dict(model["bbox_head"], embed_dims=8, num_query=6, num_classes=3,
                   train_cfg=model.get("train_cfg"), test_cfg=model.get("test_cfg"),
                   **DETR_HEADS[name])
    else:
        model = oc.tiny_model(name)
        cfg = dict(model["bbox_head"], in_channels=8, feat_channels=64, num_classes=3,
                   train_cfg=model.get("train_cfg"), test_cfg=model.get("test_cfg"))
    if name in ("cornernet", "centripetalnet", "yolof", "ssd"):
        del cfg["feat_channels"]
    if name == "ssd":
        cfg["in_channels"] = (8,) * 6
    spec = dict(cfg=cfg, views=1, neck=NECKS.get(name))
    head = dc.dense_head(dict(spec, state=None))
    gen = torch.Generator().manual_seed(13)
    init_default_(head, gen)
    head.init_weights(gen)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))    # noqa: E731
    feats = [f(rng.normal(0, 1, (2, 8, s, s))) for s in FEAT_SIZES.get(name, (32, 16, 8, 4, 2))]
    out = dict(spec, images=2, state=head.state_dict(), feats=feats, gt=f(FEAT_GT),
               gt_valid=torch.from_numpy(FEAT_GT[..., 2] > 0),
               gt_labels=torch.from_numpy(rng.randint(0, 3, (2, 4))))
    if name in ("solo", "yolact"):
        out["masks"] = f(oc.with_masks(dict(gt_labels=FEAT_GT[..., 0]), m0=16)["gt_masks"])
    if name in DETR_HEADS:
        out["img_shapes"] = f([[64, 96]] * 2)
    if name == "ld":
        with torch.no_grad():
            out["soft"] = [f(rng.normal(0, 2, r.shape)) for r in head(feats)[1]]
    return out


def _pisa_roi_inputs():
    """The PISA Faster R-CNN's RoI head made tiny
    (``torch_twostage_cases.tiny_roi``) with 2 views of 2 images of 64x64:
    ``torch_twostage_cases.inputs(3)``'s maps, the second view's moved by
    seeded noise, image 0's proposals and gts in both images and on both
    views (so the sampled rows' IoUs tie across the views and across the
    ranks' images), seeded sampler uniforms (other rows for each image) and
    weights."""
    import torch_twostage_cases as tc
    case = tc.inputs(3)
    rng = np.random.RandomState(12)
    model = dc.plain(tc.tiny_roi(tc.load_model("pisa", "torch")))
    shapes = tc.port_head(model).state_dict()
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))    # noqa: E731
    tile = lambda a: np.concatenate([a[:1]] * 4)                  # noqa: E731
    feats = [f(np.concatenate([x, x + rng.normal(0, 0.5, x.shape)]).transpose(0, 3, 1, 2))
             for x in case["feats"]]
    size = tc.G + tc.P
    return dict(model=model, views=2, images=tc.N, feats=feats,
                state={k: f(rng.normal(0, 0.05, v.shape)) for k, v in shapes.items()},
                props=f(tile(case["props"])), prop_valid=torch.from_numpy(tile(case["prop_valid"])),
                gt=f(tile(case["gt"])), gt_valid=torch.from_numpy(tile(case["gt_valid"])),
                labels=torch.from_numpy(tile(case["labels"])).long(),
                draws={"rcnn.pos": f(rng.uniform(0, 1, (tc.N, size))),
                       "rcnn.neg": f(rng.uniform(0, 1, (tc.N, size)))})


def _bn_inputs():
    """Each rank's live-BN input, of other shapes (40 and 30 pixels a
    channel), and the coefficients of the summed output."""
    rng = np.random.RandomState(8)
    shapes = [(2, 3, 4, 5), (1, 3, 6, 5)]
    f = lambda a: torch.from_numpy(a.astype(np.float32))         # noqa: E731
    return dict(x=[f(rng.normal(1, 2, s)) for s in shapes],
                coef=[f(rng.normal(0, 1, s)) for s in shapes])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank gloo runs (one group for the file), and while they run the
    JAX steps and the port's one-process steps on the global batches."""
    cfg = load_config(FLAGSHIP)
    _, fmodel = _flagship_model_cfg(tiny=True)
    fmodel = dc.plain(fmodel)
    batch = _batch()
    jdet = jax_build_detector(fmodel, num_views=V)
    jb = {k: jnp.asarray(batch[k]) for k in ("img", "img_shape")}
    fvars = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, jb))
    fstate = jax_variables_to_state_dict(fvars, roi_channels=16)
    fdet = init_detector({"model": fmodel}, device="cpu", num_views=V).model
    tbatch = _torch_batch(batch)
    with torch.no_grad():
        fdet.load_state_dict(fstate)
        feats = fdet.extract_feat(tbatch["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = fmodel["train_cfg"]["rpn_proposal"]["max_per_img"]
    fdraws = _jax_draws(num_anchors, G + rp, 10)
    flagship = dict(model=fmodel, state=fstate, batch=tbatch, draws=fdraws, images=B,
                    optimizer=dc.plain(cfg.optimizer), grad_clip=dict(max_norm=MAX_NORM))

    ymodel = yc.model_cfg()
    ybatch = yc.views_batch(b=B)
    ycfg = load_config(yc.YOLO_OADG)
    yj = yc.jax_detector(ymodel, V)
    yvars = yc.jax_variables(yj, ybatch)
    yolo = dict(model=dc.plain(ymodel), state=jax_variables_to_state_dict(yvars),
                batch=yc.torch_batch(ybatch), draws=yc.cont_draws(B, 252), images=B,
                optimizer=dc.plain(ycfg.optimizer),
                grad_clip=dc.plain(ycfg.optimizer_config["grad_clip"]))

    job = dict(tasks=["supcontrast", "mask_loss", "bbox_loss", "retina_loss", "dense_loss",
                      "pisa_roi", "bn", "flagship", "yolo", "yolo_local_bn"], flagship=flagship,
               yolo=yolo, supcontrast=_sup_inputs(), mask_loss=_mask_inputs(),
               bbox_loss=_bbox_inputs(), retina_loss=_retina_inputs(),
               dense_loss=_dense_inputs(), pisa_roi=_pisa_roi_inputs(), bn=_bn_inputs())
    handle = dc.start(job, WORLD, tmp_path_factory.mktemp("dist_step"))
    try:
        out = dict(job=job, fvars=fvars, yvars=yvars)
        out["flagship_jax"] = _flagship_jax(fmodel, batch, fvars)
        out["flagship_one"] = dc.run_step(fdet, fstate, tbatch, fdraws, flagship["optimizer"],
                                          flagship["grad_clip"])
        rank_cont = []
        for r in range(WORLD):
            fdet.load_state_dict(fstate)
            with torch.no_grad():
                losses = fdet.forward_train(
                    dc.local_batch(tbatch, B, V, r, WORLD),
                    UniformDraws(given=dc.local_draws(fdraws, B, V, r, WORLD)))
            rank_cont.append(float(losses["loss_cont"]))
        out["flagship_rank_cont"] = rank_cont
        out["yolo_jax"] = yc.jax_train(yj, yvars, ybatch)
        ydet = init_detector({"model": yolo["model"]}, device="cpu", num_views=V).model
        out["yolo_one"] = dc.run_step(ydet, yolo["state"], yolo["batch"], yolo["draws"],
                                      yolo["optimizer"], yolo["grad_clip"])
    finally:
        out["ranks"] = dc.finish(handle, timeout=600)
    return out


def _close(got, want, rtol, floor, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("model", ["flagship", "yolo"])
def test_ranks_hold_one_state(runs, model):
    """Both ranks log the same global values and end the step with the same
    parameters and buffers, bit for bit."""
    a, b = (r[model] for r in runs["ranks"])
    assert a["log"] == b["log"]
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


ONE_PROCESS_TOL = {"flagship": dict(grads=(1e-5, 5e-7), state=(1e-5, 1e-7)),
                   "yolo": dict(grads=(1e-4, 1e-4), state=(1e-5, 3e-6))}


@pytest.mark.parametrize("model", ["flagship", "yolo"])
def test_two_ranks_equal_one_process(runs, model):
    """The 2-rank step equals the one-process step on the global batch:
    every logged value, every summed gradient, every parameter and buffer
    after the step (the YOLOv3 BNs' stored statistics included: SyncBN)."""
    got, want = runs["ranks"][0][model], runs[f"{model}_one"]
    assert got["log"].keys() == want["log"].keys()
    for k, w in want["log"].items():
        np.testing.assert_allclose(got["log"][k], w, rtol=1e-5, err_msg=k)
    tol = ONE_PROCESS_TOL[model]
    assert got["grads"].keys() == want["grads"].keys() and want["grads"]
    for k, w in want["grads"].items():
        _close(got["grads"][k].numpy(), w.numpy(), *tol["grads"], name=k)
    for k, w in want["state"].items():
        _close(got["state"][k].numpy(), w.numpy(), *tol["state"], name=k)


def test_flagship_frozen_parameters_stay(runs):
    det = init_detector({"model": runs["job"]["flagship"]["model"]}, device="cpu",
                        num_views=V).model
    frozen = [k for k, p in det.named_parameters() if not p.requires_grad]
    assert len(frozen) == 15
    start = runs["job"]["flagship"]["state"]
    for r in runs["ranks"]:
        for k in frozen:
            assert torch.equal(r["flagship"]["state"][k], start[k]), k
            assert k not in r["flagship"]["grads"]


def test_flagship_clips_by_the_global_norm(runs):
    """The summed gradient's norm is above ``max_norm``: both sides clipped
    it by the same global scale, so the moves agree."""
    grads = runs["ranks"][0]["flagship"]["grads"]
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    assert norm > 10 * MAX_NORM
    start = runs["job"]["flagship"]["state"]
    for k in grads:
        got = runs["ranks"][0]["flagship"]["state"][k] - start[k]
        want = runs["flagship_one"]["state"][k] - start[k]
        _close(got.numpy(), want.numpy(), 1e-4, 1e-6)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc",
                                 "loss_bbox", "loss_cont"])
def test_flagship_losses_match_jax(runs, key):
    got = runs["ranks"][0]["flagship"]["log"][key]
    np.testing.assert_allclose(got, runs["flagship_jax"][0][key], rtol=1e-4)
    if key == "loss_cont":
        assert got > 0


def test_flagship_gradients_match_jax(runs):
    grads = runs["ranks"][0]["flagship"]["grads"]
    want = runs["flagship_jax"][1]
    assert len(grads) == 79
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=k)


def test_per_rank_mean_misses_the_global_contrastive_loss(runs):
    """A plain DDP wrap averages each rank's own loss: for ``loss_cont``
    (background label, ``min_samples`` gate and divisor from the rank's own
    rows, pairs within the rank) that mean misses the global value by far
    more than the JAX tolerance, so the checks above would catch it."""
    mean = float(np.mean(runs["flagship_rank_cont"]))
    want = runs["flagship_jax"][0]["loss_cont"]
    assert abs(mean - want) > 1e-2 * abs(want), (mean, want)
    np.testing.assert_allclose(runs["ranks"][0]["flagship"]["log"]["loss_cont"], want,
                               rtol=1e-4)


@pytest.mark.parametrize("key", yc.LOSS_KEYS)
def test_yolo_losses_match_jax(runs, key):
    got = runs["ranks"][0]["yolo"]["log"][key]
    np.testing.assert_allclose(got, float(runs["yolo_jax"][0][key]), rtol=1e-4)
    assert got > 0


def test_yolo_gradients_and_syncbn_statistics_match_jax(runs):
    """Every gradient (``test_torch_yolo_slice.py``'s tolerances) and every
    live BN's stored statistics after the step against JAX's global-batch
    step; the backbone's (``norm_eval``) unchanged."""
    got = runs["ranks"][0]["yolo"]
    want = jax_variables_to_state_dict({"params": runs["yolo_jax"][1]})
    assert got["grads"].keys() == want.keys()
    for k, g in got["grads"].items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=3e-4 * np.abs(w).max(),
                                   err_msg=k)
    stats = jax_variables_to_state_dict({"batch_stats": runs["yolo_jax"][2]})
    before = runs["job"]["yolo"]["state"]
    assert stats and stats.keys() == {k for k in got["state"] if "running_" in k}
    for k, w in stats.items():
        yc.close(got["state"][k].numpy(), w.numpy(), 1e-4, 1e-5)
        assert torch.equal(got["state"][k], before[k]) == k.startswith("backbone."), k


def test_supcontrast_shares_sum_to_the_global_loss(runs):
    """``supcontrast`` over 2 ranks' rows: the shares sum to the one-process
    loss on the global rows and each rank's gradient is its rows' of the
    global gradient (``gather_rows``' backward)."""
    j = runs["job"]["supcontrast"]
    feats = j["feats"].clone().requires_grad_(True)
    want = supcontrast(feats, j["labels"], j["valid"], j["layout"], temper=0.06,
                       min_samples=j["min_samples"])
    want.backward()
    ranks = [r["supcontrast"]["splits"][0] for r in runs["ranks"]]
    want = float(want.detach())
    assert want > 0
    np.testing.assert_allclose(sum(r["loss"] for r in ranks), want, rtol=1e-5)
    covered = sorted(i for r in ranks for i in r["rows"])
    assert covered == list(range(feats.shape[0]))
    for r in ranks:
        _close(r["grad"].numpy(), feats.grad[r["rows"]].numpy(), 1e-5, 1e-7)


def test_mask_loss_divides_by_every_ranks_positives(runs):
    """The mask loss over 2 ranks with 4 and 1 positives: the shares sum to
    the one-process loss (the divisor counts both ranks' positives), and
    the gradients are the one-process rows'."""
    j = runs["job"]["mask_loss"]
    head = FCNMaskHead(num_convs=0, in_channels=4, conv_out_channels=4, num_classes=3,
                       device="cpu")
    pred = j["pred"].clone().requires_grad_(True)
    want = head.loss(pred, j["targets"], j["labels"], j["pos"])
    want.backward()
    want = float(want.detach())
    ranks = [r["mask_loss"] for r in runs["ranks"]]
    np.testing.assert_allclose(sum(r["loss"] for r in ranks), want, rtol=1e-6)
    np.testing.assert_allclose(torch.cat([r["grad"] for r in ranks]).numpy(),
                               pred.grad.numpy(), rtol=1e-6, atol=1e-9)
    per_rank = [float(head.loss(j["pred"][s], j["targets"][s], j["labels"][s], j["pos"][s]))
                for s in (slice(0, 5), slice(5, 10))]
    assert abs(np.mean(per_rank) - want) > 1e-3 * want


def test_supcontrast_shares_of_unequal_shards_sum_to_the_global_loss(runs):
    """The ranks hold 8 + 3 and 4 + 5 (roi + random) rows a view: the
    gathered layout is still the global one, the shares sum to the
    one-process loss and each rank's gradient is its rows'."""
    j = runs["job"]["supcontrast"]
    feats = j["feats"].clone().requires_grad_(True)
    want = supcontrast(feats, j["labels"], j["valid"], j["layout"], temper=0.06,
                       min_samples=j["min_samples"])
    want.backward()
    ranks = [r["supcontrast"]["splits"][1] for r in runs["ranks"]]
    assert [len(r["rows"]) for r in ranks] == [22, 18]
    np.testing.assert_allclose(sum(r["loss"] for r in ranks), float(want.detach()),
                               rtol=1e-5)
    assert sorted(i for r in ranks for i in r["rows"]) == list(range(feats.shape[0]))
    for r in ranks:
        _close(r["grad"].numpy(), feats.grad[r["rows"]].numpy(), 1e-5, 1e-7)


def test_forward_outside_the_sharded_batch_stays_local(runs):
    """Under a live group, outside ``sharded_batch()``: ``supcontrast`` is
    the one-process loss of the rank's own rows and live BN stores the
    statistics of the rank's own input."""
    from oadg_tpu_torch.models.layers import BatchNorm
    j = runs["job"]["supcontrast"]
    for rank, r in enumerate(runs["ranks"]):
        rows = dc.sup_rows(j["layout"], j["splits"][0], rank)
        r_roi, r_rnd = j["splits"][0][rank]
        want = supcontrast(j["feats"][rows], j["labels"][rows], j["valid"][rows],
                           (r_roi, V, r_rnd), temper=0.06, min_samples=j["min_samples"])
        assert r["supcontrast"]["unsharded"] == float(want)
        bn = BatchNorm(3).train()
        bn(runs["job"]["bn"]["x"][rank])
        assert torch.equal(r["bn"]["local_mean"], bn.running_mean)
        assert torch.equal(r["bn"]["local_var"], bn.running_var)


def test_syncbn_counts_every_ranks_pixels(runs):
    """Live BN over ranks holding 40 and 30 pixels a channel equals one BN
    over all 70 pixels: outputs, stored statistics (the unbiased variance
    with n = 70) and the input gradients."""
    from oadg_tpu_torch.models.layers import BatchNorm
    j = runs["job"]["bn"]
    flat = lambda ts: torch.cat([t.permute(1, 0, 2, 3).reshape(3, -1)   # noqa: E731
                                 for t in ts], 1)[None, :, None, :]
    x = flat(j["x"]).clone().requires_grad_(True)
    bn = BatchNorm(3).train()
    y = bn(x)
    (y * flat(j["coef"])).sum().backward()
    got = [r["bn"] for r in runs["ranks"]]
    np.testing.assert_allclose(flat([g["y"] for g in got]).numpy(), y.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(flat([g["grad"] for g in got]).numpy(), x.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["mean"].numpy(), bn.running_mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(g["var"].numpy(), bn.running_var.numpy(), rtol=1e-6)


def test_bbox_loss_counts_every_ranks_rows(runs):
    """The box head's loss over ranks holding 5 and 3 rows: the shares sum
    to the one-process losses on the 8 rows (both divisors count every
    rank's rows) and the gradients are the one-process rows'."""
    from oadg_tpu_torch.models.roi_heads.bbox_heads import Shared2FCBBoxHead
    j = runs["job"]["bbox_loss"]
    head = Shared2FCBBoxHead(in_channels=1, fc_out_channels=4, roi_feat_size=1,
                             num_classes=3, device="cpu")
    cls = j["cls"].clone().requires_grad_(True)
    reg = j["reg"].clone().requires_grad_(True)
    want = head.loss(cls, reg, j["labels"], j["label_w"], j["targets"], j["bbox_w"])
    (want["loss_cls"] + want["loss_bbox"]).backward()
    got = [r["bbox_loss"] for r in runs["ranks"]]
    for k in ("loss_cls", "loss_bbox", "acc"):
        np.testing.assert_allclose(sum(g["losses"][k] for g in got), float(want[k].detach()),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(torch.cat([g["cls"] for g in got]).numpy(), cls.grad.numpy(),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(torch.cat([g["reg"] for g in got]).numpy(), reg.grad.numpy(),
                               rtol=1e-5, atol=1e-8)


def test_retina_loss_counts_every_ranks_positives(runs):
    """RetinaNet's loss over 2 ranks of one image each (the images hold
    different numbers of positive anchors): the shares sum to the
    one-process losses (``num_pos`` counted over every rank) and the maps'
    gradients are the one-process ones."""
    j = runs["job"]["retina_loss"]
    cls = [c.clone().requires_grad_(True) for c in j["cls"]]
    reg = [r.clone().requires_grad_(True) for r in j["reg"]]
    want = dc.retina_head().loss((cls, reg), j["gt"], j["gt_valid"], j["gt_labels"])
    sum(want.values()).backward()
    got = [r["retina_loss"] for r in runs["ranks"]]
    for k in ("loss_cls", "loss_bbox"):
        np.testing.assert_allclose(sum(g["losses"][k] for g in got), float(want[k].detach()),
                                   rtol=1e-5, err_msg=k)
        assert got[0]["losses"][k] != got[1]["losses"][k]
    for i in range(2):
        np.testing.assert_allclose(torch.cat([g["cls"][i] for g in got]).numpy(),
                                   cls[i].grad.numpy(), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(torch.cat([g["reg"][i] for g in got]).numpy(),
                                   reg[i].grad.numpy(), rtol=1e-5, atol=1e-8)


def test_per_rank_bn_misses_the_one_process_yolo_step(runs):
    """The control of the YOLOv3 checks: the 2-rank step with live BN's
    sums left unreduced (each rank's own statistics, a DDP wrap without
    SyncBN) misses the one-process step beyond the limits
    ``test_two_ranks_equal_one_process`` holds the SyncBN step to, in the
    gradients and in the stored statistics."""
    got, want = runs["ranks"][0]["yolo_local_bn"], runs["yolo_one"]
    rtol, floor = ONE_PROCESS_TOL["yolo"]["grads"]

    def worst(a, b, rtol, floor):
        b = b.double()
        return float(((a.double() - b).abs() / (rtol * b.abs() + floor * b.abs().max())).max())

    grads = max(worst(got["grads"][k], w, rtol, floor) for k, w in want["grads"].items())
    rtol, floor = ONE_PROCESS_TOL["yolo"]["state"]
    stats = max(worst(got["state"][k], w, rtol, floor) for k, w in want["state"].items()
                if "running_" in k)
    assert grads > 1 and stats > 1, (grads, stats)


@pytest.mark.parametrize("name", sorted(DENSE_HEADS) + list(FEAT_HEADS))
def test_dense_head_loss_counts_every_ranks_rows(runs, name):
    """PISA-RetinaNet's, FreeAnchor's and FSAF's losses over 2 ranks of one
    image each (every view): the shares sum to the one-process losses and
    the maps' gradients are the one-process ones. The normalizers are
    global (``num_pos``; FreeAnchor's ``num_gts`` and ``num_gts * k``; FSAF's
    ``num_pos``), and so are PISA-RetinaNet's IoU rank, gathered in the
    one-process order (its views tie: a rank's rows gathered as they lie
    would put the ISR-P weights of tied rows on other rows), and CARL's
    weight mass, whose gradient reaches every rank. The same for
    ``FEAT_HEADS`` (FCOS, ATSS, GFL, VFNet, TOOD, PAA, AutoAssign, FoveaBox,
    LD, GA, SABL, RetinaSepBNHead, RepPoints, CenterNet, CornerNet's and
    CentripetalNet's heads; YOLOF's behind its DilatedEncoder, YOLOX's,
    SSD's, SOLO's and YOLACT's; DETR's and Deformable DETR's, whose losses
    are per-image means with one Hungarian assignment an image) run from
    features: each rank's forward and loss, the features' gradients."""
    j = runs["job"]["dense_loss"][name]
    gts = (j["gt"], j["gt_valid"], j["gt_labels"])
    if "feats" in j:
        leaves = {"feats": [f.clone().requires_grad_(True) for f in j["feats"]]}
        extra = {"soft_targets": j["soft"]} if "soft" in j else {}
        if "masks" in j:
            extra["gt_masks"] = j["masks"]
        if "img_shapes" in j:
            extra["img_shapes"] = j["img_shapes"]
        head = dc.dense_head(j)
        want = head.loss(head(leaves["feats"]), *gts, **extra)
    else:
        leaves = {k: [m.clone().requires_grad_(True) for m in j[k]] for k in ("cls", "reg")}
        want = dc.dense_head(j).loss((leaves["cls"], leaves["reg"]), *gts)
    sum(want.values()).backward()
    got = [r["dense_loss"][name] for r in runs["ranks"]]
    assert sorted(got[0]["losses"]) == sorted(want)
    for k in want:
        np.testing.assert_allclose(sum(g["losses"][k] for g in got), float(want[k].detach()),
                                   rtol=1e-5, err_msg=k)
        assert got[0]["losses"][k] != got[1]["losses"][k], k
    for kind, maps in leaves.items():
        for i, m in enumerate(maps):
            for g in got:
                want_g = m.grad[g["rows"]].numpy()
                floor = FEAT_GRAD_FLOOR * np.abs(want_g).max() if kind == "feats" else 1e-8
                np.testing.assert_allclose(g[kind][i].numpy(), want_g, rtol=1e-5, atol=floor,
                                           err_msg=f"{kind} {i}")


def test_pisa_roi_head_counts_every_ranks_rows(runs):
    """PISA Faster R-CNN's RoI head over 2 ranks of one image each (both
    views), which raised under a sharded batch before: the shares of
    ``loss_cls``, ``loss_bbox``, ``acc`` and ``loss_carl`` sum to the
    one-process values, the maps' gradients are the one-process rows' and
    the parameters' gradients sum to the one-process ones. The sampled rows
    repeat over the views, so their IoUs tie across the views and the
    global rank must see them in the one-process order."""
    j = runs["job"]["pisa_roi"]
    want, feats, head = dc.pisa_roi_loss(j, list(range(4)), [0, 1])
    sum(v for k, v in want.items() if "loss" in k).backward()
    got = [r["pisa_roi"] for r in runs["ranks"]]
    assert sorted(got[0]["losses"]) == sorted(want) == ["acc", "loss_bbox", "loss_carl",
                                                         "loss_cls"]
    for k in want:
        np.testing.assert_allclose(sum(g["losses"][k] for g in got), float(want[k].detach()),
                                   rtol=1e-5, err_msg=k)
    for r, g in enumerate(got):
        rows = dc.rank_rows(2, 2, r, WORLD)
        for i, f in enumerate(feats):
            if f.grad is None:                  # the fifth level: no RoI reads it
                assert g["feats"][i] is None and i == 4
                continue
            np.testing.assert_allclose(g["feats"][i].numpy(), f.grad[rows].numpy(), rtol=1e-5,
                                       atol=1e-6 * float(f.grad.abs().max()))
    for k, p in head.named_parameters():
        np.testing.assert_allclose(sum(g["params"][k] for g in got).numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6 * float(p.grad.abs().max()), err_msg=k)
