"""Shared cases of the A.2.9a parity tests (``tests/test_torch_backbones_parts.py``,
``tests/test_torch_backbones_detectors.py``): MobileNetV2, RegNetX, Res2Net,
ResNeSt, FPN-CARAFE and FPG.

``BACKBONES`` and ``NECKS`` are the modules cut to test size (8-16
channels): MobileNetV2 at ``widen_factor`` 0.25 (the config's outputs 2, 4
and 6: 8, 24 and 80 channels); RegNet from a 6-deep ``arch`` dict (widths 8,
16, 32, 64; blocks 1, 1, 3, 1; groups of 8 channels); Res2Net at depth 18
(``ARCH[18]``'s 2 blocks a stage), its first two stages (the stride-1 and
stride-2 blocks, both shortcuts; the later stages repeat them wider) with
base and stem width 8 (3x3 chunks of 3 and 6 channels); ResNeSt-50's first
two stages (7 of its 16
blocks: stride-1 and stride-2 blocks, both shortcuts and the avd pool; the
later stages repeat them wider) at base and stem width 8 with
``base_width=64`` (JAX's width rule gives 0 channels at the config's
``base_width=4`` below ``base_channels=16``); FPN-CARAFE and FPG on 4 maps of
8, 16, 32 and 64 channels to 16, FPG at ``stack_times=2``. Each backbone
keeps its config's ``frozen_stages`` and ``norm_eval``.

``tiny_model(name, model)``: a published config's ``model`` (either
package's) narrowed in place for the whole-detector tests: the FPG
Faster R-CNN on ResNet-18 at base width 8, FPG at 16 channels and 1 stack
(``NECKS``' FPG has 2), the RPN and RoI head at 16 channels, 8 classes;
YOLOv3-MobileNetV2 at ``widen_factor`` 0.25 with the neck and head at 16
channels, 8 classes.

The JAX side is never initialized eagerly: ``jax_variables`` takes the
shapes from ``jax.eval_shape`` and fills them with seeded numpy
(``torch_onestage_cases.randomize``: LeCun-normal kernels, small biases,
BN affines and stored statistics near their identity).
"""
import copy
import os.path as osp

import numpy as np

import torch_onestage_cases as oc

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = {
    "mobilenet_v2": "configs/yolo/yolov3_mobilenetv2_mstrain-416_300e_coco.py",
    "regnet": "configs/regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py",
    "res2net": "configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py",
    "resnest": "configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py",
    "carafe": "configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py",
    "fpg": "configs/fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py",
}
NUM_CLASSES = 8
HW = (64, 96)
FPG_HW = (64, 128)          # P5 of 2x4: FPG pools it to an even P6
BACKBONES = {
    "mobilenet_v2": dict(type="MobileNetV2", widen_factor=0.25, out_indices=(2, 4, 6)),
    "regnet": dict(type="RegNet", arch=dict(w0=8, wa=8, wm=2.0, group_w=8, depth=6),
                   frozen_stages=1, norm_eval=True),
    "res2net": dict(type="Res2Net", depth=18, scales=4, base_width=26, base_channels=8,
                    stem_channels=8, frozen_stages=1, norm_eval=True, num_stages=2,
                    out_indices=(0, 1)),
    "resnest": dict(type="ResNeSt", depth=50, radix=2, groups=1, base_width=64,
                    base_channels=8, stem_channels=8, frozen_stages=1, norm_eval=True,
                    num_stages=2, out_indices=(0, 1)),
}
NECK_IN = (8, 16, 32, 64)
NECKS = {
    "carafe": dict(type="FPN_CARAFE", in_channels=list(NECK_IN), out_channels=16, num_outs=5),
    "fpg": dict(type="FPG", in_channels=list(NECK_IN), out_channels=16, inter_channels=16,
                num_outs=5, stack_times=2),
}


def neck_inputs(seed=5, hw=(16, 32)):
    """C2..C5 of ``NECK_IN`` channels at strides 4..32 of a ``hw`` C2 (2
    images, NHWC numpy)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    return [rng.normal(0, 1, (2, -(-h // 2 ** i), -(-w // 2 ** i), c)).astype(np.float32)
            for i, c in enumerate(NECK_IN)]


def jax_module(registry, cfg):
    """A JAX backbone or neck from its config (the registry's class)."""
    cfg = dict(cfg)
    return registry.get(cfg.pop("type"))(**cfg)


def torch_module(registry, cfg):
    from oadg_tpu_torch.utils.registry import build_from_cfg
    return build_from_cfg(copy.deepcopy(cfg), registry, dict(device="cpu"))


def jax_variables(module, *args, seed=2, **kwargs):
    """Seeded numpy variables for ``module.init(key, *args)``, from shapes."""
    import jax
    shapes = jax.eval_shape(lambda r, *a: module.init(r, *a, **kwargs),
                            jax.random.PRNGKey(0), *args)
    return {"params": oc.randomize(shapes["params"], seed),
            "batch_stats": oc.randomize(dict(shapes.get("batch_stats") or {}), seed + 1)}


def tiny_model(name, model):
    """``model`` (a published config's, either package's) narrowed in place."""
    model["backbone"].pop("init_cfg", None)
    if name == "mobilenet_v2":
        model["backbone"].update(widen_factor=0.25)
        model["neck"].update(in_channels=[80, 24, 8], out_channels=[16, 16, 16])
        model["bbox_head"].update(num_classes=NUM_CLASSES, in_channels=[16, 16, 16],
                                  out_channels=[16, 16, 16])
        model["test_cfg"].update(max_per_img=20)
        return model
    model["backbone"].update(depth=18, base_channels=8, stem_channels=8)
    model["neck"].update(in_channels=list(NECK_IN), out_channels=16, inter_channels=16,
                         stack_times=1)
    model["rpn_head"].update(in_channels=16, feat_channels=16)
    rh = model["roi_head"]
    rh["bbox_roi_extractor"].update(out_channels=16)
    rh["bbox_head"].update(in_channels=16, fc_out_channels=32, num_classes=NUM_CLASSES)
    model["train_cfg"]["rpn_proposal"] = dict(nms_pre=64, max_per_img=32,
                                              nms=dict(iou_threshold=0.7), min_bbox_size=0)
    model["train_cfg"]["rpn"]["sampler"]["num"] = 32
    model["train_cfg"]["rcnn"]["sampler"]["num"] = 16
    model["test_cfg"]["rpn"].update(nms_pre=60, max_per_img=30)
    model["test_cfg"]["rcnn"].update(max_per_img=10)
    return model


def jax_model(name):
    from oadg_tpu.config import Config
    cfg = Config.fromfile(osp.join(ROOT, CONFIGS[name]), import_custom_modules=False)
    return tiny_model(name, cfg["model"])


def torch_model(name):
    from oadg_tpu_torch.config import load_config
    return oc._plain(tiny_model(name, load_config(osp.join(ROOT, CONFIGS[name]))["model"]))


def torch_detector_model(name):
    """A config's model (the port's) narrowed: the six's backbones as in
    ``BACKBONES`` (Res2Net and ResNeSt with all four stages) under an FPN,
    FPN-CARAFE (on an R18 of base width 8) or FPG (``tiny_model``'s, with
    ``NECKS``' 2 stacks) of 16 channels, 8 classes; YOLOv3-MobileNetV2 as
    ``tiny_model``."""
    from oadg_tpu_torch.config import load_config
    if name == "fpg":
        model = torch_model(name)
        model["neck"]["stack_times"] = NECKS["fpg"]["stack_times"]
        return model
    if name == "mobilenet_v2":
        return torch_model(name)
    model = load_config(osp.join(ROOT, CONFIGS[name])).model
    model.backbone.pop("init_cfg", None)
    if name == "carafe":
        model.backbone.update(depth=18, base_channels=8, stem_channels=8)
        ins = list(NECK_IN)
    else:
        model.backbone = {k: v for k, v in BACKBONES[name].items()
                          if k not in ("num_stages", "out_indices")}
        ins = list(NECK_IN) if name == "regnet" else [32, 64, 128, 256]
    model.neck.update(in_channels=ins, out_channels=16)
    model.rpn_head.update(in_channels=16, feat_channels=16)
    model.roi_head.bbox_roi_extractor.update(out_channels=16)
    model.roi_head.bbox_head.update(in_channels=16, fc_out_channels=32, num_classes=NUM_CLASSES)
    model.train_cfg.rpn_proposal.update(nms_pre=64, max_per_img=32)
    model.train_cfg.rpn.sampler.num = 32
    model.train_cfg.rcnn.sampler.num = 16
    model.test_cfg.rpn.update(nms_pre=60, max_per_img=30)
    model.test_cfg.rcnn.update(max_per_img=10)
    return oc._plain(model)


def batch(name, seed=4):
    """2 images with 4 seeded gts each (the last of the last image
    padding): 64x96, the FPG detector's 64x128."""
    return oc.batch(seed, n=2, g=4, hw=FPG_HW if name == "fpg" else HW)


def close(got, want, rtol, floor, what=""):
    """``got`` within ``rtol`` of ``want`` plus ``floor`` times ``want``'s
    largest magnitude."""
    want = np.asarray(want)
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max(),
                               err_msg=what)
