"""The port's DWD path against the JAX package, on the CPU.

The DWD OA-DG config (``configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py``:
a caffe-style R101-DC5 with one stride-16 level, no neck, 15 anchors a cell,
``SingleRoIExtractor`` at one level, the contrastive box head over 7 classes,
OA-Mix ``augmix.all`` of width 1) at a tiny size (``torch_dwd_cases``):

- ``XMLDataset`` / ``VOCDataset`` / ``SdgodDataset`` on the VOC-XML fixture
  of ``tests/test_dwd_e2e.py`` and on a richer one (difficult and unknown
  objects, a box under ``min_size``, an image without objects):
  ``data_infos``, ``get_ann_info`` and ``evaluate`` on the same detections,
  equal; an XML without a ``size`` takes the image file's (mmdet reads the
  image; the JAX package keeps 0 x 0 and divides by zero in train mode);
- the caffe DC5 ResNet, depth 50 and 101 at ``base_channels=8``, from the
  JAX one's variables: features rtol 1e-4 with an absolute floor of 2e-6
  of their largest (the randomized frozen BN compounds over 33 blocks to
  features near 20, and the convolution sums reassociate);
- the plain one-level RoIAlign and its gradient against
  ``oadg_tpu.ops.roi_align.roi_align_multilevel`` and ``jax.grad`` of it
  (rtol 1e-5, atol 1e-6: the same bilinear sums, reassociated);
- the tiny detector (depth 50): ``simple_test`` pieces and detections as
  ``test_torch_slice.py`` holds the flagship; one OA-DG ``forward_train``
  on the batch JAX's ``make_oadg_preprocess`` makes from 2 uint8 images
  on a shared OA-Mix table (its views, ``multilevel_boxes`` and
  ``oamix_boxes``), with JAX's sampling draws: losses rtol 1e-4, every
  trainable gradient rtol 1e-3 with an absolute floor of 1e-5 of its
  largest, frozen parameters (stem, ``layer1``, every BN) without one; the
  port's own preprocess on the same table: boxes equal, augmented views
  against JAX's ``oamix_batch`` one image a call to the composed OA-Mix
  tolerance of ``test_torch_oamix.py``;
- ``tools/torch_test_dwd.py --device cpu`` on two domains written by the
  port's JPEG encoder: the JSON keys JAX's ``tools/test_dwd.py`` writes
  (its ``SdgodDataset.evaluate``'s per domain, ``mean_mAP``);
- ``tools/torch_train.py --device cpu`` for 3 iterations through
  ``RepeatDataset`` times 2 on the DWD train pipeline.
"""
import importlib.util
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dwd_cases as cases
from oadg_tpu.apis.train import _static_hw_from_pipeline as jax_static_hw
from oadg_tpu.engine.optim import frozen_mask as jax_frozen_mask
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.models.backbones.resnet import ResNet as JResNet
from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
from oadg_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align
from oadg_tpu.utils.registry import DATASETS as JAX_DATASETS
from oadg_tpu.utils.registry import build_from_cfg as jax_build_from_cfg
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.data import build_dataset, static_hw_from_pipeline
from oadg_tpu_torch.engine.preprocess import make_oadg_preprocess
from oadg_tpu_torch.models.backbones.resnet import ResNet
from oadg_tpu_torch.ops.oamix_device import MAX_FG
from oadg_tpu_torch.ops.roi_align import (roi_align_multilevel_ref,
                                          roi_align_multilevel_ref_backward)
from oadg_tpu_torch.utils.checkpoint import _torch_key, jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws
from test_dwd_e2e import _write_domain
from test_torch_modules import _load_port, _randomize_bn
from test_torch_oamix import (_check_view, _jax_preprocess, _raw_batch, _run_both, _stack,
                              _table, _torch_raw_batch, jax_production_path)  # noqa: F401
from test_torch_slice import FEAT_TOL, _jax_pieces, _port_pieces
from test_torch_slice import _randomize as _randomize_serving
from test_torch_train_step import KEYS, _jax_draws, _randomize

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
LOSS_KEYS = ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox", "loss_cont"]


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_plain(v) for v in o)
    return o


def _cv2_jpeg(path, img):
    cv2.imwrite(path, img)


def _tiny_model(depth=50):
    return cases.tiny_dwd_model(_plain(load_config(cases.DWD).model), depth)


# ------------------------------------------------------------- datasets ----

@pytest.fixture(scope="module", params=["e2e", "rich"])
def domain(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"voc_{request.param}")
    if request.param == "e2e":
        prefix = str(_write_domain(root, "daytime_clear")) + "/"
    else:
        prefix = cases.write_voc_domain(str(root), "night_rainy", _cv2_jpeg, seed=3)
    return prefix, cases.ann_file(prefix)


def _detections(dataset, seed):
    """Per image per class (n, 5): every gt (ignored ones too) jittered by
    up to 4 px with a seeded score, and one seeded false positive."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        per = [np.zeros((0, 5), np.float32) for _ in dataset.CLASSES]
        boxes = np.concatenate([ann["bboxes"], ann["bboxes_ignore"]])
        labels = np.concatenate([ann["labels"], ann["labels_ignore"]])
        for box, lab in zip(boxes, labels):
            det = np.r_[box + rng.uniform(-4, 4, 4), rng.uniform(0.1, 1)].astype(np.float32)
            per[int(lab)] = np.concatenate([per[int(lab)], det[None]])
        fp = np.r_[rng.uniform(0, 40, 2), rng.uniform(50, 90, 2), rng.uniform()]
        c = rng.randint(len(per))
        per[c] = np.concatenate([per[c], fp[None].astype(np.float32)])
        out.append(per)
    return out


@pytest.mark.parametrize("kind", ["SdgodDataset", "VOCDataset"])
@pytest.mark.parametrize("test_mode,min_size", [(True, None), (False, None), (False, 5)])
def test_xml_datasets_match_jax(domain, kind, test_mode, min_size):
    prefix, ann = domain
    cfg = dict(type=kind, ann_file=ann, img_prefix=prefix, pipeline=[],
               test_mode=test_mode, min_size=min_size)
    want = jax_build_from_cfg(dict(cfg), JAX_DATASETS)
    got = build_dataset(dict(cfg))
    assert type(got).__name__ == kind and got.CLASSES == want.CLASSES
    assert got.data_infos == want.data_infos and len(got) >= 1
    if not test_mode:
        np.testing.assert_array_equal(got.flag, want.flag)
    n_ignored = 0
    for i in range(len(got)):
        g, w = got.get_ann_info(i), want.get_ann_info(i)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        n_ignored += len(g["bboxes_ignore"])
    if kind == "SdgodDataset" and domain[0].count("night_rainy"):
        assert n_ignored >= 3 + (min_size is not None)
    for seed in (0, 1):
        dets = _detections(got, seed)
        assert got.evaluate(dets) == want.evaluate(dets)


def test_xml_without_size_takes_the_image_header(tmp_path):
    prefix = cases.write_voc_domain(str(tmp_path), "dusk_rainy", _cv2_jpeg, seed=4,
                                    sizeless=(2, 3))
    cfg = dict(type="SdgodDataset", ann_file=cases.ann_file(prefix), img_prefix=prefix,
               pipeline=[])
    want = jax_build_from_cfg(dict(cfg, test_mode=True), JAX_DATASETS)
    got = build_dataset(dict(cfg, test_mode=True))
    for i, (h, w) in enumerate(cases.SIZES):
        assert (got.data_infos[i]["height"], got.data_infos[i]["width"]) == (h, w)
        if i in (2, 3):
            assert (want.data_infos[i]["height"], want.data_infos[i]["width"]) == (0, 0)
        else:
            assert got.data_infos[i] == want.data_infos[i]
    with pytest.raises(ZeroDivisionError):
        jax_build_from_cfg(dict(cfg), JAX_DATASETS)
    train = build_dataset(dict(cfg))
    assert len(train) == 3 and list(train.flag) == [1, 1, 1]


def test_sdgod_ground_truth_scores_map_one(domain):
    prefix, ann = domain
    ds = build_dataset(dict(type="SdgodDataset", ann_file=ann, img_prefix=prefix,
                            pipeline=[], test_mode=True))
    perfect = []
    for i in range(len(ds)):
        a = ds.get_ann_info(i)
        per = [np.zeros((0, 5), np.float32) for _ in ds.CLASSES]
        for box, lab in zip(a["bboxes"], a["labels"]):
            per[int(lab)] = np.concatenate([per[int(lab)], np.r_[box, 0.9][None]]
                                           ).astype(np.float32)
        perfect.append(per)
    m = ds.evaluate(perfect)
    assert m["mAP"] == 1.0
    assert set(m) == {"mAP"} | {f"AP_{c}" for c in cases.SDGOD_CLASSES}


def test_dwd_train_canvas_matches_jax():
    """``Resize`` over (1280, 600) and (1280, 720) in range mode: the
    static canvas is 736x1280 in both packages."""
    pipeline = _plain(load_config(cases.DWD).data.train.dataset.pipeline)
    assert static_hw_from_pipeline(pipeline) == jax_static_hw(pipeline) == (736, 1280)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dwd_resize_range_mode_matches_jax(seed):
    """The DWD train pipeline's ``Resize`` (range mode over (1280, 600) and
    (1280, 720), keep_ratio) on a uint8 image: the same drawn scale from
    numpy's generator, the same pixels, scale factor and boxes as JAX's."""
    from oadg_tpu.data.pipelines.transforms import Resize as JResize
    from oadg_tpu_torch.data.pipelines.transforms import Resize
    cfg = next(p for p in _plain(load_config(cases.DWD).data.train.dataset.pipeline)
               if p["type"] == "Resize")
    kw = {k: v for k, v in cfg.items() if k != "type"}
    rng = np.random.RandomState(seed)
    img = cases.textured_image(rng, 90, 160)
    boxes = np.array([[5, 6, 80, 60], [100, 20, 159, 89]], np.float32)

    def run(op):
        np.random.seed(seed)
        return op(dict(img=img.copy(), img_fields=["img"], bbox_fields=["gt_bboxes"],
                       gt_bboxes=boxes.copy()))

    want, got = run(JResize(**kw)), run(Resize(**kw))
    assert got["scale"] == want["scale"] and 600 <= min(got["scale"]) <= 720
    assert got["img"].dtype == np.uint8 and got["img"].shape == want["img"].shape
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["scale_factor"], want["scale_factor"])
    np.testing.assert_array_equal(got["gt_bboxes"], want["gt_bboxes"])


# ------------------------------------------------------------- backbone ----

@pytest.mark.parametrize("depth", [50, 101])
def test_caffe_dc5_resnet_matches_jax(depth):
    bb = _plain(load_config(cases.DWD).model["backbone"])
    kw = {k: bb[k] for k in ("num_stages", "strides", "dilations", "out_indices",
                             "frozen_stages", "norm_cfg", "norm_eval", "style")}
    kw.update(depth=depth, base_channels=8, stem_channels=8)
    x = np.random.RandomState(depth).normal(0, 1, (2, H, W, 3)).astype(np.float32)
    jnet = JResNet(**kw)
    jv = _randomize_bn(jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.asarray(x)), depth)
    want = jax.jit(jnet.apply)(jv, jnp.asarray(x))
    port = _load_port(ResNet(**kw), jv, "backbone_m", "backbone.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 1 and got[0].shape == (2, 256, H // 16, W // 16)
    want = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 3, 1), want, rtol=1e-4,
                               atol=2e-6 * np.abs(want).max())


def test_caffe_dc5_resnet_layout():
    """Caffe style strides the first 1x1; ``layer4`` keeps stride 1 with a
    downsample 1x1 for its channels and dilates its 3x3s by 2, padded by 2;
    every BN is frozen without gradients."""
    bb = dict(_plain(load_config(cases.DWD).model["backbone"]), base_channels=8,
              stem_channels=8)
    bb.pop("type")
    net = ResNet(**bb)
    assert net.layer2[0].conv1.stride == (2, 2) and net.layer2[0].conv2.stride == (1, 1)
    l4 = net.layer4[0]
    assert l4.conv1.stride == (1, 1) and l4.downsample[0].stride == (1, 1)
    assert all(b.conv2.dilation == (2, 2) and b.conv2.padding == (2, 2) for b in net.layer4)
    assert not any(p.requires_grad for n, p in net.named_parameters() if ".bn" in n
                   or n.startswith(("bn1", "conv1", "layer1")) or "downsample.1" in n)
    pytorch = ResNet(depth=50, base_channels=8, stem_channels=8)
    assert pytorch.layer2[0].conv1.stride == (1, 1) and pytorch.layer2[0].conv2.stride == (2, 2)


# ------------------------------------------------------------- RoIAlign ----

def test_one_level_roi_align_matches_jax():
    rng = np.random.RandomState(4)
    fmap = rng.normal(0, 1, (2, 23, 37, 32)).astype(np.float32)
    r = 40
    x1 = rng.uniform(-40, 560, r)
    y1 = rng.uniform(-40, 340, r)
    rois = np.stack([rng.randint(0, 2, r), x1, y1, x1 + rng.uniform(1, 400, r),
                     y1 + rng.uniform(1, 250, r)], 1).astype(np.float32)
    dy = rng.normal(0, 1, (r, 7, 7, 32)).astype(np.float32)
    kw = dict(output_size=7, featmap_strides=(16,), sampling_ratio=2, finest_scale=56)

    def f(m):
        return jax_roi_align([m], jnp.asarray(rois), **kw)

    want = np.asarray(jax.jit(f)(jnp.asarray(fmap)))
    want_grad = np.asarray(jax.jit(jax.grad(lambda m: jnp.sum(f(m) * dy)))(jnp.asarray(fmap)))
    t = torch.from_numpy(fmap).permute(0, 3, 1, 2)
    got = roi_align_multilevel_ref([t], torch.from_numpy(rois), **kw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)
    (grad,) = roi_align_multilevel_ref_backward(
        torch.from_numpy(dy).permute(0, 3, 1, 2).contiguous(), [t.shape],
        torch.from_numpy(rois), **kw)
    np.testing.assert_allclose(grad.permute(0, 2, 3, 1).numpy(), want_grad,
                               rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 0.5 and np.abs(want_grad).max() > 0.5


# ------------------------------------------------------------- detector ----

@pytest.fixture(scope="module")
def serving():
    model = _tiny_model()
    rng = np.random.RandomState(0)
    batch = {"img": rng.normal(0, 1, (2, H, W, 3)).astype(np.float32),
             "img_shape": np.array([[H, W], [56, 80]], np.float32),
             "scale_factor": np.array([[1] * 4, [1.25] * 4], np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jdet = jax_build_detector(model, num_views=1)
    variables = _randomize_serving(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, jbatch))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jdet.apply(v, b, method=_jax_pieces))(variables, jbatch))
    det = init_detector({"model": model}, device="cpu").model
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    return want, _port_pieces(det, tbatch)


def test_simple_test_matches_jax(serving):
    want, got = serving
    nhwc = lambda t: t.numpy().transpose(0, 2, 3, 1)       # noqa: E731
    assert len(got["feats"]) == 1 and got["feats"][0].shape == (2, 256, H // 16, W // 16)
    for key in ("feats", "cls_scores", "bbox_preds"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), w, **FEAT_TOL)
    assert got["cls_scores"][0].shape[1] == 15
    np.testing.assert_array_equal(got["prop_valid"].numpy(), want["prop_valid"])
    np.testing.assert_allclose(got["proposals"].numpy(), want["proposals"], rtol=0, atol=1e-3)
    assert got["roi_feats"].shape == (60, 256, 7, 7)
    np.testing.assert_allclose(nhwc(got["roi_feats"]), want["roi_feats"], **FEAT_TOL)
    for key in ("cls_score", "bbox_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=2e-6 * np.abs(want[key]).max())
    np.testing.assert_array_equal(got["det_valid"].numpy(), want["det_valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["dets"].numpy(), want["dets"], rtol=0, atol=1e-3)
    assert int(got["det_valid"].sum()) >= 5 and got["labels"].max() < 7


def _width_one(t):
    """A draw table of ``_table``'s reduced to one AugMix chain
    (``mixture_width=1``)."""
    t = dict(t)
    for k in ("depth", "op_idx", "op_level", "op_sign", "op_coin"):
        t[k] = t[k][:1]
    t["ws"] = np.ones(1, np.float32)
    return t


@pytest.fixture(scope="module")
def train_run():
    cfg = load_config(cases.DWD)
    oamix_cfg = dict(_plain(cfg["oamix_config"]), score_thresh=10)
    oamix_cfg.pop("type")
    assert (oamix_cfg["version"], oamix_cfg["mixture_width"]) == ("augmix.all", 1)
    model = _tiny_model()
    images, gts, labels = _raw_batch(50, H, W)
    labels = labels % 7
    tables = [_width_one(_table(50 + i, "augmix.all", h=H, w=W)) for i in range(2)]
    pre_batch = _jax_preprocess(images, gts, labels, tables, oamix_cfg, cfg["img_norm_cfg"])
    got_pre = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"])(
        _torch_raw_batch(images, gts, labels), torch.Generator(), draws=_stack(tables))
    want_oamix, _ = _run_both(tables, images, gts, oamix_cfg)

    jbatch = {k: jnp.asarray(v) for k, v in pre_batch.items()}
    jdet = jax_build_detector(model, num_views=2)
    variables = _randomize(jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        {"img": jbatch["img"], "img_shape": jbatch["img_shape"]}))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return KEYS[(len(calls) - 1) % 3]

    def loss_fn(params, batch_stats, b):
        losses = jdet.apply({"params": params, "batch_stats": batch_stats}, b, "train")
        return sum(v for k, v in losses.items() if "loss" in k), losses

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"], jbatch)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 3

    det = init_detector({"model": model}, device="cpu", num_views=2).model
    det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in pre_batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 3, 1, 2).contiguous()
    rp = model["train_cfg"]["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=_jax_draws(15 * (H // 16) * (W // 16), MAX_FG + rp, 10))
    losses = det.forward_train(tbatch, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=256)
    return dict(jlosses=jlosses, losses=losses, det=det, want_grads=want_grads,
                pre_batch=pre_batch, got_pre=got_pre, want_oamix=want_oamix,
                jparams=variables["params"])


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_forward_train_loss_matches_jax(train_run, key):
    want = float(train_run["jlosses"][key])
    got = float(train_run["losses"][key].detach())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if key == "loss_cont":
        assert got > 0


def test_forward_train_gradients_match_jax(train_run):
    det, want = train_run["det"], train_run["want_grads"]
    trainable = [(k, p) for k, p in det.named_parameters() if p.requires_grad]
    # layer2-4: 13 blocks of 3 convs and 3 downsample convs; RPN 3 convs,
    # box head 2 shared FCs, fc_cls, fc_reg, 2 fc_cont: weight and bias each
    assert len(trainable) == 13 * 3 + 3 + 3 * 2 + 6 * 2
    for name, p in trainable:
        w = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=name)
        assert np.abs(w).max() > 0, name
    for name, p in det.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            if name.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1.")):
                assert not np.any(want[name].numpy()), name      # JAX: stop_gradient


def test_frozen_parameters_match_the_jax_optimizer_mask(train_run):
    """The stem, ``layer1`` and every backbone BN (``norm_cfg.requires_grad
    =False``) are frozen in the port as mmdet freezes them; the JAX
    package's ``frozen_mask`` agrees but on the downsample BNs of layers
    2-4, which it leaves trainable (it matches ``FrozenBN`` scopes, and
    those are named ``downsample_bn``; ROADMAP C)."""
    flat = jax.tree_util.tree_flatten_with_path(
        jax_frozen_mask(train_run["jparams"], _tiny_model()))[0]
    frozen = {_torch_key(tuple(str(getattr(k, "key", k)) for k in path)): bool(m)
              for path, m in flat}
    differ = sorted(k for k, p in train_run["det"].named_parameters()
                    if frozen[k] == p.requires_grad)
    assert differ == [f"backbone.layer{i}.0.downsample.1.{leaf}"
                      for i in (2, 3, 4) for leaf in ("bias", "weight")]


def test_preprocess_on_the_dwd_table_matches_jax(train_run):
    """augmix.all at width 1 with the original kept as view 1: the port's
    preprocess, its own OA-Mix included, on the shared table. Its boxes and
    clean views against JAX's preprocess; its augmented views against JAX's
    ``oamix_batch`` run one image a call (XLA compiles the batch-of-2 chain
    of JAX's preprocess with other roundings: 97.6% of its pixels agree
    with the one-image runs here), to the tolerance of
    ``test_torch_oamix.py``."""
    want, got, oamix = train_run["pre_batch"], train_run["got_pre"], train_run["want_oamix"]
    assert set(got) == set(want)
    for k in want:
        if k != "img":
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    img = got["img"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(img[:2], want["img"][:2], rtol=0, atol=1e-5)
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    mean = np.asarray([123.675, 116.28, 103.53], np.float32)
    for i in (0, 1):
        raw = np.rint(img[2 + i] * std + mean)[..., ::-1]
        _check_view(torch.from_numpy(raw.astype(np.uint8)), oamix["aug"][i, 0])
    assert want["multilevel_valid"].any() and want["oamix_valid"].any()


# ------------------------------------------------------------- the tools ----

def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dwd_cfg(tmp_path_factory):
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    root = tmp_path_factory.mktemp("dwd")
    cfg = cases.tiny_dwd_cfg(root, imwrite)
    path = str(root / "tiny_dwd.py")
    cfg.dump(path)
    return cfg, path, root


def test_test_dwd_tool_on_the_cpu(dwd_cfg):
    from oadg_tpu.data.datasets.xml_style import SdgodDataset as JSdgod
    cfg, path, root = dwd_cfg
    out = root / "out"
    out.mkdir()
    summary = _tool("torch_test_dwd").main([path, "none", "--device", "cpu",
                                            "--out-dir", str(out)])
    dumped = json.loads((out / "dwd_results.json").read_text())
    assert dumped == json.loads(json.dumps(summary))
    domains = [d["domain"] for d in cfg["data"]["test"]]
    assert list(dumped) == domains + ["mean_mAP"]
    first = cfg["data"]["test"][0]
    jds = JSdgod(ann_file=first["ann_file"], img_prefix=first["img_prefix"], pipeline=[],
                 test_mode=True)
    keys = set(jds.evaluate([[np.zeros((0, 5), np.float32)] * 7] * len(jds)))
    for d in domains:
        assert set(dumped[d]) == keys
    assert dumped["mean_mAP"] == pytest.approx(np.mean([dumped[d]["mAP"] for d in domains]))


def test_torch_train_takes_three_dwd_iterations(dwd_cfg, tmp_path):
    cfg, path, _ = dwd_cfg
    """One epoch: the train split's 3 images with objects (the empty one
    filtered out), repeated twice, in batches of 2."""
    runner = _tool("torch_train").main([
        path, "--device", "cpu", "--work-dir", str(tmp_path), "--seed", "0",
        "--no-validate"])
    assert runner.iter == 3 and runner.epoch == 1
    dataset = runner.loader.dataset
    assert type(dataset).__name__ == "RepeatDataset" and dataset.times == 2
    assert len(dataset) == 6 and type(dataset.dataset).__name__ == "SdgodDataset"
    lines = [json.loads(x) for x in open(tmp_path / "log.json") if '"train"' in x]
    assert len(lines) == 3
    for line in lines:
        assert all(np.isfinite(line[k]) for k in LOSS_KEYS)
