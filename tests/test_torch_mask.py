"""Mask R-CNN's modules in the port against the JAX package, on the CPU.

Host masks (``core/mask/structures.py``), ``LoadAnnotations(with_mask=True)``
-> ``RandomFlip`` -> ``StaticBatcher``, and ``paste_masks``: bit-equal to the
JAX package's (numpy on both sides). The datasets: the port's
``CocoDataset`` keeps each box's ``segmentation``; the JAX package's drops it
(ROADMAP C). ``resample_box_to_box`` against the jitted JAX function within
1e-6 (it is bit-equal: the port rounds as XLA compiles it), ``mask_targets``
equal but where the resample sits within 1e-6 of the 0.5 threshold (ties,
counted). ``FCNMaskHead`` with the JAX weights carried over
(``jax_variables_to_state_dict``): float32 logits, loss and gradients within
1e-5 of the largest magnitude; bfloat16 logits within 2**-7 of the largest
(flax's cast points; the convolutions sum in another order). Checkpoints:
an mmdet-layout Mask R-CNN ``.pth`` fills the port's mask head; the JAX
package's ``convert_torch_state_dict`` drops those tensors (ROADMAP C).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oadg_tpu.core.mask import structures as jax_masks
from oadg_tpu.models.roi_heads import mask_heads as jax_heads
from oadg_tpu_torch.core.mask import structures as masks
from oadg_tpu_torch.models.roi_heads import mask_heads as heads

import torch_data_cases as data_cases
import torch_mask_cases as cases

torch.set_num_threads(2)


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _bitmaps(rng, n=4, h=40, w=60):
    m = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        y0, x0 = rng.randint(0, h - 5), rng.randint(0, w - 5)
        m[i, y0:y0 + rng.randint(3, h - y0), x0:x0 + rng.randint(3, w - x0)] = 1
        m[i] &= (rng.rand(h, w) > 0.2).astype(np.uint8)
    m[-1] = 0                                           # an empty instance
    return m


def test_bitmap_masks_equal_jax():
    m = _bitmaps(np.random.RandomState(0))
    got, want = masks.BitmapMasks(m, 40, 60), jax_masks.BitmapMasks(m, 40, 60)
    _same(got.areas, want.areas)
    boxes = np.array([[5.3, 3.6, 40.2, 30.7], [-8, -4, 20, 12], [50, 30, 70, 45],
                      [10, 10, 10.0004, 10.0004]], np.float32)
    for g, w in ((got, want), (got.flip("horizontal"), want.flip("horizontal")),
                 (got.flip("vertical"), want.flip("vertical")),
                 (got.resize((23, 37)), want.resize((23, 37))),
                 (got.rescale(0.5), want.rescale(0.5)),
                 (got.rescale((90, 61)), want.rescale((90, 61))),
                 (got.pad((48, 64)), want.pad((48, 64))),
                 (got.crop([5.4, 3.6, 40.2, 30.7]), want.crop([5.4, 3.6, 40.2, 30.7])),
                 (got[[0, 2]], want[[0, 2]])):
        _same(g.to_ndarray(), w.to_ndarray())
        assert (g.height, g.width) == (w.height, w.width)
        _same(g.get_bboxes(), w.get_bboxes())
    _same(got.to_box_cropped(boxes), want.to_box_cropped(boxes))
    _same(got.to_box_cropped(boxes, m0=28), want.to_box_cropped(boxes, m0=28))
    empty = masks.BitmapMasks([], 40, 60)
    _same(empty.to_box_cropped(np.zeros((0, 4))),
          jax_masks.BitmapMasks([], 40, 60).to_box_cropped(np.zeros((0, 4))))


POLYGONS = [
    [np.array([10, 10, 20, 10, 20, 20, 10, 20], np.float64)],                  # square
    [np.array([3.2, 4.7, 30.5, 6.1, 12.2, 14.9, 28.4, 30.3, 2.9, 25.5])],       # concave
    [np.array([40, 2, 58, 5, 50, 18]), np.array([45.5, 25, 70, 30, 52, 44])],   # two parts
    [np.array([-10, -10, 15, -3, 8, 12])],                                       # off the image
    [np.array([5.0, 5.0, 9.0, 9.0])],                                            # < 3 points
]


def test_polygon_masks_equal_jax():
    got, want = masks.PolygonMasks(POLYGONS, 40, 60), jax_masks.PolygonMasks(POLYGONS, 40, 60)
    for g, w in ((got, want), (got.flip("horizontal"), want.flip("horizontal")),
                 (got.flip("vertical"), want.flip("vertical")),
                 (got.rescale(0.5), want.rescale(0.5)),
                 (got.rescale((90, 61)), want.rescale((90, 61))),
                 (got[[1, 2]], want[[1, 2]]), (got[3], want[3])):
        assert (g.height, g.width, len(g)) == (w.height, w.width, len(w))
        _same(g.to_ndarray(), w.to_ndarray())
    assert got.to_bitmap().areas[:3].min() > 50 and got.to_bitmap().areas[4] == 0


def test_paste_masks_equal_jax():
    rng = np.random.RandomState(1)
    probs = rng.rand(7, 28, 28).astype(np.float32)
    boxes = np.array([[10, 12, 30, 28, 0.9], [-5, -7, 20, 15, 0.8], [40, 30, 90, 70, 0.7],
                      [60, 45, 61, 46, 0.6], [3.4, 5.6, 3.5, 5.7, 0.5], [0, 0, 70, 50, 0.4],
                      [80, 80, 90, 90, 0.3]], np.float32)
    for thr in (0.5, 0.3):
        _same(masks.paste_masks(probs, boxes, 50, 70, thr),
              jax_masks.paste_masks(probs, boxes, 50, 70, thr))


def _results(rng, h=40, w=60):
    """A pipeline's ``results`` after loading an image: 3 polygon instances
    and one uncompressed RLE, their boxes from the instances."""
    segs = [POLYGONS[0], POLYGONS[1], POLYGONS[2],
            cases.rle(rng, 30.5, 11.2, 20.3, 14.8, h, w)]
    boxes = np.array([[10, 10, 20, 20], [2.9, 4.7, 30.5, 30.3], [40, 2, 70, 44],
                      [30.5, 11.2, 50.8, 26.0]], np.float32)
    return {"img": np.zeros((h, w, 3), np.uint8), "img_shape": (h, w, 3),
            "img_info": {"height": h, "width": w}, "img_fields": ["img"],
            "ann_info": dict(bboxes=boxes, labels=np.array([1, 0, 3, 2]), masks=segs)}


def test_load_annotations_flip_and_collate_equal_jax():
    """``LoadAnnotations(with_mask=True)`` (polygons and RLE to box-cropped
    56 x 56 float32), ``RandomFlip`` in both directions (masks flip in their
    crop), and the collate of a sample with masks and one without (G = 8,
    zero-filled) equal the JAX package's bit for bit."""
    from oadg_tpu.data.builder import StaticBatcher as JaxBatcher
    from oadg_tpu.data.pipelines.loading import LoadAnnotations as JaxLoad
    from oadg_tpu.data.pipelines.transforms import RandomFlip as JaxFlip
    from oadg_tpu_torch.data.builder import StaticBatcher
    from oadg_tpu_torch.data.pipelines.loading import LoadAnnotations
    from oadg_tpu_torch.data.pipelines.transforms import RandomFlip
    rng = np.random.RandomState(2)
    base = _results(rng)
    got = LoadAnnotations(with_mask=True)(dict(base))
    want = JaxLoad(with_mask=True)(dict(base))
    _same(got["gt_masks"], want["gt_masks"])
    assert got["gt_masks"].shape == (4, 56, 56) and got["mask_fields"] == ["gt_masks"]
    assert all(got["gt_masks"][i].mean() > 0.3 for i in range(4))
    samples = []
    for direction in ("horizontal", "vertical"):
        g = RandomFlip(flip_ratio=1.0, direction=direction)(dict(got))
        w = JaxFlip(flip_ratio=1.0, direction=direction)(dict(want))
        for k in ("gt_masks", "gt_bboxes", "img"):
            _same(g[k], w[k])
        assert not np.array_equal(g["gt_masks"], got["gt_masks"])
        samples.append((g, w))
    empty = {**_results(rng), "ann_info": dict(bboxes=np.zeros((0, 4), np.float32),
                                               labels=np.zeros(0, np.int64), masks=[])}
    samples.append((LoadAnnotations(with_mask=True)(dict(empty)),
                    JaxLoad(with_mask=True)(dict(empty))))
    for g, w in samples:
        g["img_metas"] = w["img_metas"] = {"img_shape": (40, 60, 3)}
    for order in ([0, 2], [2, 1]):
        bg = StaticBatcher(static_hw=(64, 64), max_gt=8)([samples[i][0] for i in order])
        bw = JaxBatcher(static_hw=(64, 64), max_gt=8)([samples[i][1] for i in order])
        _same(bg["gt_masks"], bw["gt_masks"])
        assert bg["gt_masks"].shape == (2, 8, 56, 56)


def test_load_annotations_refuses_what_it_cannot_draw():
    from oadg_tpu_torch.data.pipelines.loading import LoadAnnotations
    with pytest.raises(NotImplementedError, match="with_seg"):
        LoadAnnotations(with_seg=True)
    res = _results(np.random.RandomState(3))
    res["ann_info"]["masks"][3] = {"counts": "PPYo0", "size": [40, 60]}    # compressed
    with pytest.raises(ValueError, match="compressed RLE"):
        LoadAnnotations(with_mask=True)(res)


def test_coco_dataset_keeps_segmentation_where_jax_drops_it(tmp_path):
    """The port's ``CocoDataset.get_ann_info`` carries each kept box's
    ``segmentation`` as ``masks`` (mmdet's ``_parse_ann_info``), so the
    with-mask pipeline draws every instance; the JAX package's drops it, and
    the same pipeline there gives no mask for any box: a JAX Mask R-CNN
    trained from a COCO json gets all-zero gt masks (ROADMAP C)."""
    from oadg_tpu.config import Config
    from oadg_tpu.data import build_dataset as jax_build
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.data import build_dataset
    ann_file, prefix = cases.write_mask_dataset(str(tmp_path))
    built = []
    for cfg, build in ((load_config(cases.MASK_CONFIG), build_dataset),
                       (Config.fromfile(cases.MASK_CONFIG), jax_build)):
        pipeline = [p for p in cases.with_mask_pipeline(cfg.data.train.dataset.pipeline)
                    if p["type"] in ("LoadImageFromFile", "LoadAnnotations")]
        built.append(build(dict(cfg.data.train.dataset, ann_file=ann_file,
                                img_prefix=prefix, pipeline=pipeline)))
    port, jds = built
    for i in range(len(port)):
        info = port.get_ann_info(i)
        assert "masks" not in jds.get_ann_info(i)
        assert len(info["masks"]) == len(info["bboxes"]) > 0
        got, want = port[i], jds[i]
        _same(got["gt_bboxes"], want["gt_bboxes"])
        h, w = got["img"].shape[:2]
        load = {"img": got["img"], "img_info": {"height": h, "width": w},
                "ann_info": dict(info)}
        from oadg_tpu.data.pipelines.loading import LoadAnnotations as JaxLoad
        _same(got["gt_masks"], JaxLoad(with_mask=True)(load)["gt_masks"])
        assert (got["gt_masks"].reshape(len(info["bboxes"]), -1).max(1) == 1).all()
        assert want["gt_masks"].shape == (0, 56, 56)


def _boxes_and_masks(rng, p=600):
    gt = np.stack([rng.uniform(0, 500, p), rng.uniform(0, 300, p)], 1)
    gt = np.concatenate([gt, gt + rng.uniform(2, 300, (p, 2))], 1).astype(np.float32)
    jit = rng.uniform(-0.3, 0.3, (p, 4)) * np.concatenate([gt[:, 2:] - gt[:, :2]] * 2, 1)
    pb = (gt + jit).astype(np.float32)
    pb[:20] = gt[:20]                                   # the gt itself: aligned grids
    pb[20:30] = [[600, 400, 650, 450]]                  # wholly outside its gt
    gt[30:40, 2:] = gt[30:40, :2]                       # zero-size gt box
    gm = (rng.rand(p, 56, 56) > 0.5).astype(np.float32)
    gm[40:60] = rng.rand(20, 56, 56).astype(np.float32)     # soft masks
    return pb, gt, gm


def test_resample_box_to_box_matches_jitted_jax():
    pb, gt, gm = _boxes_and_masks(np.random.RandomState(4))
    want = np.asarray(jax.jit(jax.vmap(lambda m, s, d: jax_heads.resample_box_to_box(
        m, s, d, 28)))(gm, gt, pb))
    got = heads.resample_box_to_box(torch.from_numpy(gm), torch.from_numpy(gt),
                                    torch.from_numpy(pb), 28).numpy()
    assert got.dtype == np.float32 and got.shape == (600, 28, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[20:30].any() and got[:20].any()


def test_mask_targets_equal_jax_but_for_counted_ties():
    """Binary targets equal the jitted JAX ones at every pixel whose
    resample is not within 1e-6 of 0.5; such ties are counted (a fused
    multiply-add rounding apart could flip one) and none flips here."""
    pb, gt, gm = _boxes_and_masks(np.random.RandomState(5))
    res = np.asarray(jax.jit(jax.vmap(lambda m, s, d: jax_heads.resample_box_to_box(
        m, s, d, 28)))(gm, gt, pb))
    want = np.asarray(jax.jit(lambda a, b, c: jax_heads.mask_targets(a, b, c, 28))(pb, gt, gm))
    got = heads.mask_targets(torch.from_numpy(pb), torch.from_numpy(gt),
                             torch.from_numpy(gm), 28).numpy()
    ties = np.abs(res - 0.5) < 1e-6
    assert set(np.unique(got)) == {0.0, 1.0}
    np.testing.assert_array_equal(got[~ties], want[~ties])
    flipped = int((got[ties] != want[ties]).sum())
    assert ties.sum() > 0 and flipped == 0, (int(ties.sum()), flipped)


def _head_case(dtype=None, r=12, seed=6):
    """The JAX ``FCNMaskHead`` (2 convs of 16 channels, 8 classes) and its
    variables, the port's head with them, (R, 14, 14, 16) features, targets,
    labels (the last two background) and validity."""
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    rng = np.random.RandomState(seed)
    kw = dict(num_convs=2, in_channels=16, conv_out_channels=16, num_classes=8)
    jhead = jax_heads.FCNMaskHead(**kw, dtype=dtype)
    x = rng.randn(r, 14, 14, 16).astype(np.float32)
    variables = jax.jit(jhead.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(np.float32),
        variables["params"])                           # nonzero biases too
    sd = jax_variables_to_state_dict({"params": {"roi": {"mask_head_m": params}}})
    head = heads.FCNMaskHead(**kw, dtype=None if dtype is None else torch.bfloat16)
    head.load_state_dict({k[len("roi_head.mask_head."):]: v for k, v in sd.items()})
    tgt = (rng.rand(r, 28, 28) > 0.5).astype(np.float32)
    labels = rng.randint(0, 8, r).astype(np.int32)
    labels[-2:] = 8
    valid = rng.rand(r) > 0.25
    return jhead, params, head, x, tgt, labels, valid


def _close_to_largest(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def test_fcn_mask_head_forward_loss_and_gradients_match_jax():
    jhead, params, head, x, tgt, labels, valid = _head_case()

    def jloss(p, xx):
        pred = jhead.apply({"params": p}, xx)
        return jhead.loss(pred, jnp.asarray(tgt), jnp.asarray(labels), jnp.asarray(valid))

    pred = np.asarray(jax.jit(lambda p, xx: jhead.apply({"params": p}, xx))(params, x))
    loss, (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, x)
    probs = np.asarray(jax.jit(lambda p, xx: jhead.get_masks(
        jhead.apply({"params": p}, xx), jnp.asarray(labels)))(params, x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = head(tx)
    assert out.shape == (12, 8, 28, 28) and out.dtype == torch.float32
    _close_to_largest(out.detach().permute(0, 2, 3, 1).numpy(), pred, 1e-5, "logits")
    tl = head.loss(out, torch.from_numpy(tgt), torch.from_numpy(labels),
                   torch.from_numpy(valid))
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-5)
    _close_to_largest(head.get_masks(out, torch.from_numpy(labels)).detach().numpy(),
                      probs, 1e-5, "get_masks")
    tl.backward()
    _close_to_largest(tx.grad.permute(0, 2, 3, 1).numpy(), gx, 1e-5, "input gradient")
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    want = jax_variables_to_state_dict({"params": {"roi": {"mask_head_m": jax.tree_util.tree_map(
        np.asarray, gp)}}})
    grads = dict(head.named_parameters())
    assert len(grads) == len(want) == 8
    for k, w in want.items():
        _close_to_largest(grads[k[len("roi_head.mask_head."):]].grad.numpy(), w.numpy(),
                          1e-5, k)


def test_fcn_mask_head_bfloat16_follows_flax_cast_points():
    """A bfloat16 head casts input and kernel of each conv and of the
    transposed conv to bfloat16 and adds the bias in bfloat16; the logits
    are float32. Held to the JAX ``dtype=jnp.bfloat16`` head."""
    jhead, params, head, x, _, labels, _ = _head_case(jnp.bfloat16)
    pred = np.asarray(jax.jit(lambda p, xx: jhead.apply({"params": p}, xx))(params, x))
    out = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    _close_to_largest(out.detach().permute(0, 2, 3, 1).numpy(), pred, 2 ** -7, "bf16 logits")
    f32 = _head_case()[2](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float((out - f32).abs().max()) > 0            # it did compute in bfloat16


def test_upsample_weight_map_flips_the_kernel():
    """flax's ``ConvTranspose`` equals torch's ``conv_transpose2d`` only with
    the kernel flipped in both spatial axes: without the flip the result is
    far off (the map in ``jax_variables_to_state_dict`` flips it)."""
    import flax.linen as nn
    rng = np.random.RandomState(7)
    x = rng.randn(3, 6, 6, 4).astype(np.float32)
    layer = nn.ConvTranspose(5, (2, 2), strides=(2, 2))
    v = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    k = rng.randn(2, 2, 4, 5).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": k, "bias": np.zeros(5, np.float32)}},
                                  x)).transpose(0, 3, 1, 2)
    assert v["params"]["kernel"].shape == k.shape
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    flipped = torch.nn.functional.conv_transpose2d(
        tx, torch.from_numpy(k[::-1, ::-1].transpose(2, 3, 0, 1).copy()), stride=2)
    plain = torch.nn.functional.conv_transpose2d(
        tx, torch.from_numpy(k.transpose(2, 3, 0, 1).copy()), stride=2)
    np.testing.assert_allclose(flipped.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(np.abs(plain.numpy() - want).max()) > 0.5


def _tiny_port_model(seed):
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.config import load_config
    cfg = load_config(cases.MASK_CONFIG)
    cases.tiny_mask_model(cfg["model"])
    return init_detector(cfg, device="cpu", seed=seed).model


def test_mmdet_checkpoint_fills_the_mask_head_where_jax_drops_it(tmp_path):
    """An mmdet-layout Mask R-CNN ``.pth`` (``roi_head.mask_head.convs.{i}.conv``,
    ``upsample``, ``conv_logits``) loads whole into the port's model; the
    JAX package's ``convert_torch_state_dict`` makes no leaf of the mask
    head from it, so a JAX Mask R-CNN keeps its random mask head (ROADMAP C)."""
    from oadg_tpu.utils.checkpoint import convert_torch_state_dict
    from oadg_tpu_torch.utils.checkpoint import load_mmdet_checkpoint
    src = _tiny_port_model(3)
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    mask_keys = sorted(k for k in sd if k.startswith("roi_head.mask_head."))
    assert mask_keys == sorted(
        [f"roi_head.mask_head.convs.{i}.conv.{w}" for i in range(2) for w in ("weight", "bias")]
        + [f"roi_head.mask_head.{m}.{w}" for m in ("upsample", "conv_logits")
           for w in ("weight", "bias")])
    pth = tmp_path / "mask_rcnn.pth"
    torch.save({"meta": {"epoch": 8}, "state_dict": sd}, pth)
    dst = _tiny_port_model(4)
    weight = "roi_head.mask_head.upsample.weight"
    assert not torch.equal(dst.state_dict()[weight], sd[weight])
    report = load_mmdet_checkpoint(dst, str(pth))
    assert set(mask_keys) <= set(report["loaded"]) and not report["missing"]
    assert all(torch.equal(dst.state_dict()[k], sd[k]) for k in sd)
    jax_vars = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, roi_channels=16)
    assert "mask_head_m" not in jax_vars["params"]["roi"]
    assert "head" in jax_vars["params"]["roi"]


def test_cityscapes_mask_config_builds_at_full_width():
    """The config as published (R50-FPN, 8 classes, FCNMaskHead with 4 convs
    of 256 channels, 14x14 mask RoIs, 28x28 targets) builds in the port."""
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.models import build_detector
    cfg = load_config(cases.MASK_CONFIG)
    det = build_detector(dict(cfg["model"]), device="cpu")
    rh = det.roi_head
    assert type(det).__name__ == "MaskRCNN" and rh.mask_size == 28
    assert rh.mask_roi_extractor.output_size == 14 and rh.bbox_roi_extractor.output_size == 7
    assert rh.mask_roi_extractor.sampling_ratio == 2
    assert len(rh.mask_head.convs) == 4 and rh.mask_head.conv_logits.out_channels == 8
    assert rh.mask_head.upsample.weight.shape == (256, 256, 2, 2)
    assert data_cases.CLASSES == cases.CLASSES
