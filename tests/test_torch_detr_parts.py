"""The parts of DETR, Deformable DETR and PanopticFPN in the port against the
JAX package, on the CPU: the sine positions, flax's attention, the
multi-scale deformable attention, ChannelMapper, the panoptic fusion, PQ,
the panoptic loader and dataset, the semantic target's resize; then the
tiny PanopticFPN whole (``torch_detr_cases.tiny_model``: R18-FPN at 16
channels, mmdet's 14x14 mask RoI layer, 6 stuff classes) with the JAX
sampling keys' uniforms, and the two refusals of its config and outputs.

Tolerances: the sine map, the fusion, PQ and the loader bit for bit; the
attentions and ChannelMapper within 1e-5 of each output's largest
magnitude, their gradients within 1e-5 of each one's largest; PanopticFPN's
losses rtol 1e-5, the gradient of its every trainable parameter (backbone
stages 2-4, neck, RPN, RoI heads, semantic head) within 1e-4 of each
leaf's largest, its served boxes within 1e-4 of the largest coordinate and the
stuff probabilities within 1e-5.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_detr_cases as cases

torch.set_num_threads(2)


def _rng_tree(tree, rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda x: (rng.normal(0, scale / np.sqrt(max(x.shape[0], 1)), x.shape)
                   .astype(np.float32)), tree)


def _value_and_vjp(fn, cot, *args):
    """``fn(*args)`` and the gradients of ``sum(fn(*args) * cot)`` w.r.t.
    every argument, in one jit."""
    def run(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(run)(*args)


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------- transformer ----

@pytest.mark.parametrize("hw", [(2, 3), (13, 21)])
def test_sine_positional_encoding_is_jax_bit_for_bit(hw):
    from oadg_tpu.models.utils.transformer import SinePositionalEncoding as JaxSine
    from oadg_tpu_torch.models.utils.transformer import SinePositionalEncoding
    want = np.asarray(JaxSine(8)(*hw))
    got = SinePositionalEncoding(8)(*hw, "cpu")
    assert got.shape == (*hw, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _flax_attention_to_torch(p, mod):
    c = p["query"]["kernel"].shape[0]
    with torch.no_grad():
        mod.in_proj_weight.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(p[k]["kernel"]).reshape(c, -1).T for k in ("query", "key", "value")])))
        mod.in_proj_bias.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(p[k]["bias"]).reshape(-1) for k in ("query", "key", "value")])))
        mod.out_proj.weight.copy_(torch.from_numpy(np.asarray(p["out"]["kernel"]).reshape(-1, c).T))
        mod.out_proj.bias.copy_(torch.from_numpy(np.asarray(p["out"]["bias"])))


def test_attention_is_flax_multi_head_dot_product_attention():
    """Query, key and value of their own (DETR's cross-attention: 7 queries
    over 11 keys), 2 heads of 8: outputs and the gradients of the three
    inputs and of every parameter."""
    import flax.linen as fnn
    from oadg_tpu_torch.models.utils.transformer import MultiheadAttention
    rng = np.random.RandomState(0)
    q, k, v = (rng.normal(0, 1, (2, n, 16)).astype(np.float32) for n in (7, 11, 11))
    cot = rng.normal(0, 1, (2, 7, 16)).astype(np.float32)
    jmod = fnn.MultiHeadDotProductAttention(num_heads=2)
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), q, k, v)
    params = _rng_tree(shapes["params"], rng, 2.0)
    out, (gp, gq, gk, gv) = _value_and_vjp(lambda p, *a: jmod.apply({"params": p}, *a), cot,
                                           params, q, k, v)
    mod = MultiheadAttention(16, 2)
    _flax_attention_to_torch(params, mod)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = mod(tq, tk, tv)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, out, 1e-5, "out")
    for t, g, what in ((tq, gq, "q"), (tk, gk, "k"), (tv, gv, "v")):
        _close(t.grad, g, 1e-5, what)
    mine = MultiheadAttention(16, 2)
    _flax_attention_to_torch(gp, mine)
    _close(mod.in_proj_weight.grad, mine.in_proj_weight.detach(), 1e-5, "in_proj_weight")
    _close(mod.in_proj_bias.grad, mine.in_proj_bias.detach(), 1e-5, "in_proj_bias")
    _close(mod.out_proj.weight.grad, mine.out_proj.weight.detach(), 1e-5, "out_proj")


SHAPES = ((6, 9), (3, 5), (2, 3))


def test_msdeform_attention_matches_jax_at_random_offsets():
    """2 heads, 3 levels (6x9, 3x5, 2x3), 4 points, 7 queries at seeded
    reference points; the offsets' bias drawn wide, so that ~40% of the
    samples fall outside their level (each corner outside reads 0): the
    output and the gradients of the query, the value maps, the reference
    points and every parameter."""
    from oadg_tpu.models.dense_heads.deformable_detr_head import MSDeformAttention as JaxMSDA
    from oadg_tpu_torch.models.dense_heads.deformable_detr_head import MSDeformAttention
    rng = np.random.RandomState(1)
    b, q, c = 2, 7, 16
    query = rng.normal(0, 1, (b, q, c)).astype(np.float32)
    ref = rng.uniform(0, 1, (b, q, 2)).astype(np.float32)
    values = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in SHAPES]
    cot = rng.normal(0, 1, (b, q, c)).astype(np.float32)
    jmod = JaxMSDA(c, 2, 3, 4)
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), query, ref, values)
    params = _rng_tree(shapes["params"], rng)
    params["sampling_offsets"]["bias"] = rng.normal(0, 4, params["sampling_offsets"]["bias"].shape
                                                    ).astype(np.float32)
    out, grads = _value_and_vjp(lambda p, *a: jmod.apply({"params": p}, *a), cot,
                                params, query, ref, values)
    mod = MSDeformAttention(c, 2, 3, 4)
    sd = {}
    for name, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        scope, kind = name[0].key, name[1].key
        scope = f"value_proj.{scope[-1]}" if scope.startswith("value_proj") else scope
        sd[f"{scope}.{'weight' if kind == 'kernel' else 'bias'}"] = torch.from_numpy(
            np.asarray(leaf).T if kind == "kernel" else np.asarray(leaf))
    mod.load_state_dict(sd, strict=True)
    tq = torch.from_numpy(query).requires_grad_(True)
    tr = torch.from_numpy(ref).requires_grad_(True)
    tv = [torch.from_numpy(v).requires_grad_(True) for v in values]
    tokens = torch.cat([v.reshape(b, -1, c) for v in tv], 1)
    got = mod(tq, tr, tokens, SHAPES)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, out, 1e-5, "out")
    _close(tq.grad, grads[1], 1e-5, "query")
    _close(tr.grad, grads[2], 1e-5, "ref")
    for li, t in enumerate(tv):
        _close(t.grad, grads[3][li], 1e-5, f"value {li}")
    for name, leaf in jax.tree_util.tree_flatten_with_path(grads[0])[0]:
        scope, kind = name[0].key, name[1].key
        scope = f"value_proj.{scope[-1]}" if scope.startswith("value_proj") else scope
        p = dict(mod.named_parameters())[f"{scope}.{'weight' if kind == 'kernel' else 'bias'}"]
        _close(p.grad.T if kind == "kernel" else p.grad, leaf, 1e-5, f"{scope} {kind}")
    # the share of samples outside their level, and taps that read zeros
    off = (query @ params["sampling_offsets"]["kernel"] + params["sampling_offsets"]["bias"]
           ).reshape(b, q, 2, 3, 4, 2)
    outside = []
    for li, (h, w) in enumerate(SHAPES):
        sx = ref[..., None, None, 0] * w + off[:, :, :, li, :, 0] * w / 8
        sy = ref[..., None, None, 1] * h + off[:, :, :, li, :, 1] * h / 8
        outside.append((sx < 0) | (sx > w) | (sy < 0) | (sy > h))
    share = np.mean(np.concatenate([o.ravel() for o in outside]))
    assert 0.2 < share < 0.7, share


def test_channel_mapper_matches_jax():
    """One 3x3 conv per input, no norm and no activation, as many outputs as
    inputs (``num_outs`` is dropped: the config's 4 gives 3)."""
    from oadg_tpu.models.necks.fpn import ChannelMapper as JaxChannelMapper
    from oadg_tpu_torch.models.necks.fpn import ChannelMapper
    rng = np.random.RandomState(2)
    xs = [rng.normal(0, 1, (2, s, s + 2, c)).astype(np.float32)
          for s, c in ((8, 16), (4, 32), (2, 64))]
    jmod = JaxChannelMapper(in_channels=(16, 32, 64), out_channels=16)
    params = _rng_tree(jax.eval_shape(lambda x: jmod.init(jax.random.PRNGKey(0), x), xs)["params"],
                       rng)
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, xs)
    mod = ChannelMapper((16, 32, 64), 16, num_outs=4)
    with torch.no_grad():
        for i, conv in enumerate(mod.convs):
            p = params[f"conv_{i}"]["conv"]["Conv_0"]
            conv.conv.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
            conv.conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        got = mod([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, 1e-5)


# --------------------------------------------------------------- panoptic ----

def test_heuristic_fuse_panoptic_is_jax_bit_for_bit():
    """Seeded detections (two at score 0, overlapping masks so that some
    keep too little of themselves) and stuff probabilities; one stuff class
    below the area limit."""
    from oadg_tpu.models.detectors.panoptic import heuristic_fuse_panoptic as jax_fuse
    from oadg_tpu_torch.models.detectors import heuristic_fuse_panoptic
    rng = np.random.RandomState(3)
    h, w, d = 48, 64, 9
    dets = np.concatenate([rng.uniform(0, 40, (d, 4)), rng.uniform(0, 1, (d, 1))], 1)
    dets[[2, 5], 4] = 0.0
    masks = np.zeros((d, h, w), bool)
    for i in range(d):
        y, x = rng.randint(0, h - 16), rng.randint(0, w - 16)
        masks[i, y:y + rng.randint(6, 24), x:x + rng.randint(6, 24)] = True
    probs = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    probs[..., 3] *= 0.3
    labels = rng.randint(0, 8, d)
    for kw in ({}, dict(overlap_thr=0.8, stuff_area_limit=300)):
        want = jax_fuse(dets, labels, masks, probs, 8, **kw)
        got = heuristic_fuse_panoptic(dets, labels, masks, probs, 8, **kw)
        assert got.dtype == want.dtype and (got >= 0).any() and (got == -1).any()
        np.testing.assert_array_equal(got, want)


def _segments(rng, ids, cats, crowd=()):
    return [dict(id=int(i), category_id=int(c), iscrowd=int(i in crowd))
            for i, c in zip(ids, cats)]


def test_pq_compute_is_jax_bit_for_bit(tmp_path):
    """Three images of seeded block maps: predictions that match, miss,
    split, fall on void or on a crowd region; the gt of the last image read
    from a PNG (the JAX package through ``cv2``, the port through its own
    decoder)."""
    import cv2
    from oadg_tpu.core.evaluation import panoptic_eval as jax_pq
    from oadg_tpu_torch.core.evaluation import panoptic_eval as pq
    rng = np.random.RandomState(4)
    cats = {1: dict(isthing=1), 2: dict(isthing=1), 7: dict(isthing=0), 9: dict(isthing=0)}
    gts, preds = [], []
    for i in range(3):
        gt = rng.choice([0, 3, 4, 5, 6], (6, 8)).repeat(4, 0).repeat(4, 1)
        pred = np.where(rng.uniform(0, 1, gt.shape) < 0.8, gt + 10, rng.choice([13, 14, 17], gt.shape))
        pred[:4] = 0
        gcat = rng.choice(list(cats), 4)
        pcat = np.where(rng.uniform(0, 1, 4) < 0.8, gcat, rng.choice(list(cats), 4))
        gseg = _segments(rng, (3, 4, 5, 6), gcat, crowd=(6,))
        pseg = _segments(rng, (13, 14, 15, 16), pcat) + [dict(id=17, category_id=int(gcat[3]))]
        if i == 2:
            path = str(tmp_path / "gt.png")
            cv2.imwrite(path, jax_pq.id2rgb(gt)[..., ::-1])
            gts.append(dict(seg_path=path, segments_info=gseg))
        else:
            gts.append(dict(seg_map=gt, segments_info=gseg))
        preds.append((pred, pseg))
        np.testing.assert_array_equal(pq.id2rgb(gt), jax_pq.id2rgb(gt))
        np.testing.assert_array_equal(pq.rgb2id(pq.id2rgb(gt)), gt)
        assert pq.pq_single(gt, gseg, pred, pseg, cats) == jax_pq.pq_single(gt, gseg, pred,
                                                                             pseg, cats)
    want = jax_pq.pq_compute(gts, preds, cats)
    got = pq.pq_compute(gts, preds, cats)
    assert got == want and 0 < got[0] < 100


def _panoptic_fixture(root):
    """``tests/test_more_datasets.py:85``'s fixture, two images (PNG, so both
    packages decode them): a thing and a stuff segment each, a second thing
    on the second image, a void area, one crowd thing."""
    import cv2
    from oadg_tpu.core.evaluation.panoptic_eval import id2rgb
    h, w = 48, 64
    (root / "imgs").mkdir()
    (root / "pan").mkdir()
    rng = np.random.RandomState(5)
    images, anns, maps = [], [], []
    for i in range(2):
        cv2.imwrite(str(root / "imgs" / f"img{i}.png"),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
        id_map = np.zeros((h, w), np.uint32)
        id_map[5:20, 5:25] = 17
        id_map[25:45, 5:60] = 31
        segs = [dict(id=17, category_id=1, bbox=[5, 5, 20, 15], iscrowd=0),
                dict(id=31, category_id=100, bbox=[5, 25, 55, 20], iscrowd=0)]
        if i == 1:
            id_map[2:12, 40:62] = 70000
            segs.append(dict(id=70000, category_id=3, bbox=[40, 2, 22, 10], iscrowd=1))
        cv2.imwrite(str(root / "pan" / f"img{i}.png"), id2rgb(id_map)[..., ::-1])
        images.append(dict(id=i, file_name=f"img{i}.png", width=w, height=h))
        anns.append(dict(image_id=i, file_name=f"img{i}.png", segments_info=segs))
        maps.append(id_map)
    ann = dict(images=images, annotations=anns,
               categories=[dict(id=1, name="car", isthing=1), dict(id=3, name="person", isthing=1),
                           dict(id=100, name="road", isthing=0)])
    p = root / "panoptic.json"
    p.write_text(json.dumps(ann))
    return p, maps


def test_panoptic_dataset_and_loader_are_jax_bit_for_bit(tmp_path):
    """``CocoPanopticDataset`` through ``LoadImageFromFile`` and
    ``LoadPanopticAnnotations`` in both packages: the classes, every key of
    both samples (boxes, labels, full-image thing masks, the label map with
    void 255), ``get_ann_info`` and ``evaluate`` on perfect and on damaged
    predictions."""
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataset
    p, maps = _panoptic_fixture(tmp_path)
    cfg = dict(type="CocoPanopticDataset", ann_file=str(p), img_prefix=str(tmp_path / "imgs"),
               seg_prefix=str(tmp_path / "pan"),
               pipeline=[dict(type="LoadImageFromFile"), dict(type="LoadPanopticAnnotations")])
    jds, ds = jax_build_dataset(dict(cfg)), build_dataset(dict(cfg))
    assert len(ds) == len(jds) == 2
    assert ds.CLASSES == jds.CLASSES == ("car", "person", "road")
    assert ds.THING_CLASSES == jds.THING_CLASSES and ds.STUFF_CLASSES == ("road",)
    for i in range(2):
        a, b = ds.get_ann_info(i), jds.get_ann_info(i)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k], dtype=object), np.asarray(b[k], dtype=object))
        s, js = ds[i], jds[i]
        for k in ("img", "gt_bboxes", "gt_labels", "gt_masks", "gt_semantic_seg"):
            assert s[k].dtype == js[k].dtype, k
            np.testing.assert_array_equal(s[k], js[k], err_msg=k)
        assert s["gt_masks"].shape == (1 + i, 48, 64)
        assert (s["gt_semantic_seg"][maps[i] == 0] == 255).all()
    perfect = [(m.astype(np.int64), [dict(id=s["id"], category_id=s["category_id"])
                                     for s in ann["segments_info"]])
               for m, ann in zip(maps, json.loads(p.read_text())["annotations"])]
    damaged = [(np.where(m == 17, 0, m).astype(np.int64), segs) for m, segs in perfect]
    for preds in (perfect, damaged):
        assert ds.evaluate(preds) == jds.evaluate(preds)
    assert ds.evaluate(perfect)["PQ"] == 100.0 and ds.evaluate(damaged)["PQ"] < 100.0


@pytest.mark.parametrize("src,dst", [((40, 48), (5, 6)), ((64, 96), (8, 12)), ((45, 61), (6, 8))])
def test_semantic_target_is_resized_nearest_exact(src, dst):
    """``jax.image.resize(..., "nearest")`` of the label map (PanopticFPN's
    semantic target, ``panoptic.py:41-44``) equals torch's
    ``nearest-exact`` (half-pixel centres), not ``nearest``."""
    import torch.nn.functional as F
    rng = np.random.RandomState(6)
    lab = rng.randint(0, 255, (2, *src)).astype(np.int32)
    want = np.asarray(jax.image.resize(jnp.asarray(lab)[..., None], (2, *dst, 1), "nearest"))[..., 0]
    t = torch.from_numpy(lab)[:, None].float()
    exact = F.interpolate(t, size=dst, mode="nearest-exact")[:, 0].long().numpy()
    plain = F.interpolate(t, size=dst, mode="nearest")[:, 0].long().numpy()
    np.testing.assert_array_equal(exact, want)
    assert (plain != want).any()


def test_deformable_detr_refuses_box_refine():
    """No repo config sets ``with_box_refine=True`` and the JAX head's
    reference points stay fixed: the port's head raises naming it."""
    from oadg_tpu_torch.models.dense_heads.deformable_detr_head import DeformableDETRHead
    with pytest.raises(ValueError, match=r"with_box_refine=True\) is not ported"):
        DeformableDETRHead(num_classes=2, num_query=2, embed_dims=8, num_heads=1,
                           num_encoder_layers=1, num_decoder_layers=1,
                           feedforward_channels=8, with_box_refine=True, device="meta")


@pytest.mark.parametrize("key", ["with_bbox", "with_mask", "with_seg"])
def test_panoptic_loader_refuses_a_key_set_false(key):
    """No repo config names these keys; the loader always loads the boxes,
    the thing masks and the label map (JAX's defaults) and refuses a False."""
    from oadg_tpu_torch.data.pipelines import LoadPanopticAnnotations
    with pytest.raises(ValueError, match=rf"LoadPanopticAnnotations\({key}=False\)"):
        LoadPanopticAnnotations(**{key: False})
    LoadPanopticAnnotations(**{key: True})


# ---------------------------------------------------- PanopticFPN, whole ----

@pytest.fixture(scope="module")
def panoptic():
    """The JAX tiny PanopticFPN's losses (sampling keys fixed), the
    gradients of its every parameter and its test call; the port's on the
    same weights and the JAX sampler's uniforms."""
    from oadg_tpu.models import build_detector as jax_build_detector
    from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JaxTwoStage
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
    from oadg_tpu_torch.utils.draws import UniformDraws
    b = cases.batch(semantic=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tkeys = ("img", "img_shape", "scale_factor")
    jdet = jax_build_detector(cases.jax_model("panoptic_fpn"))
    calls = []

    def fixed_rng(self, name):
        calls.append(name)
        return jax.random.PRNGKey(cases.KEYS[(len(calls) - 1) % 2])

    def run(variables, b):
        def loss_fn(params):
            losses = jdet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                b, "train")
            return sum(x for k, x in losses.items() if "loss" in k), losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        return losses, grads, jdet.apply(variables, {k: b[k] for k in tkeys}, "test")

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTwoStage, "make_rng", fixed_rng)
    try:
        shapes = jax.eval_shape(lambda r, x: jdet.init(r, x, "train"),
                                {"params": jax.random.PRNGKey(0),
                                 "sampling": jax.random.PRNGKey(1)}, jb)
        variables = {"params": cases.randomize(shapes["params"]),
                     "batch_stats": cases.randomize(shapes["batch_stats"], 3)}
        calls.clear()
        jlosses, jgrads, jtest = jax.jit(run)(variables, jb)
    finally:
        mp.undo()
    assert calls == ["sampling"] * 2
    det = init_detector({"model": cases.torch_model("panoptic_fpn")}, device="cpu",
                        seed=0).model
    det.load_state_dict(jax_variables_to_state_dict(variables, roi_channels=16), strict=True)
    det.train()
    tb = cases.torch_batch(b)
    with torch.no_grad():
        feats = det.extract_feat(tb["img"])
    num_anchors = sum(3 * f.shape[2] * f.shape[3] for f in feats)
    rp = det.train_cfg["rpn_proposal"]["max_per_img"]
    draws = UniformDraws(given=cases.jax_draws(num_anchors, 4 + rp))
    losses = det.forward_train(tb, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    det.eval()
    with torch.no_grad():
        test = det.simple_test({k: tb[k] for k in tkeys})
    want_grads = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)}, roi_channels=16)
    return dict(det=det, jlosses=jlosses, losses=losses, want_grads=want_grads, jtest=jtest,
                test=test)


@pytest.mark.parametrize("key", ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "acc", "loss_bbox",
                                 "loss_mask", "loss_semantic_seg"])
def test_panoptic_fpn_losses_match_jax(panoptic, key):
    assert set(panoptic["losses"]) == set(panoptic["jlosses"])
    got, want = float(panoptic["losses"][key].detach()), float(panoptic["jlosses"][key])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


def test_panoptic_fpn_semantic_head_gradients_match_jax(panoptic):
    """The semantic head's every parameter (its laterals on the 5 FPN
    levels, its convs, ``conv_logits``; ``conv_embedding`` takes none)."""
    grads = dict(panoptic["det"].semantic_head.named_parameters())
    want = panoptic["want_grads"]
    assert {k[len("semantic_head."):] for k in want if k.startswith("semantic_head.")} \
        == set(grads)
    for name, p in grads.items():
        w = want[f"semantic_head.{name}"].numpy()
        if name.startswith("conv_embedding."):
            assert p.grad is None and not w.any()
            continue
        assert np.abs(w).max() > 0, name
        _close(p.grad, w, 1e-4, name)


@pytest.mark.parametrize("module", ["backbone", "neck", "rpn_head", "roi_head"])
def test_panoptic_fpn_detector_gradients_match_jax(panoptic, module):
    """Every trainable parameter of the detector: the backbone's stages 2-4
    (the stem and stage 1 are frozen: no gradient in either package), the
    neck, whose maps feed both the detector and the semantic head (JAX runs
    ``extract_feat`` once for each, the port once for both: the two uses'
    gradients summed), the RPN and the box and mask heads."""
    det, want = panoptic["det"], panoptic["want_grads"]
    trainable = {k: p for k, p in det.named_parameters()
                 if p.requires_grad and k.startswith(module + ".")}
    assert trainable and set(trainable) <= set(want)
    frozen = [k for k, p in det.named_parameters() if not p.requires_grad]
    if module == "backbone":
        assert "backbone.conv1.weight" in frozen and all(
            k.startswith(("backbone.conv1", "backbone.bn1", "backbone.layer1."))
            for k in frozen)
        assert all(not want[k].numpy().any() for k in frozen if k in want)
    for name, p in trainable.items():
        w = want[name].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, name
        _close(p.grad, w, 1e-4, name)


def test_panoptic_fpn_serves_jax_pair(panoptic):
    """``((dets, labels, valid), stuff probabilities)``, the probabilities
    (N, h, w, K) channels last at stride 8; no masks."""
    (jd, jl, jv), jp = panoptic["jtest"]
    (td, tl, tv), tp = panoptic["test"]
    assert tp.shape == jp.shape == (2, 8, 12, cases.STUFF_CLASSES)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.sum() > 0
    np.testing.assert_array_equal(tl.numpy()[tv.numpy()], np.asarray(jl)[np.asarray(jv)])
    _close(td[tv], np.asarray(jd)[np.asarray(jv)], 1e-4, "dets")
    _close(tp, jp, 1e-5, "stuff")
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_panoptic_config_as_given_cannot_train_in_either_package():
    """The config names no ``mask_roi_extractor``: both mask heads read the
    box layer's 7x7 RoIs and give 14x14 logits against ``mask_size`` 28
    targets. JAX's training step raises ``TypeError`` on the product; the
    port's raises ``ValueError`` naming the option that repairs it. The
    port serves the config as given."""
    from oadg_tpu.models import build_detector as jax_build_detector
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.utils.draws import UniformDraws
    b = cases.batch(semantic=True)
    jdet = jax_build_detector(cases.jax_model("panoptic_fpn", repaired=False))
    with pytest.raises(TypeError, match=r"mul got incompatible shapes.*14, 14.*28, 28"):
        jax.eval_shape(lambda r, x: jdet.init(r, x, "train"),
                       {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
                       {k: jnp.asarray(v) for k, v in b.items()})
    handle = init_detector({"model": cases.torch_model("panoptic_fpn", repaired=False)},
                           device="cpu", seed=0, num_views=1)
    assert handle.model.roi_head.mask_roi_extractor.output_size == 7
    tb = cases.torch_batch(b)
    handle.model.train()
    with pytest.raises(ValueError, match=r"14x14 logits.*mask_size=28.*"
                                         r"model\.roi_head\.mask_roi_extractor of output_size 14"):
        handle.model.forward_train(tb, UniformDraws(torch.Generator().manual_seed(0)))
    handle.model.eval()
    (dets, _, valid), probs = handle.test({k: tb[k] for k in ("img", "img_shape", "scale_factor")})
    assert dets.shape == (2, 10, 5) and probs.shape == (2, 8, 12, cases.STUFF_CLASSES)


def test_box_test_path_refuses_panoptic_fpn():
    """JAX's ``run_test`` unpacks a test call as (dets, labels, valid) and
    raises ``ValueError`` on PanopticFPN's pair; the port's
    ``single_gpu_test`` and ``inference_detector`` refuse it with a
    ``ValueError`` that says why; ``DetectorHandle.test`` serves it."""
    from oadg_tpu.apis.test import run_test as jax_run_test
    from oadg_tpu_torch.apis import inference_detector, init_detector
    from oadg_tpu_torch.apis.test import single_gpu_test
    outs = ((np.zeros((1, 4, 5), np.float32), np.zeros((1, 4), np.int32), np.ones((1, 4), bool)),
            np.zeros((1, 8, 12, 6), np.float32))
    batch = {"img": np.zeros((1, 64, 96, 3), np.float32)}
    with pytest.raises(ValueError, match="expected 3, got 2"):
        jax_run_test(lambda p, s, b: outs, None, None, [batch], 8)
    handle = init_detector({"model": cases.torch_model("panoptic_fpn")}, device="cpu", seed=0)
    with pytest.raises(ValueError, match="cannot score it"):
        single_gpu_test(dict(handle=handle, test_fn=lambda b: None, num_classes=8), [batch])
    with pytest.raises(ValueError, match=r"PanopticFPN's test call returns \(\(dets, labels, "
                                         r"valid\), stuff probabilities\)"):
        inference_detector(handle, np.zeros((64, 96, 3), np.uint8))
