"""HTC's and SCNet's RoI heads in the port against the JAX package, on the CPU.

The RoI heads of ``configs/scnet/scnet_r50_fpn_1x_coco.py`` and
``configs/htc/htc_r50_fpn_1x_coco.py`` made tiny
(``torch_twostage_cases.tiny_roi``) on seeded FPN maps, gts, proposals,
box-cropped gt masks and a label map, with the JAX SCNet head's seeded
variables carried by ``jax_variables_to_state_dict`` and the uniforms the
JAX samplers draw from a fixed key. JAX's SCNet loss is HTC's plus
``loss_glbctx``, so one JAX run holds both port heads (the JAX head is
traced once). The configs give no ``mask_roi_extractor``, so both packages
run the mask branch at the box layer's 7x7 (14x14 logits, ``mask_size``
14); the 14x14 mask RoIs that the card's smoke test gives HTC and SCNet
are held here through the semantic RoIAlign at 14 and in
``test_torch_roi_variants.py``'s MS R-CNN.

Tolerances: ``FusedSemanticHead``'s outputs within 1e-5 of their largest
magnitude; the bilinear downsample (``F.interpolate(antialias=True)``
against ``jax.image.resize``) within 1e-6, the label resize exact; the
semantic RoIAlign (B1's and B2's plain versions on one stride-8 level)
against JAX's single-level ``roi_align`` and its VJP within 1e-5 of the
largest magnitude (the two compute the tap geometry in other orders); each
loss rtol 1e-5 (``acc`` to 1e-6); every parameter's and FPN map's gradient
within 1e-4 of its largest magnitude.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import torch_twostage_cases as cases
from oadg_tpu.models.roi_heads.htc_scnet_heads import FusedSemanticHead as JSemantic
from oadg_tpu.ops.roi_align import roi_align as jax_roi_align
from oadg_tpu_torch.models.roi_heads.htc_scnet_heads import (FeatureRelayHead,
                                                             FusedSemanticHead, semantic_loss)
from oadg_tpu_torch.ops.roi_align import (roi_align_multilevel_ref,
                                          roi_align_multilevel_ref_backward)
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(9)


@pytest.fixture(scope="module")
def scnet():
    """SCNet's RoI head (HTC's and ``GlobalContextHead``) as the config
    gives it: the JAX loss with gt masks and the label map, and its
    gradients with respect to the parameters and the FPN maps, jitted once;
    then the port's on the same inputs and draws."""
    model = cases.tiny_roi(cases.load_model("scnet", "jax"))
    jhead = cases.jax_head(model)
    case = cases.inputs(2)
    jf = [jnp.asarray(f) for f in case["feats"]]
    args = (jnp.asarray(case["props"]), jnp.asarray(case["prop_valid"]), jnp.asarray(case["gt"]),
            jnp.asarray(case["gt_valid"]), jnp.asarray(case["labels"]), KEY)
    kw = dict(gt_semantic_seg=jnp.asarray(case["seg"]), gt_masks=jnp.asarray(case["masks"]))
    params = cases.randomize(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), jf, *args, method="loss", **kw))["params"])

    def loss_fn(p, feats):
        losses = jhead.apply({"params": p}, feats, *args, method="loss", **kw)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        params, jf)
    run = dict(jlosses=jlosses, jgrads=jgrads, params=params, case=case)
    run.update(_port_run("scnet", params, case))
    return run


def _port_run(name, params, case):
    """The port's head of config ``name`` with the JAX variables (those it
    has), its losses and gradients on ``case`` with the JAX draws."""
    head = cases.port_head(cases.tiny_roi(cases.load_model(name, "torch")))
    sd = cases.port_state(params)
    head.load_state_dict({k: v for k, v in sd.items() if k in head.state_dict()}, strict=True)
    feats, t = cases.to_torch(case)
    draws = UniformDraws(given=cases.cascade_draws(KEY, mask=True))
    losses = head.loss(feats, t["props"], t["prop_valid"], t["gt"], t["gt_valid"], t["labels"],
                       draws, gt_masks=t["masks"], gt_semantic_seg=t["seg"])
    sum(v for k, v in losses.items() if "loss" in k).backward()
    assert set(draws.drawn) == set(draws.given)
    return dict(losses=losses, head=head, feats=feats)


HTC_KEYS = [f"s{k}.{n}" for k in range(3)
            for n in ("loss_cls", "loss_bbox", "acc", "loss_mask")] + ["loss_semantic_seg"]


def _check_losses(got, want, keys):
    assert set(got) == set(keys) and set(keys) <= set(want)
    for key in keys:
        w, g = float(want[key]), got[key].item()
        if key.endswith("acc"):
            assert g == pytest.approx(w, rel=1e-6), key
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=key)
            assert g > 0, key


def _check_grads(head, feats, jgrads, levels=5):
    """Every parameter of ``head`` and the first ``levels`` FPN maps against
    JAX's gradients (each nonzero)."""
    want = cases.port_state(jgrads[0])
    named = dict(head.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, name
        cases.close_grads(p.grad.numpy(), w, err_msg=name)
    for i, (f, jg) in enumerate(zip(feats[:levels], jgrads[1])):
        cases.close_grads(f.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2),
                          err_msg=f"level {i}")
    return named


def test_scnet_losses_match_jax(scnet):
    """The box stages, the interleaved mask stages with the info flow and
    the semantic embedding (masks at the config's 7x7: it gives no mask RoI
    layer), ``loss_semantic_seg`` on the given label map (the JAX detector
    never passes one: ROADMAP C) and ``loss_glbctx`` (the multilabel BCE on
    the last FPN level, weight 3)."""
    _check_losses(scnet["losses"], scnet["jlosses"], HTC_KEYS + ["loss_glbctx"])
    assert scnet["head"].mask_out_size == 7 and scnet["head"].mask_size == 14


def test_scnet_gradients_match_jax(scnet):
    """Every parameter (the three box heads, the three mask heads, the info
    convs of stages 1 and 2, the semantic head, the global context head)
    and every FPN map, the semantic embedding's stride-8 RoIAlign gradient
    included."""
    named = _check_grads(scnet["head"], scnet["feats"], scnet["jgrads"])
    assert set(named) == set(cases.port_state(scnet["jgrads"][0]))
    assert sum(k.startswith("mask_head.") for k in named) == 3 * 8
    assert sorted(k for k in named if k.startswith("info_convs.")) == [
        "info_convs.1.bias", "info_convs.1.weight", "info_convs.2.bias", "info_convs.2.weight"]
    assert sum(k.startswith("semantic_head.") for k in named) == 2 * (5 + 2 + 2)
    assert sum(k.startswith("glbctx_head.") for k in named) == 2 * 5


def test_htc_head_matches_jax(scnet):
    """HTC's config builds ``HybridTaskCascadeRoIHead``: with SCNet's JAX
    variables but the global context head it gives JAX's HTC losses (JAX's
    SCNet loss is HTC's plus ``loss_glbctx``) and their gradients; the last
    FPN map's gradient, which ``loss_glbctx`` also reaches, is left out."""
    run = _port_run("htc", scnet["params"], scnet["case"])
    assert type(run["head"]).__name__ == "HybridTaskCascadeRoIHead"
    _check_losses(run["losses"], scnet["jlosses"], HTC_KEYS)
    named = _check_grads(run["head"], run["feats"], scnet["jgrads"], levels=4)
    assert not any(k.startswith("glbctx_head.") for k in named)


def test_htc_weight_map_is_total(scnet):
    """Every JAX leaf has its port tensor and back: ``mask_heads_k`` ->
    ``mask_head.{k}``, ``info_conv{k}`` -> ``info_convs.{k}`` (JAX's
    ``info_conv0`` is never applied, so it has no variables and the port's
    slot 0 none), ``semantic`` -> ``semantic_head``, ``glbctx`` ->
    ``glbctx_head``; the transposed conv flipped."""
    sd = cases.port_state(scnet["params"])
    assert set(sd) == set(scnet["head"].state_dict())
    assert "info_conv0" not in scnet["params"]
    assert not list(scnet["head"].info_convs[0].parameters())
    up = np.asarray(scnet["params"]["mask_heads_2"]["upsample"]["kernel"])   # (kh, kw, in, out)
    np.testing.assert_array_equal(sd["mask_head.2.upsample.weight"].numpy(),
                                  up[::-1, ::-1].transpose(2, 3, 0, 1))


@pytest.fixture(scope="module")
def semantic():
    rng = np.random.RandomState(5)
    feats = [rng.normal(0, 1, (2, 32 >> i, 48 >> i, cases.C)).astype(np.float32)
             for i in range(5)]
    jmod = JSemantic(num_ins=5, fusion_level=1, num_convs=2, in_channels=cases.C,
                     conv_out_channels=cases.C, num_classes=5)
    jf = [jnp.asarray(f) for f in feats]
    params = cases.randomize(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jf))["params"], seed=6)
    seg, emb = jax.jit(lambda p: jmod.apply({"params": p}, jf))(params)
    mod = FusedSemanticHead(num_ins=5, fusion_level=1, num_convs=2, in_channels=cases.C,
                            conv_out_channels=cases.C, num_classes=5, device="cpu")
    sd = cases.port_state({"semantic": params})
    mod.load_state_dict({k[len("semantic_head."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        tseg, temb = mod([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    return dict(feats=feats, seg=np.asarray(seg), emb=np.asarray(emb), tseg=tseg.numpy(),
                temb=temb.numpy())


def test_fused_semantic_head_matches_jax(semantic):
    """Level 0 downsampled 2x, levels 2-4 upsampled, onto the stride-8
    level; the logits and the embedding."""
    for got, want in ((semantic["tseg"], semantic["seg"]), (semantic["temb"], semantic["emb"])):
        want = want.transpose(0, 3, 1, 2)
        assert got.shape == want.shape and got.shape[2:] == (16, 24)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", [(8, 12), (32, 48), (4, 6)])
def test_bilinear_resize_is_jax_image_resize_with_antialias(size):
    """``jax.image.resize(..., "bilinear")`` antialiases a downsample:
    ``F.interpolate(antialias=True)`` matches it, without antialias the 2x
    downsample misses by more than 0.1; upsamples match either way."""
    x = np.random.RandomState(7).normal(0, 1, (2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
    want = want.transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = F.interpolate(xt, size=size, mode="bilinear", align_corners=False, antialias=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = F.interpolate(xt, size=size, mode="bilinear", align_corners=False).numpy()
    if size[0] < 16:
        assert np.abs(plain - want).max() > 0.1
    else:
        np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6)


def test_semantic_label_resize_and_loss_match_jax():
    """The label map resized by ``jax.image.resize(..., "nearest")`` is
    ``F.interpolate(mode="nearest-exact")`` (``"nearest"`` picks other
    pixels), and ``semantic_loss`` is the JAX head's formula on it."""
    rng = np.random.RandomState(8)
    lab = rng.randint(0, 5, (2, 60, 92)).astype(np.int32)
    lab[:, :4] = 255
    want = np.asarray(jax.image.resize(jnp.asarray(lab)[..., None], (2, 15, 23, 1),
                                       "nearest"))[..., 0]
    t = torch.from_numpy(lab)[:, None].float()
    exact = F.interpolate(t, size=(15, 23), mode="nearest-exact")[:, 0].long().numpy()
    np.testing.assert_array_equal(exact, want)
    assert (F.interpolate(t, size=(15, 23), mode="nearest")[:, 0].long().numpy() != want).any()
    seg = rng.normal(0, 1, (2, 15, 23, 5)).astype(np.float32)
    logp = jax.nn.log_softmax(jnp.asarray(seg), -1)
    nll = -jnp.take_along_axis(logp, jnp.clip(jnp.asarray(want), 0, 4)[..., None], -1)[..., 0]
    valid = want < 255
    jl = float(jnp.sum(nll * valid) / max(valid.sum(), 1) * 0.2)
    got = semantic_loss(torch.from_numpy(seg).permute(0, 3, 1, 2), torch.from_numpy(lab))
    np.testing.assert_allclose(got.item(), jl, rtol=1e-6)


@pytest.mark.parametrize("out", [7, 14])
def test_semantic_roi_align_is_jax_roi_align_on_one_stride_8_level(out):
    """HTC's semantic RoIAlign: the port runs the multilevel function (B1,
    its gradient B2, on the card) on the embedding as one level of stride
    8; JAX runs its single-level ``roi_align`` (``spatial_scale`` 1/8,
    ``sampling_ratio`` 2, aligned). Values and the maps' gradient within
    1e-5 of the largest magnitude, rois reaching past the map's edges
    included."""
    rng = np.random.RandomState(10 + out)
    emb = rng.normal(0, 1, (2, 12, 20, cases.C)).astype(np.float32)
    r = 64
    xy = rng.uniform(-12, 150, (r, 2))
    wh = rng.uniform(2, 90, (r, 2))
    rois = np.concatenate([rng.randint(0, 2, (r, 1)), xy, xy + wh], 1).astype(np.float32)
    dy = rng.normal(0, 1, (r, out, out, cases.C)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_roi_align(f, jnp.asarray(rois), output_size=out,
                                                spatial_scale=1.0 / 8.0, sampling_ratio=2), jnp.asarray(emb))
    (want_grad,) = vjp(jnp.asarray(dy))
    tf = [torch.from_numpy(emb).permute(0, 3, 1, 2)]
    got = roi_align_multilevel_ref(tf, torch.from_numpy(rois), out, (8,), 2, 56)
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    (grad,) = roi_align_multilevel_ref_backward(
        torch.from_numpy(dy).permute(0, 3, 1, 2).contiguous(), [tf[0].shape],
        torch.from_numpy(rois), out, (8,), 2, 56)
    wg = np.asarray(want_grad).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(grad.numpy(), wg, rtol=0, atol=1e-5 * np.abs(wg).max())


def test_feature_relay_head_matches_jax():
    """``FeatureRelayHead`` (no config of the repo builds it): the JAX FC's
    outputs are r x r x C in that order; the port returns (R, C, r, r)."""
    from oadg_tpu.models.roi_heads.htc_scnet_heads import FeatureRelayHead as JRelay
    x = np.random.RandomState(11).normal(0, 1, (5, 24)).astype(np.float32)
    jmod = JRelay(in_channels=24, out_conv_channels=6, roi_feat_size=3)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x))).transpose(0, 3, 1, 2)
    mod = FeatureRelayHead(in_channels=24, out_conv_channels=6, roi_feat_size=3, device="cpu")
    mod.fc.weight.data = torch.from_numpy(np.asarray(params["fc"]["kernel"]).T.copy())
    mod.fc.bias.data = torch.from_numpy(np.asarray(params["fc"]["bias"]).copy())
    with torch.no_grad():
        np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6)


def test_jax_forward_train_never_passes_the_label_map():
    """JAX's ``forward_train`` calls ``roi.loss`` without
    ``gt_semantic_seg`` (``two_stage.py:191-195``), so ``loss_semantic_seg``
    never appears in a JAX HTC step; the port's detector passes none
    either (ROADMAP C: the pipeline's ``with_seg`` and ``SegRescale`` are
    unported)."""
    import inspect
    from oadg_tpu.models.detectors.two_stage import TwoStageDetector as JDet
    from oadg_tpu_torch.models.detectors.two_stage import TwoStageDetector as TDet
    for det in (JDet, TDet):
        src = inspect.getsource(det.forward_train)
        assert "gt_masks" in src and "gt_semantic_seg" not in src
