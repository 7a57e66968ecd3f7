"""The modules of A.2.9a in the port against the JAX package, on the CPU, in
float32: MobileNetV2, RegNet, Res2Net and ResNeSt, CARAFE's reassembly,
FPN-CARAFE and FPG, each at the test size of ``torch_backbone_cases``, on
seeded numpy weights (shapes from ``jax.eval_shape``, never an eager
``init``) carried by ``jax_variables_to_state_dict``; JAX jitted once a
module (its outputs and the gradients of a seeded random projection of them
w.r.t. its input and parameters, in train mode with the live BNs' new
statistics where it has live BNs). Also RegNet's width schedule, Res2Net's
first ``layer1`` block and FPG's fault on an odd P5 (ROADMAP C).

Tolerances: outputs within 1e-5 of each output's largest magnitude,
gradients within 1e-4 of each one's largest; MobileNetV2's and FPG's live
BNs (batch statistics over as few as 12 values a channel at the last stage)
rtol 1e-4 with a floor of 2e-4 of the largest for outputs and statistics
(MobileNetV2's last stage reads 8e-5 of its largest from a float64 run of the
port in JAX's float32, 4e-5 in the port's), rtol 1e-3 with a floor of 3e-4
for gradients (``test_torch_yolo_slice.py``'s live-BN step), and 1e-6 of the
largest gradient where the exact gradient is 0 (``ZERO_GRAD``); CARAFE
within 1e-6 of the largest.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oadg_tpu.models  # noqa: F401  (registers the JAX modules)
import oadg_tpu_torch.models  # noqa: F401  (registers the port's)
import torch_backbone_cases as cases
from oadg_tpu.utils.registry import BACKBONES as JAX_BACKBONES, NECKS as JAX_NECKS
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.registry import BACKBONES, NECKS

torch.set_num_threads(2)
LIVE = ("mobilenet_v2", "fpg")
# A live BN's bias whose shift the next live BN removes (MobileNetV2's
# project BNs: a 1x1 conv and its BN follow, through the residual) has an
# exact gradient of 0; both packages' float32 gradients read at most 5e-7 of
# the backbone's largest gradient there.
ZERO_GRAD = 1e-6


def _state(variables, scope):
    """A JAX module's variables -> the port module's ``state_dict``."""
    tree = {c: {f"{scope}_m": v} for c, v in variables.items() if v}
    return {k[len(scope) + 1:]: v for k, v in jax_variables_to_state_dict(tree).items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).permute(0, 3, 1, 2)


def _jax_run(module, variables, args, cots, train):
    """One jit: the outputs, the new ``batch_stats`` (``train``) and the
    gradients of ``sum(outputs * cots)`` w.r.t. the parameters and
    ``args``."""
    def run(params, args):
        def f(params, args):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            if train:
                outs, new = module.apply(v, *args, mutable=["batch_stats"])
            else:
                outs, new = module.apply(v, *args), {}
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, new)

        (_, (outs, new)), grads = jax.value_and_grad(f, (0, 1), has_aux=True)(params, args)
        return outs, new, grads

    return jax.jit(run)(variables["params"], args)


def _port_run(mod, variables, scope, args, cots, train):
    mod.load_state_dict(_state(variables, scope), strict=True)
    mod.train(train)
    xs = [_nchw(a).requires_grad_() for a in args]
    outs = mod(xs[0] if scope == "backbone" else xs)
    sum((o * _nchw(c)).sum() for o, c in zip(outs, cots)).backward()
    return outs, xs


def _cots(mod, x, seed=7):
    """Seeded NHWC cotangents of the port module's outputs on ``x`` (their
    shapes from an eval-mode call: no second JAX trace; the tests hold
    JAX's outputs to these shapes)."""
    mod.eval()
    with torch.no_grad():
        outs = mod(x)
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (o.shape[0], *o.shape[2:], o.shape[1])).astype(np.float32)
            for o in outs]


@pytest.fixture(scope="module", params=sorted(cases.BACKBONES))
def backbone_run(request):
    name = request.param
    cfg = cases.BACKBONES[name]
    jm = cases.jax_module(JAX_BACKBONES, cfg)
    x = np.random.RandomState(1).normal(0, 1, (2, *cases.HW, 3)).astype(np.float32)
    variables = cases.jax_variables(jm, jnp.asarray(x))
    mod = cases.torch_module(BACKBONES, cfg)
    mod.load_state_dict(_state(variables, "backbone"), strict=True)
    cots = _cots(mod, _nchw(x))
    train = name in LIVE
    want, new, (gp, gx) = _jax_run(jm, variables, (x,), cots, train)
    outs, (xt,) = _port_run(mod, variables, "backbone", (x,), cots, train)
    return dict(name=name, mod=mod, want=want, new=new, gp=gp, gx=gx[0], outs=outs, xt=xt,
                variables=variables)


def _tols(name, grad=False):
    if name in LIVE:
        return (1e-3, 3e-4) if grad else (1e-4, 2e-4)
    return (0, 1e-4) if grad else (0, 1e-5)


def test_backbone_outputs_and_statistics_match_jax(backbone_run):
    """The outputs; MobileNetV2's live BNs (``norm_eval=False``) moved
    every stored statistic as JAX's did in the train pass, the frozen BNs of
    the others none."""
    run = backbone_run
    name = run["name"]
    assert len(run["outs"]) == len(run["want"]) == {"mobilenet_v2": 3, "regnet": 4}.get(name, 2)
    for i, (g, w) in enumerate(zip(run["outs"], run["want"])):
        cases.close(g.permute(0, 2, 3, 1), w, *_tols(name), f"output {i}")
    before = _state({"batch_stats": run["variables"]["batch_stats"]}, "backbone")
    sd = run["mod"].state_dict()
    assert set(before) == {k for k in sd if "running_" in k}
    if name != "mobilenet_v2":
        assert all(torch.equal(sd[k], v) for k, v in before.items())
        return
    assert [o.shape[1] for o in run["outs"]] == [8, 24, 80]      # widen 0.25: stages 2, 4, 6
    want = _state({"batch_stats": jax.tree_util.tree_map(np.asarray, run["new"]["batch_stats"])},
                  "backbone")
    assert set(want) == set(before) and len(want) == 2 * 51
    for k, w in want.items():
        cases.close(sd[k], w, 1e-4, 1e-5, k)
        assert not torch.equal(sd[k], before[k]), k


def test_backbone_gradients_match_jax(backbone_run):
    """The input's gradient and every trainable parameter's. Res2Net stops
    the gradient after its stem and its frozen ``layer1`` (``frozen_stages
    =1``): JAX's gradients of the stem, ``layer1`` and the input are 0, the
    port's never formed; its second and third stem BNs trainable all the
    same. RegNet's and ResNeSt's reach the input through their frozen
    stages."""
    run = backbone_run
    name, mod = run["name"], run["mod"]
    want = _state({"params": jax.tree_util.tree_map(np.asarray, run["gp"])}, "backbone")
    params = dict(mod.named_parameters())
    assert set(want) == set(params)
    gx = np.asarray(run["gx"])
    if name == "res2net":
        assert not gx.any() and run["xt"].grad is None
        assert params["stem.4.weight"].requires_grad and params["stem.4.weight"].grad is None
    else:
        cases.close(run["xt"].grad.permute(0, 2, 3, 1), gx, *_tols(name, True), "input")
    largest = max(float(np.abs(w.numpy()).max()) for w in want.values())
    checked = unreached = 0
    for k, p in params.items():
        w = want[k].numpy()
        if not p.requires_grad:
            continue
        if p.grad is None:
            assert name == "res2net" and k.startswith("stem.") and not w.any(), k
            unreached += 1
            continue
        assert np.abs(w).max() > 0, k
        rtol, floor = _tols(name, True)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=rtol, err_msg=k, atol=max(
            floor * np.abs(w).max(), ZERO_GRAD * largest if name in LIVE else 0))
        checked += 1
    assert checked > 0 and checked + unreached == sum(p.requires_grad for p in params.values())
    assert unreached == (4 if name == "res2net" else 0)   # the 2nd and 3rd stem BNs


@pytest.mark.parametrize("groups,hw", [(1, (5, 7)), (2, (6, 3))])
def test_carafe_matches_jax(groups, hw):
    """Random normalized kernels over each group's 5x5 taps, at odd source
    sides: the output and the gradients w.r.t. the map and the kernels."""
    from oadg_tpu.ops.misc_ops import carafe as jax_carafe
    from oadg_tpu_torch.ops.misc_ops import carafe
    rng = np.random.RandomState(groups)
    h, w = hw
    x = rng.normal(0, 1, (2, h, w, 8)).astype(np.float32)
    logits = rng.normal(0, 2, (2, 2 * h, 2 * w, groups, 25)).astype(np.float32)
    m = np.exp(logits - logits.max(-1, keepdims=True))
    masks = (m / m.sum(-1, keepdims=True)).reshape(2, 2 * h, 2 * w, groups * 25)
    cot = rng.normal(0, 1, (2, 2 * h, 2 * w, 8)).astype(np.float32)

    def run(x, masks):
        out, vjp = jax.vjp(lambda a, b: jax_carafe(a, b, 5, groups, 2), x, masks)
        return out, vjp(cot)

    want, (gx, gm) = jax.jit(run)(x, masks)
    xt, mt = _nchw(x).requires_grad_(), _nchw(masks).requires_grad_()
    out = carafe(xt, mt, 5, groups, 2)
    (out * _nchw(cot)).sum().backward()
    cases.close(out.permute(0, 2, 3, 1), want, 0, 1e-6, "output")
    cases.close(xt.grad.permute(0, 2, 3, 1), gx, 0, 1e-6, "x")
    cases.close(mt.grad.permute(0, 2, 3, 1), gm, 0, 1e-6, "masks")


@pytest.fixture(scope="module", params=sorted(cases.NECKS))
def neck_run(request):
    """FPN-CARAFE on C2 15x29 (its 2x maps cropped to the level below), FPG
    on 16x32 (an even P5), in train mode."""
    name = request.param
    cfg = cases.NECKS[name]
    jm = cases.jax_module(JAX_NECKS, cfg)
    ins = cases.neck_inputs(hw=(15, 29) if name == "carafe" else (16, 32))
    variables = cases.jax_variables(jm, [jnp.asarray(x) for x in ins])
    mod = cases.torch_module(NECKS, cfg)
    mod.load_state_dict(_state(variables, "neck"), strict=True)
    cots = _cots(mod, [_nchw(x) for x in ins])
    want, new, (gp, gx) = _jax_run(jm, variables, (ins,), cots, True)
    mod.train()
    xs = [_nchw(x).requires_grad_() for x in ins]
    outs = mod(xs)
    sum((o * _nchw(c)).sum() for o, c in zip(outs, cots)).backward()
    return dict(name=name, mod=mod, want=want, new=new, gp=gp, gx=gx[0], outs=outs, xs=xs,
                variables=variables)


def test_neck_outputs_and_gradients_match_jax(neck_run):
    """Five levels (P6 the max-pooled P5), the gradients of the four inputs
    and of every parameter; FPG's BN statistics after the train pass."""
    run = neck_run
    name = run["name"]
    assert len(run["outs"]) == len(run["want"]) == 5
    for i, (g, w) in enumerate(zip(run["outs"], run["want"])):
        cases.close(g.permute(0, 2, 3, 1), w, *_tols(name), f"P{i + 2}")
    for i, (xt, w) in enumerate(zip(run["xs"], run["gx"])):
        cases.close(xt.grad.permute(0, 2, 3, 1), w, *_tols(name, True), f"C{i + 2}")
    want = _state({"params": jax.tree_util.tree_map(np.asarray, run["gp"])}, "neck")
    params = dict(run["mod"].named_parameters())
    assert set(want) == set(params)
    for k, p in params.items():
        assert np.abs(want[k].numpy()).max() > 0, k
        cases.close(p.grad, want[k], *_tols(name, True), k)
    if name == "fpg":                # 2 stacks of 4 downs and 4 ups, 5 outputs: 21 live BNs
        new = _state({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                            run["new"]["batch_stats"])}, "neck")
        sd = run["mod"].state_dict()
        assert set(new) == {k for k in sd if "running_" in k} and len(new) == 2 * 21
        for k, w in new.items():
            cases.close(sd[k], w, 1e-4, 1e-5, k)
    else:                            # the encoder's outputs: JAX's (phase, tap) order
        enc = run["mod"].upsample_modules[0].content_encoder.weight
        assert enc.shape == (4 * 25, 64, 3, 3)


def test_regnet_schedule_is_jax_exactly():
    """Every preset's stage widths, blocks and group widths equal the JAX
    package's; RegNetX-3.2GF's are [96, 192, 432, 1008], [2, 6, 15, 2] and
    48 (2, 4, 9 and 21 groups)."""
    from oadg_tpu.models.backbones import regnet as jax_regnet
    from oadg_tpu_torch.models.backbones.regnet import ARCH_PRESETS, regnet_schedule
    assert ARCH_PRESETS == jax_regnet.ARCH_PRESETS
    for arch, a in ARCH_PRESETS.items():
        widths, blocks, _ = jax_regnet._generate_widths(a["w0"], a["wa"], a["wm"], a["depth"])
        widths, groups = jax_regnet._adjust(widths, [a["group_w"]] * len(widths))
        assert regnet_schedule(arch) == (widths, blocks, groups), arch
    widths, blocks, groups = regnet_schedule("regnetx_3.2gf")
    assert (widths, blocks, groups) == ([96, 192, 432, 1008], [2, 6, 15, 2], [48] * 4)
    assert [w // g for w, g in zip(widths, groups)] == [2, 4, 9, 21]


def test_res2net_first_block_adds_hierarchically_as_jax_not_mmdet():
    """``layer1``'s first Bottle2neck has stride 1: the JAX block (and the
    port's) adds each 3x3's output to the next chunk, as a later block
    does. mmdet's first block of a stage (``stage_type='stage'``) does not,
    whatever its stride (ROADMAP C): that forward, written here on the same
    modules, differs by more than 10% of the output's largest magnitude."""
    from oadg_tpu.models.backbones.resnet import Bottle2neck as JaxBottle2neck
    from oadg_tpu_torch.models.backbones.resnet import AvgDownShortcut, Bottle2neck
    from oadg_tpu_torch.models.layers import conv_frozen_bn
    x = np.random.RandomState(3).normal(0, 1, (2, 8, 12, 8)).astype(np.float32)
    jm = JaxBottle2neck(planes=16, stride=1, downsample=True,
                        norm_cfg=dict(type="BN", _eval=True))
    variables = cases.jax_variables(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, x)
    blk = Bottle2neck(8, 16, 1, 1, AvgDownShortcut(8, 64, 1, True, True))
    state = jax_variables_to_state_dict(
        {c: {"backbone_m": {"layer1_0": v}} for c, v in variables.items()})
    blk.load_state_dict({k[len("backbone.layer1.0."):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        xt = _nchw(x)
        got = blk(xt)
        cases.close(got.permute(0, 2, 3, 1), want, 0, 1e-5, "block")
        chunks = torch.split(torch.relu(conv_frozen_bn(blk.conv1, blk.bn1, xt)), blk.width, 1)
        parts = [torch.relu(conv_frozen_bn(c, b, chunk))
                 for c, b, chunk in zip(blk.convs, blk.bns, chunks)]
        out = conv_frozen_bn(blk.conv3, blk.bn3, torch.cat(parts + [chunks[-1]], 1))
        mmdet = torch.relu(out + blk.downsample(xt))
    assert float((mmdet - got).abs().max()) > 0.1 * float(got.abs().max())


def test_fpg_on_an_odd_p5_raises_value_error_where_jax_raises_type_error():
    """On an 800x1344 canvas P5 is 25x42: JAX's FPG max-pools it to a 12x21
    P6 and adds the 13x21 stride-2 conv of P5 (``TypeError``); the port
    raises ``ValueError`` naming both sizes before it computes a stack."""
    from oadg_tpu.models.necks.more_necks import FPG as JaxFPG
    from oadg_tpu_torch.models.necks import FPG
    sides = [(200, 336), (100, 168), (50, 84), (25, 42)]
    ins = [jax.ShapeDtypeStruct((1, h, w, 4), jnp.float32) for h, w in sides]
    jm = JaxFPG(in_channels=(4,) * 4, out_channels=8, inter_channels=8, stack_times=1)
    with pytest.raises(TypeError, match=r"incompatible shapes.*12, 21.*13, 21"):
        jax.eval_shape(lambda r, x: jm.init(r, x), jax.random.PRNGKey(0), ins)
    mod = FPG(in_channels=[4] * 4, out_channels=8, inter_channels=8, stack_times=1)
    with pytest.raises(ValueError, match=r"level 3 \(25x42\) gives 13x21, level 4 is 12x21.*"
                                         r"P5 sides must be even"):
        mod([torch.zeros(1, 4, h, w) for h, w in sides])
    with torch.no_grad():             # an even P5 runs
        assert mod([torch.zeros(1, 4, h, w) for h, w in [(64, 96), (32, 48), (16, 24),
                                                          (8, 12)]])[4].shape == (1, 8, 4, 6)
