"""The tiny OA-DG YOLOv3 step of the port against the JAX package's, on the
CPU: the slice as a whole (``test_torch_yolo.py`` holds each module).

``torch_yolo_cases.model_cfg()`` (full Darknet-53, the neck and head
narrowed) on 2 images x 2 views at 64x64 (view 2 is view 1 plus noise; one
padded gt), the JAX variables randomized (every BN's affine and stored
statistics, prediction convs of std 0.3) and carried over by
``jax_variables_to_state_dict``; the JAX ``forward_train`` runs with its
sampling key fixed and the port is handed the uniforms JAX draws from it for
the cont rows. Then one SGD step. Darknet-53 alone at 32x32 on the same
variables.

Tolerances:
- float32: losses rtol 1e-4; every gradient rtol 1e-3 with an absolute
  floor of 3e-4 of its largest (measured 1.6e-4: 52 layers of reassociated
  sums); the BN moving statistics rtol 1e-4 with a floor of 1e-5 of the
  largest; the parameters after SGD 1e-6; Darknet-53's levels rtol 1e-4 with
  a floor of 1e-5 of each level's largest;
- bfloat16: the live BNs at the coarsest level (2x2 here: 16 values a
  channel, means up to 11x the spread) amplify each rounding 7x a layer, so
  at this size two correct bfloat16 steps are about as far from each other
  as either is from float32 (JAX bfloat16 against JAX float32: losses up to
  4.7% apart, the median gradient 69% of its largest magnitude apart; the
  port's against JAX's: losses up to 3.5%, median gradient 57%), and the
  bfloat16 tolerances of ``test_torch_bf16.py`` (where the frozen BNs fold
  and nothing renormalizes) cannot hold. So, leaf by leaf, each loss, each
  live BN's batch statistics (from the moving ones) and each gradient of
  the port's bfloat16 step is held to JAX's bfloat16 step within
  ``BF16_RATIO`` (3.5) times JAX's own distance from its float32 step, plus
  2**-8 of the float32 value's largest magnitude. Measured without a fault:
  the worst leaf at 0.52 of its limit (``loss_conf``). Planted bfloat16-only
  faults, the worst leaf in shares of its limit: LeakyReLU slope 0.01
  everywhere 28.1, in the neck's ``DetectionBlock``s 7.1, in the head's
  bridge convs 3.1; the head's bridge BNs on their stored statistics 61.3;
  the live statistics summed in bfloat16 2.1. A fault of precision alone
  (the BN affine applied in float32 and rounded once) reads 0.62 here and
  is held where rounding does not compound: ``test_torch_yolo.py``'s
  ``ConvModule`` (one bfloat16 step on at most 1e-3 of values; measured <= 2e-5;
  the planted fault fails it in all three modes) and head (two steps). The
  whole gradient's cosine to JAX's float32 one must also reach JAX's
  bfloat16 one's minus 0.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_yolo_cases as cases
from oadg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from oadg_tpu.models.backbones.darknet import Darknet as JDarknet
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.config import load_config
from oadg_tpu_torch.engine import build_optimizer
from oadg_tpu_torch.models.backbones import Darknet
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict
from oadg_tpu_torch.utils.draws import UniformDraws

torch.set_num_threads(2)
BF16 = torch.bfloat16
BF16_RATIO = 3.5
BN_MOMENTUM = 0.1                       # the config's BN (torch momentum)


@pytest.fixture(scope="module")
def slice_run():
    """The tiny OA-DG YOLOv3 on 2 images x 2 views at 64x64: JAX's training
    forward in float32 and bfloat16 on the same variables, and the port's."""
    model = cases.model_cfg()
    batch = cases.views_batch()
    j32 = cases.jax_detector(model, 2)
    variables = cases.jax_variables(j32, batch)
    out = dict(model=model, batch=batch, variables=variables)
    out["jax"] = {"float32": cases.jax_train(j32, variables, batch),
                  "bfloat16": cases.jax_train(cases.jax_detector(model, 2, jnp.bfloat16),
                                              variables, batch)}
    tb = cases.torch_batch(batch)
    for name, dtype in (("float32", None), ("bfloat16", BF16)):
        det = init_detector({"model": model}, device="cpu", num_views=2, dtype=dtype).model
        det.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
        draws = UniformDraws(given=cases.cont_draws(2, 252))
        losses = det.forward_train(tb, draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        assert set(draws.drawn) == {"cont"}
        out[name] = dict(det=det, losses={k: float(v.detach()) for k, v in losses.items()},
                         grads={k: p.grad.clone() for k, p in det.named_parameters()})
    return out


@pytest.mark.parametrize("key", cases.LOSS_KEYS)
def test_slice_loss_matches_jax(slice_run, key):
    got, want = slice_run["float32"]["losses"][key], float(slice_run["jax"]["float32"][0][key])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got) and got > 0


def test_slice_every_gradient_matches_jax(slice_run):
    det = slice_run["float32"]["det"]
    want = jax_variables_to_state_dict({"params": slice_run["jax"]["float32"][1]})
    params = dict(det.named_parameters())
    assert set(want) == set(params) and all(p.requires_grad for p in params.values())
    assert len(params) == 3 * (52 + 17 + 6) + 2 * 3      # ConvModules, prediction convs
    for name, g in slice_run["float32"]["grads"].items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=3e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_slice_bn_statistics_match_jax(slice_run):
    """Moving statistics after the training forward: the neck's and head's
    moved as JAX's did, the backbone's (``norm_eval``) did not move."""
    det = slice_run["float32"]["det"]
    want = jax_variables_to_state_dict({"batch_stats": slice_run["jax"]["float32"][2]})
    before = jax_variables_to_state_dict({"batch_stats": slice_run["variables"]["batch_stats"]})
    sd = det.state_dict()
    assert set(want) == {k for k in sd if "running_" in k}
    for name, w in want.items():
        cases.close(sd[name].numpy(), w.numpy(), 1e-4, 1e-5)
        assert torch.equal(sd[name], before[name]) == name.startswith("backbone."), name


def test_slice_sgd_step_matches_jax(slice_run):
    """One SGD step (the config's momentum, weight decay on every parameter
    and the BN affines, grad_clip 35) on the JAX gradients, against the JAX
    optimizer's."""
    cfg = load_config(cases.YOLO_OADG)
    det = slice_run["float32"]["det"]
    grads = jax_variables_to_state_dict({"params": slice_run["jax"]["float32"][1]})
    before = {k: p.detach().clone() for k, p in det.named_parameters()}
    opt = build_optimizer(det, cfg.optimizer, grad_clip=cfg.optimizer_config["grad_clip"])
    for name, p in det.named_parameters():
        p.grad = grads[name].clone()
    opt.step()
    jparams = slice_run["variables"]["params"]
    tx = jax_build_optimizer(jparams, cfg.optimizer, lambda t: cfg.optimizer["lr"],
                             model_cfg=slice_run["model"],
                             grad_clip=cfg.optimizer_config["grad_clip"])
    jafter = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(slice_run["jax"]["float32"][1], jparams))})
    for name, p in det.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jafter[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        assert not torch.equal(p.detach(), before[name]), name
    with torch.no_grad():
        for name, p in det.named_parameters():
            p.copy_(before[name])


def _flat(grads):
    return np.concatenate([g.numpy().reshape(-1) for g in grads.values()]).astype(np.float64)


def _cos(a, b):
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def test_slice_bfloat16_is_as_close_to_float32_as_jax(slice_run):
    """See the module docstring: the port's bfloat16 step against JAX's
    float32 step, no farther than JAX's bfloat16 step is."""
    j32, jbf = slice_run["jax"]["float32"], slice_run["jax"]["bfloat16"]
    port = slice_run["bfloat16"]
    assert port["det"].dtype == BF16
    for key in cases.LOSS_KEYS:
        ref = float(j32[0][key])
        own = abs(float(jbf[0][key]) - ref)
        assert abs(port["losses"][key] - ref) <= 2 * own + 2 ** -6 * abs(ref), key
    names = list(port["grads"])
    jbf_sd = jax_variables_to_state_dict({"params": jbf[1]})
    j32_sd = jax_variables_to_state_dict({"params": j32[1]})
    jax_bf = _flat({k: jbf_sd[k] for k in names})
    ref = _flat({k: j32_sd[k] for k in names})
    got = _flat(port["grads"])
    assert all(g.dtype == torch.float32 for g in port["grads"].values())
    assert _cos(got, ref) >= _cos(jax_bf, ref) - 0.05


def _batch_stats(stats, before):
    """Each live BN's batch statistics, from its moving ones after the step."""
    return {k: (v - (1 - BN_MOMENTUM) * before[k]) / BN_MOMENTUM for k, v in stats.items()
            if not k.startswith("backbone.")}


def test_slice_bfloat16_matches_jax_bfloat16_leaf_by_leaf(slice_run):
    """See the module docstring: each loss, live BN statistic and gradient
    of the port's bfloat16 step against JAX's bfloat16 step, within
    ``BF16_RATIO`` times JAX's own bfloat16-to-float32 distance."""
    j32, jbf, port = slice_run["jax"]["float32"], slice_run["jax"]["bfloat16"], slice_run["bfloat16"]
    before = jax_variables_to_state_dict({"batch_stats": slice_run["variables"]["batch_stats"]})
    state = port["det"].state_dict()
    leaves = [("loss " + k, np.float32(port["losses"][k]), np.float32(jbf[0][k]),
               np.float32(j32[0][k])) for k in cases.LOSS_KEYS]
    want = [_batch_stats(jax_variables_to_state_dict({"batch_stats": j[2]}), before)
            for j in (jbf, j32)]
    got = _batch_stats({k: state[k] for k in want[0]}, before)
    assert len(got) == 2 * 23                           # 17 neck and 6 head BNs
    leaves += [(k, got[k].numpy(), want[0][k].numpy(), want[1][k].numpy()) for k in got]
    grads = [jax_variables_to_state_dict({"params": j[1]}) for j in (jbf, j32)]
    leaves += [(k, g.numpy(), grads[0][k].numpy(), grads[1][k].numpy())
               for k, g in port["grads"].items()]
    ratios = {}
    for name, g, wb, w32 in leaves:
        lim = BF16_RATIO * np.abs(wb - w32).max() + 2 ** -8 * np.abs(w32).max()
        ratios[name] = np.abs(g - wb).max() / lim
    worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
    print("bfloat16 leaves against JAX's, worst (share of the limit):",
          [(k, round(float(ratios[k]), 3)) for k in worst])
    assert ratios[worst[0]] <= 1, [(k, ratios[k]) for k in worst]


def test_darknet_matches_jax(slice_run):
    """Darknet-53 at 32x32 in eval mode on the slice's randomized variables."""
    v = {c: slice_run["variables"][c]["backbone_m"] for c in ("params", "batch_stats")}
    x = np.random.RandomState(4).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: JDarknet().apply(v, x))(v, jnp.asarray(x))
    m = Darknet()
    m.load_state_dict(cases.port_state(v, "backbone_m", "backbone."), strict=True)
    m.eval()
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [g.shape[1:] for g in got] == [(256, 4, 4), (512, 2, 2), (1024, 1, 1)]
    for g, w in zip(got, want):
        cases.close(cases.nhwc(g), w, 1e-4, 1e-5)
