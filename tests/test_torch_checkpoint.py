"""Converter round trip between the port's state_dict and the JAX tree.

port state_dict -> ``oadg_tpu.utils.checkpoint.convert_torch_state_dict``
-> JAX variables (``merge_variables`` into the tiny flagship detector's
init tree reports 0 mismatches and uses every leaf) ->
``jax_variables_to_state_dict`` -> the original state_dict, exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_model_cfg
from oadg_tpu.models import build_detector as jax_build_detector
from oadg_tpu.utils.checkpoint import convert_torch_state_dict, merge_variables
from oadg_tpu_torch.apis import init_detector
from oadg_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

torch.set_num_threads(2)


class _Log:
    def __init__(self):
        self.msgs = []

    def warning(self, m):
        self.msgs.append(m)

    def info(self, m):
        self.msgs.append(m)


def _port_state_dict():
    _, model = _flagship_model_cfg(tiny=True)
    handle = init_detector({"model": model}, device="cpu", seed=3)
    sd = handle.model.state_dict()
    gen = torch.Generator().manual_seed(4)
    for k, v in sd.items():             # random BN statistics and biases too
        if k.endswith(("running_var", "bn1.weight")):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
        elif k.endswith(("running_mean", "bias")):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
    return model, sd


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_round_trip_through_the_jax_tree():
    model, sd = _port_state_dict()
    loaded = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                      roi_feat_size=7, roi_channels=16)
    jdet = jax_build_detector(model, num_views=1)
    batch = {"img": jnp.zeros((1, 64, 64, 3)),
             "img_shape": jnp.asarray([[64.0, 64.0]]),
             "scale_factor": jnp.ones((1, 4))}
    init = jax.jit(lambda r, b: jdet.init(r, b, "test"))(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch)
    log = _Log()
    merged = merge_variables(init, loaded, logger=log)
    stats = [m for m in log.msgs if m.startswith("checkpoint merge")]
    assert stats == [f"checkpoint merge: {{'loaded_used': {_leaf_count(init)}, "
                     "'mismatched': 0}"], log.msgs
    back = jax_variables_to_state_dict(merged, roi_feat_size=7, roi_channels=16)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_first_shared_fc_reorders_chw_to_hwc():
    _, sd = _port_state_dict()
    w = sd["roi_head.bbox_head.shared_fcs.0.weight"].numpy()       # (32, C*49)
    loaded = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                      roi_feat_size=7, roi_channels=16)
    kernel = loaded["params"]["roi"]["head"]["shared_fc0"]["kernel"]  # (49*C, 32)
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 7, 7)).astype(np.float32)             # C, H, W
    np.testing.assert_allclose(x.transpose(1, 2, 0).reshape(-1) @ kernel,
                               w @ x.reshape(-1), rtol=1e-5, atol=1e-5)


def test_unknown_leaf_raises():
    with pytest.raises(KeyError, match="no mmdet name"):
        jax_variables_to_state_dict({"params": {"mystery": {"kernel": np.zeros((2, 2))}}})


def test_init_detector_loads_a_saved_state_dict(tmp_path):
    model, sd = _port_state_dict()
    path = tmp_path / "weights.pth"
    torch.save({"state_dict": dict(sd, **{
        "backbone.bn1.num_batches_tracked": torch.tensor(0)})}, path)
    handle = init_detector({"model": model}, checkpoint=path, device="cpu")
    got = handle.model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
