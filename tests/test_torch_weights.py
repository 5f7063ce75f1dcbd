"""The JAX-variables -> port state_dict bridge.

Every flax leaf of the JAX VONet maps to exactly one port key, every port
key is filled with the right shape, and the port's state_dict goes back
through the JAX package's own importer to the same flax tree, bit for bit.
"""

import jax
import numpy as np
import pytest

from islam_tpu.models import tartanvo as jtvo
from islam_tpu.utils import checkpoints as ckpt
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.utils import weights as W
from tests.test_torch_slice import shared_jax_init  # noqa: F401

H, WD = 64, 128


@pytest.fixture(scope="module")
def variables():
    return jax.device_get(jtvo.init_params(jax.random.PRNGKey(0), H, WD))


def _paths(variables):
    return [tuple(p.key for p in kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(variables)[0]]


def test_key_rules_match_the_jax_package(variables):
    for path in _paths(variables):
        assert W.flax_path_to_torch_key(path) == ckpt.flax_path_to_torch_key(
            path), path


def test_every_leaf_maps_and_every_port_key_is_filled(variables):
    sd = W.state_dict_from_jax(variables)
    assert len(sd) == len(_paths(variables))  # no two leaves share a key
    port = VONet(H, WD).state_dict()
    assert set(sd) == set(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    VONet(H, WD).load_state_dict(sd, strict=True)


def test_round_trip_through_import_torch_weights(variables):
    sd = {k: v.numpy() for k, v in W.state_dict_from_jax(variables).items()}
    blank = jax.tree_util.tree_map(np.zeros_like, variables)
    back = ckpt.import_torch_weights(blank, sd)
    for a, b in zip(jax.tree_util.tree_leaves(variables),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("path,expect", [
    (("params", "flowNet", "deconv6", "kernel"), "flowNet.deconv6.weight"),
    (("params", "flowPoseNet", "trans_fc1", "fc", "kernel"),
     "flowPoseNet.voflow_trans.0.0.weight"),
    (("batch_stats", "stereoNet", "feature_extraction", "firstconv_0", "bn",
      "mean"), "stereoNet.feature_extraction.firstconv.0.1.running_mean"),
])
def test_layout_moves(path, expect):
    rng = np.random.default_rng(0)
    shape = {4: (4, 3, 5, 6), 5: (7, 9), 6: (8,)}[len(path)]
    v = rng.normal(size=shape).astype(np.float32)
    assert W.flax_path_to_torch_key(path) == expect
    out = W.flax_value_to_torch(path, v)
    if len(shape) == 4:  # transposed conv: pre-flipped HWIO -> (in, out, k, k)
        np.testing.assert_array_equal(
            out, v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        back = ckpt.torch_value_to_flax(path, out, v.shape)
        np.testing.assert_array_equal(back, v)
    elif len(shape) == 2:
        np.testing.assert_array_equal(out, v.T)
    else:
        np.testing.assert_array_equal(out, v)
