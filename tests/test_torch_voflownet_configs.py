"""``VOFlowRes`` configs 0, 2 and 3 and ``down_scale=False`` against the JAX
module, at the pose head's input for 64x128 images (B=2, 16x32).

Parameters come from ``jax.eval_shape`` of the JAX module's ``init``,
filled from a seed (tests/test_torch_variants.py::jax_variables), and
cross over with ``state_dict_from_jax``.  Forward outputs are held to 1e-4
relative (rtol, and atol 1e-4 of the output's scale): float32 convolution
stacks that sum in other orders.  The state-dict keys must be the port's
exactly, and a ``.pkl`` of the port's weights loads back bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from islam_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_variants import _nchw, _roundtrip, jax_variables

torch.set_num_threads(1)

B, H4, W4 = 2, 16, 32


@pytest.mark.parametrize("config,down_scale,stereo", [
    (0, True, 0), (2, True, 0), (3, True, 0), (1, False, 0), (3, True, 2.2),
], ids=["config0", "config2", "config3", "config1-full-depth",
        "config3-multicam"])
def test_voflowres_config_matches_jax(config, down_scale, stereo, tmp_path):
    from islam_tpu.models.voflownet import VOFlowRes as JVOFlowRes
    from islam_tpu_torch.models.voflownet import VOFlowRes, flat_features

    rng = np.random.default_rng(30 + config)
    cin = 6 if stereo else 4
    x = rng.normal(size=(B, H4, W4, cin)).astype(np.float32)
    ext = rng.normal(size=(B, 6)).astype(np.float32)
    args = (x, ext) if stereo else (x,)
    jm = JVOFlowRes(config=config, down_scale=down_scale, stereo=stereo)
    v = jax.device_get(jax_variables(jm, *args, seed=40 + config))
    sd = state_dict_from_jax(v)
    model = VOFlowRes(H4, W4, stereo=stereo, config=config,
                      down_scale=down_scale)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    nf = flat_features(H4, W4, config, down_scale)
    assert model.voflow_rot[0][0].in_features == nf
    n_layers = 7 if not down_scale else 5
    assert f"feat_net.{2 + n_layers}.0.conv1.0.weight" in sd
    assert f"feat_net.{3 + n_layers}.0.conv1.0.weight" not in sd

    ref = np.asarray(jax.jit(jm.apply)(v, *args))
    with torch.no_grad():
        out = model(_nchw(x), *(torch.from_numpy(ext),) * bool(stereo))
    assert out.shape == (B, 6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    _roundtrip(model, tmp_path)
