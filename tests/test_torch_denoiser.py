"""Port IMU denoiser vs the JAX package: the network, its padded token rule,
its parameter gradients, the denoised window integration and the reading
of a reference ``.pkl``.

Both sides hold the JAX initialiser's parameters (PRNGKey(1)), carried
over with ``denoiser_state_dict_from_jax``, and get the same numpy samples.

Tolerances.  The corrections come out of a 64-wide conv, a GRU and two
Linear layers in float32, summed in different orders (XLA:CPU vs oneDNN):
~1e-7 apart, atol 1e-5.  Gradients are compared leaf by leaf at
atol 1e-3 x max|g| of the leaf.  The integrated window is float32 prefix
products and sums, as in tests/test_torch_imu.py: atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.imu import denoiser as jdn
from islam_tpu.imu.module import integrate_window as jintegrate
from islam_tpu.train import _import_denoiser
from islam_tpu.utils import checkpoints as jckpt
from islam_tpu_torch.imu import denoiser as tdn
from islam_tpu_torch.imu.module import IMUModule, integrate_window
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.utils.checkpoints import (DENOISER_KEYS, import_denoiser,
                                               load_torch_state_dict)
from islam_tpu_torch.utils.weights import denoiser_state_dict_from_jax

from tests.rng_helpers import PerTestRNG

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

RNG = PerTestRNG("torch-denoiser")
S = 60


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    model = tdn.IMUDenoiser()
    model.load_state_dict(denoiser_state_dict_from_jax(jp))
    return jp, model


def _samples(n_valid):
    acc = RNG.normal(size=(S, 3)).astype(np.float32)
    gyro = RNG.normal(size=(S, 3)).astype(np.float32)
    acc[n_valid:] = 0.0
    gyro[n_valid:] = 0.0
    return acc, gyro


def test_state_dict_keys_are_the_reference_keys(params):
    _, model = params
    assert tuple(model.state_dict()) == DENOISER_KEYS


@pytest.mark.parametrize("n_valid", [5, 37, S])
def test_denoise_matches_jax(params, n_valid):
    jp, model = params
    acc, gyro = _samples(n_valid)
    ja, jg = jdn.denoise(jp, acc, gyro, jnp.asarray(n_valid))
    ta, tg = tdn.denoise(model, torch.from_numpy(acc), torch.from_numpy(gyro),
                         torch.tensor(n_valid))
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), atol=1e-5)
    if n_valid < tdn.TOKEN:  # no correction below one token
        np.testing.assert_array_equal(ta.detach().numpy(), acc)


@pytest.mark.parametrize("n_valid", [5, 37, S])
def test_denoise_gradients_match_jax(params, n_valid):
    jp, model = params
    acc, gyro = _samples(n_valid)
    wa = RNG.normal(size=(S, 3)).astype(np.float32)
    wg = RNG.normal(size=(S, 3)).astype(np.float32)

    def jloss(p):
        a, g = jdn.denoise(p, acc, gyro, jnp.asarray(n_valid))
        return jnp.sum(a * wa) + jnp.sum(g * wg)

    jgrads = denoiser_state_dict_from_jax(jax.device_get(jax.grad(jloss)(jp)))
    model.zero_grad()
    ta, tg = tdn.denoise(model, torch.from_numpy(acc), torch.from_numpy(gyro),
                         torch.tensor(n_valid))
    (torch.sum(ta * torch.from_numpy(wa))
     + torch.sum(tg * torch.from_numpy(wg))).backward()
    for k, p in model.named_parameters():
        ref = jgrads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref,
                                   atol=1e-3 * np.abs(ref).max() + 1e-12,
                                   err_msg=k)


def test_padded_samples_do_not_change_valid_outputs(params):
    """Tokens past n_valid // 10 are never read, and the GRU is causal."""
    _, model = params
    n_valid = 37
    acc, gyro = _samples(n_valid)
    noisy_acc, noisy_gyro = acc.copy(), gyro.copy()
    noisy_acc[n_valid:] = RNG.normal(size=(S - n_valid, 3))
    noisy_gyro[n_valid:] = RNG.normal(size=(S - n_valid, 3))
    nv = torch.tensor(n_valid)
    with torch.no_grad():
        a1, g1 = tdn.denoise(model, torch.from_numpy(acc),
                             torch.from_numpy(gyro), nv)
        a2, g2 = tdn.denoise(model, torch.from_numpy(noisy_acc),
                             torch.from_numpy(noisy_gyro), nv)
    torch.testing.assert_close(a1[:n_valid], a2[:n_valid], rtol=0, atol=0)
    torch.testing.assert_close(g1[:n_valid], g2[:n_valid], rtol=0, atol=0)


def test_init_denoiser_is_seeded_and_bounded():
    a, b = tdn.init_denoiser(1, "cpu"), tdn.init_denoiser(1, "cpu")
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    w = a.conv1.weight.detach()
    assert float(w.abs().max()) <= 1.0 / np.sqrt(60) and float(w.std()) > 0
    assert float(a.pose_decoder[2].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("nested", [False, True])
def test_pkl_reads_like_the_jax_loader(params, tmp_path, nested):
    """A reference .pkl (plain or with a nested ``state_dict``) gives the
    port the same denoiser as ``_import_denoiser`` gives the JAX package."""
    jp, model = params
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "dn.pkl")
    torch.save({"state_dict": sd, "epoch": 3} if nested else sd, path)
    port = import_denoiser(load_torch_state_dict(path))
    ref = denoiser_state_dict_from_jax(
        _import_denoiser(jp, jckpt.load_torch_state_dict(path)))
    assert tuple(port) == tuple(ref) == DENOISER_KEYS
    for k in DENOISER_KEYS:
        assert torch.equal(port[k], ref[k]), k


def test_integrate_window_with_denoiser_matches_jax(params):
    """The denoised window (accel corrected, gyro not, as on KITTI-type
    data) in world and motion modes, and the module's bias flag."""
    jp, model = params
    B = 4
    ds = jtesting.make_dataset(num_frames=2 * B + 1, height=64, width=128)
    jimu = jtesting.make_imu_module(ds, batch_frames=B, denoise_params=jp)
    timu = IMUModule(ds.accels, ds.gyros, ds.imu_dts, ds.accel_bias,
                     ds.gyro_bias, gravity=ds.gravity,
                     rgb2imu_sync=ds.rgb2imu_sync, denoise_params=model,
                     denoise_accel=True, denoise_gyro=False, batch_frames=B,
                     device="cpu")
    assert timu.optm_bias is False and timu.optm_bias == jimu.optm_bias
    init = ds.imu_init
    jinit = jtesting.make_step_inputs(ds, jimu, 0, B)[2]
    tinit = IMUState(*(torch.tensor(np.asarray(init[k]), dtype=torch.float32)
                       for k in ("pos", "rot", "vel")))
    for st in (0, B):
        ref = jintegrate(jp, *jimu.window_inputs(st, st + B), jinit,
                         jimu.gravity, jimu.accel_bias, jimu.gyro_bias,
                         jnp.asarray(False), denoise_accel=True,
                         denoise_gyro=False)
        with torch.no_grad():
            out = integrate_window(model, *timu.window_inputs(st, st + B),
                                   tinit, timu.gravity, timu.accel_bias,
                                   timu.gyro_bias, torch.tensor(False),
                                   denoise_accel=True, denoise_gyro=False)
        for k in ("pos", "rot", "vel", "dpos", "drot", "dvel"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-5, err_msg=k)
