"""Port IMU preintegration and windowing vs the JAX package.

Both sides integrate the synthetic trajectory's IMU in float32.  The port's
quaternion prefix product is a Hillis-Steele scan where JAX uses its own
associative scan, so products associate differently: quaternions agree to
~1e-6, and positions, built by two cumulative sums over ~40 samples, to
~1e-5 (atol 2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.imu import preintegrator as jpre
from islam_tpu.imu.module import integrate_window as jintegrate
from islam_tpu_torch.imu import preintegrator as tpre
from islam_tpu_torch.imu.denoiser import init_denoiser
from islam_tpu_torch.imu.module import IMUModule, integrate_window
from islam_tpu_torch.train import make_transform

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-imu")
B = 4


@pytest.fixture(scope="module")
def data():
    ds = jtesting.make_dataset(num_frames=2 * B + 1, height=64, width=128)
    return ds, jtesting.make_imu_module(ds, batch_frames=B)


def _port_module(ds):
    return IMUModule(ds.accels, ds.gyros, ds.imu_dts, ds.accel_bias,
                     ds.gyro_bias, gravity=ds.gravity,
                     rgb2imu_sync=ds.rgb2imu_sync, denoise_accel=True,
                     denoise_gyro=False, batch_frames=B, device="cpu")


def _state(init):
    return tpre.IMUState(*(torch.tensor(np.asarray(init[k]),
                                        dtype=torch.float32)
                           for k in ("pos", "rot", "vel")))


@pytest.mark.parametrize("n", [1, 7, 33])
def test_preintegrate(n):
    dts = RNG.uniform(0.005, 0.02, n).astype(np.float32)
    gyros = RNG.normal(size=(n, 3)).astype(np.float32)
    accels = RNG.normal(size=(n, 3)).astype(np.float32) + [0, 0, 9.81]
    valid = np.arange(n) < max(1, n - 3)
    q0 = RNG.normal(size=4)
    init = {"pos": RNG.normal(size=3), "rot": q0 / np.linalg.norm(q0),
            "vel": RNG.normal(size=3)}
    jinit = jpre.IMUState(*(jnp.asarray(init[k], jnp.float32)
                            for k in ("pos", "rot", "vel")))
    ref = jpre.preintegrate(dts, gyros, accels.astype(np.float32), jinit,
                            9.81, valid=valid)
    out = tpre.preintegrate(torch.from_numpy(dts), torch.from_numpy(gyros),
                            torch.from_numpy(accels.astype(np.float32)),
                            _state(init), 9.81, valid=torch.from_numpy(valid))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)


def test_window_inputs_match(data):
    ds, jimu = data
    timu = _port_module(ds)
    assert timu.S == jimu.S and timu.optm_bias == jimu.optm_bias
    for st in (0, B):
        for t, j in zip(timu.window_inputs(st, st + B),
                        jimu.window_inputs(st, st + B)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_integrate_window_both_modes(data):
    ds, jimu = data
    timu = _port_module(ds)
    init = ds.imu_init
    jinit = jpre.IMUState(*(jnp.asarray(np.asarray(init[k]), jnp.float32)
                            for k in ("pos", "rot", "vel")))
    for st in (0, B):
        ref = jintegrate(None, *jimu.window_inputs(st, st + B), jinit,
                         jimu.gravity, jimu.accel_bias, jimu.gyro_bias,
                         jnp.asarray(True), denoise_accel=True,
                         denoise_gyro=False)
        out = integrate_window(None, *timu.window_inputs(st, st + B),
                               _state(init), timu.gravity, timu.accel_bias,
                               timu.gyro_bias, torch.tensor(True),
                               denoise_accel=True, denoise_gyro=False)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-5, err_msg=k)


def test_denoiser_is_not_ported_yet(data):
    """The name dates from before ``integrate_window`` took a denoiser
    (tests/test_torch_denoiser.py holds the denoiser against JAX).  It
    checks that a denoiser with ``denoise_gyro=False`` corrects the accel
    only: the rotations, which the gyro alone drives, are the bias path's
    bit for bit, and the positions are not."""
    ds, _ = data
    timu = _port_module(ds)
    args = (*timu.window_inputs(0, B), _state(ds.imu_init), timu.gravity,
            timu.accel_bias, timu.gyro_bias)
    with torch.no_grad():
        bias = integrate_window(None, *args, torch.tensor(True),
                                denoise_accel=True, denoise_gyro=False)
        denoised = integrate_window(init_denoiser(1, "cpu"), *args,
                                    torch.tensor(False), denoise_accel=True,
                                    denoise_gyro=False)
    for k in ("rot", "drot"):
        assert torch.equal(denoised[k], bias[k]), k
    assert not torch.equal(denoised["pos"], bias["pos"])


def test_port_dataset_matches_jax_dataset():
    """The port's copy of the synthetic dataset and transform pipeline gives
    the JAX package's samples, array for array."""
    from islam_tpu_torch.data.dataset import collate
    from islam_tpu_torch.data.synthetic import SyntheticTrajDataset

    jds = jtesting.make_dataset(num_frames=5, height=64, width=128, seed=3)
    tds = SyntheticTrajDataset(num_frames=5, height=64, width=128, seed=3,
                               transform=make_transform(64, 128))
    for attr in ("accels", "gyros", "imu_dts", "poses", "vels", "motions",
                 "rgb2imu_sync", "rgb2imu_pose", "intrinsic"):
        np.testing.assert_array_equal(getattr(tds, attr), getattr(jds, attr))
    ts = collate([tds[i] for i in range(2)])
    js = jtesting.collate([jds[i] for i in range(2)])
    assert set(ts) == set(js)
    for k, v in js.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ts[k], v, err_msg=k)
