"""The port's reprojection geometry, Dense and Sparse reprojection losses and
IMU bias calibration vs the JAX package.

Inputs are drawn with numpy from fixed seeds at the shapes the PVGO tests use
(B = 8 motions, 16x24 maps) and go through both packages.  Tolerances: the
geometry is a few float32 ops in the same order, so values agree to a few
ulp (rtol 1e-5, atol 1e-5 px).  The dense loss is a mean over a few hundred
pixels of |reprojection - target| (~1-10 px): atol 1e-5 x its scale.
Gradients in the motions are sums of per-pixel sign(r) x dr/dm over the
masked pixels, in another order: atol 1e-4 x max|g|.  A pixel whose
residual sits within rounding of 0 could flip its sign between the two,
which the drawn flow keeps away from.  The bias objective preintegrates
~200 samples in float32 (the port by a log-depth prefix product, JAX by a
scan): rtol 1e-4 on the value, 1e-3 x max|g| on the gradient, and 1e-4 on
biases after ten Adam steps (each step is ~lr x sign(g), and the
histories agree to 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.data.synthetic import SyntheticTrajDataset as JSynthetic
from islam_tpu.imu import bias as jbias
from islam_tpu.imu.preintegrator import IMUState as JIMUState
from islam_tpu.lie import SE3
from islam_tpu.ops import dense_ba as jdba
from islam_tpu.ops import geometry as jgeo
from islam_tpu_torch import lie
from islam_tpu_torch.imu import bias as tbias
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.ops import dense_ba as tdba
from islam_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)

B, H, W, N = 8, 16, 24, 6
FX, FY, CX, CY = 10.0, 11.0, W / 2, H / 2
# camera -> IMU: a small rotation and offset, so the conjugation matters
RGB2IMU = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01, 0.9993], np.float32)
RGB2IMU[3:] /= np.linalg.norm(RGB2IMU[3:])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _motions(seed, scale=0.05):
    xi = np.random.default_rng(seed).normal(size=(B, 6)) * scale
    return np.asarray(lie.se3_exp(_t(xi.astype(np.float32))))


def _K():
    return np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("fn", ["pixel2point", "point2pixel",
                                "point2pixel_extrinsics", "reprojerr"])
def test_geometry_matches_jax(fn):
    rng = np.random.default_rng(3)
    pix = rng.uniform(0, 20, (B, N, 2)).astype(np.float32)
    depth = rng.uniform(1, 5, (B, N)).astype(np.float32)
    pts = np.concatenate([rng.normal(size=(B, N, 2)),
                          rng.uniform(1, 5, (B, N, 1))], -1).astype(np.float32)
    ext = _motions(4)[:, None]
    K = _K()
    if fn == "pixel2point":
        ref = jgeo.pixel2point(pix, depth, K)
        out = tgeo.pixel2point(_t(pix), _t(depth), _t(K))
    elif fn == "point2pixel":
        ref = jgeo.point2pixel(pts, K)
        out = tgeo.point2pixel(_t(pts), _t(K))
    elif fn == "point2pixel_extrinsics":
        ref = jgeo.point2pixel(pts, K, SE3(jnp.asarray(ext)))
        out = tgeo.point2pixel(_t(pts), _t(K), _t(ext))
    else:
        ref = jgeo.reprojerr(pts, pix, K, SE3(jnp.asarray(ext)))
        out = tgeo.reprojerr(_t(pts), _t(pix), _t(K), _t(ext))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _dense_inputs(seed):
    """Depth with a band of pixels at z <= 0.1 (masked by the projection),
    a random mask, and a flow of a few pixels."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(2, 6, (B, H, W)).astype(np.float32)
    depth[:, :, :3] = 0.05
    mask = rng.uniform(size=(B, H, W)) > 0.3
    flow = (rng.normal(size=(B, 2, H, W)) * 2.0 + 0.7).astype(np.float32)
    return depth, flow, mask


def _dense_pair(seed):
    depth, flow, mask = _dense_inputs(seed)
    j = jdba.DenseReprojectionLoss(depth, flow, FX, FY, CX, CY, mask,
                                   RGB2IMU)
    t = tdba.DenseReprojectionLoss(_t(depth), _t(flow), FX, FY, CX, CY,
                                   _t(mask), _t(RGB2IMU))
    return j, t


def _sparse_pair(seed):
    depth, flow, _ = _dense_inputs(seed)
    rng = np.random.default_rng(seed + 1)
    pts = np.floor(np.stack([rng.uniform(3, W - 1, (B, N)),
                             rng.uniform(0, H - 1, (B, N))], -1)
                   ).astype(np.float32)
    j = jdba.SparseReprojectionLoss(pts, depth, flow, FX, FY, CX, CY,
                                    RGB2IMU)
    t = tdba.SparseReprojectionLoss(_t(pts), _t(depth), _t(flow), FX, FY, CX,
                                    CY, _t(RGB2IMU))
    return j, t


def _value_and_grad(jloss, tloss, motion):
    jval = jloss(SE3(jnp.asarray(motion)))
    jg = jax.grad(lambda m: jnp.sum(jloss(SE3(m))))(jnp.asarray(motion))
    m = _t(motion).requires_grad_(True)
    tval = tloss(m)
    tval.sum().backward()
    return np.asarray(jval), np.asarray(jg), tval.detach().numpy(), \
        m.grad.numpy()


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_reprojection_loss_matches_jax(kind, seed):
    jloss, tloss = (_dense_pair if kind == "dense" else _sparse_pair)(seed)
    jval, jg, tval, tg = _value_and_grad(jloss, tloss, _motions(seed + 10))
    assert tval.shape == ((B,) if kind == "dense" else (B, N, 2))
    np.testing.assert_allclose(tval, jval, rtol=1e-5,
                               atol=1e-5 * np.abs(jval).max())
    assert np.isfinite(tg).all() and np.abs(tg).max() > 0
    np.testing.assert_allclose(tg, jg, atol=1e-4 * np.abs(jg).max())


def test_dense_loss_masked_division_has_finite_gradients():
    """Points behind the camera (z <= 0.1) are masked before the divide, so
    their gradient is 0 and not 0 x inf: with every point behind the camera
    the loss and its gradient are 0, and with a third of them at depth 0
    the gradient stays finite."""
    depth, flow, mask = _dense_inputs(5)
    out = []
    for d in (-np.ones_like(depth), np.where(depth > 4.5, 0.0, depth)):
        loss = tdba.DenseReprojectionLoss(_t(d.astype(np.float32)), _t(flow),
                                          FX, FY, CX, CY, _t(mask),
                                          _t(RGB2IMU))
        m = _t(_motions(6)).requires_grad_(True)
        val = loss(m)
        val.sum().backward()
        assert torch.isfinite(val).all() and torch.isfinite(m.grad).all()
        out.append((float(val.detach().abs().sum()),
                    float(m.grad.abs().max())))
    assert out[0] == (0.0, 0.0) and min(out[1]) > 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_replace_swaps_the_tensors(kind):
    """``replace`` rebuilds a loss around new tensors (the implicit mode's
    formal inputs) without touching the original."""
    _, loss = (_dense_pair if kind == "dense" else _sparse_pair)(1)
    motion = _t(_motions(11))
    before = loss(motion)
    assert all(t.is_floating_point() for t in loss.tensors())
    same = loss.replace(loss.tensors())
    assert torch.equal(same(motion), before)
    i = loss.FIELDS.index("rgb2imu_pose")
    moved = loss.replace(loss.tensors()[:i] + (lie.se3_identity(),)
                         + loss.tensors()[i + 1:])
    assert not torch.equal(moved(motion), before)
    assert torch.equal(loss(motion), before)


def _bias_inputs():
    ds = JSynthetic(num_frames=21)
    accels = ds.accels + np.asarray([0.05, -0.03, 0.02], np.float32)
    dts = np.asarray(ds.imu_dts, np.float32).reshape(-1)
    if dts.shape[0] < accels.shape[0]:
        dts = np.concatenate([dts, np.zeros(1, np.float32)])
    return ds, accels, dts


def test_bias_objective_matches_jax():
    ds, accels, dts = _bias_inputs()
    b = {"accel": np.asarray([0.01, 0.02, -0.01], np.float32),
         "gyro": np.asarray([0.001, -0.002, 0.003], np.float32)}
    init = {k: np.asarray(ds.imu_init[k], np.float32)
            for k in ("pos", "rot", "vel")}
    sync = np.asarray(ds.rgb2imu_sync)
    poses = np.asarray(ds.poses, np.float32)
    jval, jg = jax.value_and_grad(jbias.bias_objective)(
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(accels),
        jnp.asarray(ds.gyros, jnp.float32), jnp.asarray(dts),
        jnp.asarray(poses), jnp.asarray(sync, jnp.int32),
        JIMUState(**{k: jnp.asarray(v) for k, v in init.items()}),
        jnp.asarray(float(ds.gravity), jnp.float32))
    leaves = {k: _t(v).requires_grad_(True) for k, v in b.items()}
    tval = tbias.bias_objective(
        leaves, _t(accels.astype(np.float32)),
        _t(np.asarray(ds.gyros, np.float32)), _t(dts), _t(poses),
        _t(sync.astype(np.int64)), IMUState(**{k: _t(v)
                                               for k, v in init.items()}),
        torch.tensor(float(ds.gravity)))
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k in b:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-3 * gmax, err_msg=k)


@pytest.mark.parametrize("lr", [1e-2, 0.5])
def test_optimize_bias_matches_jax(lr):
    """Ten epochs of Adam from a nonzero gyro bias (at a zero rotation error
    the norm's gradient is the direction of float32 rounding, which differs
    between the two sides).  At lr 0.5 epochs 1-3 overshoot, the loss stays
    above epoch 0's for three epochs, and the plateau rule cuts the rate
    and restarts Adam, on both sides alike."""
    ds, accels, _ = _bias_inputs()
    kw = dict(lr=lr, epochs=10, poses=ds.poses, sync=ds.rgb2imu_sync,
              accels=accels, gyros=ds.gyros, accel_bias=np.zeros(3),
              gyro_bias=np.array([0.01, -0.02, 0.015]), dts=ds.imu_dts,
              init=ds.imu_init, gravity=ds.gravity)
    ja, jgy, jhist = jbias.optimize_bias(**kw)
    ta, tgy, thist = tbias.optimize_bias(**kw, device="cpu")
    assert len(thist) == 10
    if lr == 0.5:
        assert min(jhist[1:4]) > jhist[0]
    else:
        assert thist[-1] < thist[0] / 10
    np.testing.assert_allclose(thist, jhist, rtol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=1e-4)
