"""``--bf16`` on the port vs the JAX package: the VO forward in bfloat16.

One ``tvo.init_params`` at 64x128, B=2, carried into the port with
``state_dict_from_jax``, and one synthetic window (``tests/test_bf16.py``'s)
made with numpy.  Only JAX's bfloat16 forward is compiled.

Tolerances.  Two bfloat16 stacks that round at other places differ about as
much as either differs from float32 (measured on this input: the port's
bfloat16 motion is 2.7e-3 from JAX's, and 3.6e-3 from its own float32
motion; the raw pose head output 2.5e-2 on a scale of 2.4 in both): the
motions are held at atol 1e-2, half of ``tests/test_bf16.py``'s bfloat16
bound.  The 'vo' gradient of the float32 pose head through the bfloat16
network is held to the float32 one at 0.25 x max|g| and a cosine of 0.95
(measured: 0.163 x max|g|, cosine 0.988; the CPU's bfloat16 convolutions
may take other code paths on another CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.data.dataset import collate as jcollate
from islam_tpu.models import tartanvo as jtvo
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.imu.module import IMUModule
from islam_tpu_torch.models import tartanvo as ttvo
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.ops import correlation as corr
from islam_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_slice import shared_jax_init  # noqa: F401

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B = 64, 128, 2
MOTION_ATOL = 1e-2
GRAD_RTOL, GRAD_COS = 0.25, 0.95


@pytest.fixture(scope="module")
def case():
    ds = jtesting.make_dataset(num_frames=B + 1, height=H, width=W)
    sample = jcollate([ds[i] for i in range(B)])
    batch = jtesting.device_batch(sample, 0)
    variables = jax.device_get(jtvo.init_params(jax.random.PRNGKey(0), H, W))
    res = jtvo.forward(
        variables, batch["img0"], batch["img1"], batch["img0_norm"],
        batch["img0_r_norm"], batch["intrinsic"], batch["intrinsic_calib"],
        jnp.linalg.norm(batch["extrinsic"][:, :3], axis=1),
        gt_motion=batch["motion"], frames=batch.get("frames"),
        datatype="kitti", correct_scale=True, use_kitti_coord=True,
        is_train=True, bf16=True)
    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    return {"ds": ds, "jmotion": np.asarray(res["motion"]), "model": model,
            "batch": tb}


def _forward(case, bf16):
    b = case["batch"]
    return ttvo.forward(
        case["model"], b["img0"], b["img1"], b["img0_norm"], b["img0_r_norm"],
        b["intrinsic"], b["intrinsic_calib"],
        torch.linalg.norm(b["extrinsic"][:, :3], dim=1),
        frames=b.get("frames"), datatype="kitti", use_kitti_coord=True,
        correct_scale=True, gt_motion=b["motion"], bf16=bf16)


def test_bf16_forward_matches_jax(case):
    with torch.no_grad():
        motion = _forward(case, True)["motion"]
    assert motion.dtype == torch.float32  # cast back before the geometry
    np.testing.assert_allclose(motion.numpy(), case["jmotion"],
                               atol=MOTION_ATOL)


def test_bf16_networks_run_in_bf16(case):
    """The three networks compute in bfloat16; the parameters stay float32."""
    out = {}
    model = case["model"]
    hooks = [getattr(model, n).register_forward_hook(
        lambda m, i, o, n=n: out.__setitem__(
            n, [t.dtype for t in (o if isinstance(o, tuple) else (o,))
                if torch.is_tensor(t)]))
        for n in ("flowNet", "stereoNet", "flowPoseNet")]
    try:
        with torch.no_grad():
            _forward(case, True)
    finally:
        for h in hooks:
            h.remove()
    assert out and all(d == torch.bfloat16 for ds in out.values()
                       for d in ds), out
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_bf16_correlations_take_bf16(case, monkeypatch):
    """Every correlation of the bfloat16 forward gets two bfloat16 tensors:
    a float32 tensor made inside the network would promote f2 on the CPU
    and make the card's kernel raise."""
    seen = []
    plain = corr.correlation_reference

    def record(f1, f2, md=corr.MD_DEFAULT):
        seen.append((f1.dtype, f2.dtype))
        return plain(f1, f2, md)

    monkeypatch.setattr(corr, "correlation_reference", record)
    with torch.no_grad():
        _forward(case, True)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 5


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "correlation_cuda"),
    (torch.bfloat16, "correlation_all_cuda")])
def test_correlation_fn_routes_by_dtype(dtype, kernel, monkeypatch):
    """``CorrelationFn`` launches the main kernel in float32 and the
    all-shift tensor-core kernel in bfloat16 (the kernels are stood in for
    by recorders: this host has no card)."""
    calls = []
    for name in ("correlation_cuda", "correlation_all_cuda"):
        monkeypatch.setattr(corr, name, lambda f1, f2, md, name=name: (
            calls.append(name), f1)[1])
    f = torch.zeros((1, 4, 3, 5), dtype=dtype)
    corr.CorrelationFn.apply(f, f, 4)
    assert calls == [kernel]


def test_correlation_fn_refuses_mixed_dtypes():
    """No fallback: a bfloat16 f1 with a float32 f2 raises."""
    f1 = torch.zeros((1, 4, 3, 5), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="of one dtype"):
        corr.CorrelationFn.apply(f1, f1.float(), 4)


def test_bf16_vo_gradient_close_to_f32(case):
    """A 'vo' ``train_step(bf16=True)`` differentiates the float32 pose
    head through the bfloat16 network: float32, finite gradients near the
    float32 run's."""
    ds = case["ds"]
    imu = IMUModule(ds.accels, ds.gyros, ds.imu_dts, ds.accel_bias,
                    ds.gyro_bias, gravity=ds.gravity,
                    rgb2imu_sync=ds.rgb2imu_sync, denoise_gyro=False,
                    batch_frames=B, device="cpu")
    init = ttrain.IMUState(*(torch.tensor(np.asarray(ds.imu_init[k]),
                                          dtype=torch.float32)
                             for k in ("pos", "rot", "vel")))
    grads = {}
    for bf16 in (False, True):
        _, g, aux = ttrain.train_step(
            case["model"], case["batch"], imu.window_inputs(0, B), init,
            torch.tensor(np.asarray(ds.rgb2imu_pose), dtype=torch.float32),
            imu.gravity, imu.accel_bias, imu.gyro_bias,
            torch.tensor(imu.optm_bias), target="vo", datatype="kitti",
            use_kitti_coord=True, correct_scale=True, denoise_gyro=False,
            loss_weight=(1.0, 0.1, 10.0, 0.1), trans_w=0.1, bf16=bf16)
        assert bool(aux["ok"])
        grads[bf16] = g
    g32, g16 = grads[False], grads[True]
    assert sorted(g16) == sorted(ttrain.pose_params(case["model"]))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in g16.values())
    gmax = max(float(g.abs().max()) for g in g32.values())
    diff = max(float((g16[k] - g32[k]).abs().max()) for k in g32)
    cos = sum(float((g16[k] * g32[k]).sum()) for k in g32) / (
        sum(float((g ** 2).sum()) for g in g16.values())
        * sum(float((g ** 2).sum()) for g in g32.values())) ** 0.5
    assert gmax > 0 and diff <= GRAD_RTOL * gmax and cos >= GRAD_COS, (
        diff / gmax, cos)
