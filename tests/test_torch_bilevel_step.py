"""The port's training step with the bi-level couplings through the PVGO
solve (``--bilevel implicit|unrolled``), the dense reprojection factor
(``--reproj-points``) and ``--frozen-bn-eval``, vs the JAX package, and the
entry point with those flags on the CPU.

One window of B=2 frame-pairs at 64x128 on the synthetic trajectory with
tests/test_torch_slice.py's constant heads (a real scale mask, so the dense
factor has pixels) and random BatchNorm running stats, both sides from one
set of weights carried by ``state_dict_from_jax``.  One module fixture runs
the JAX train steps once.

Tolerances as in tests/test_torch_train.py: VO motions and PVGO poses 1e-4,
IMU outputs 2e-5, PVGO velocities 2e-3 (an LM trial along a velocity is
decided on a cost tie, tests/test_torch_slice.py), losses rtol 1e-3.
Gradients atol 2e-3 x max|g|: in these modes they pass through the solution,
whose float32 velocities carry that tie (tests/test_torch_bilevel.py); the
port's implicit backward runs in float64 and JAX's in float32, which at
these windows moves the gradient by less than that.  The
forward with running-stats BatchNorm as tests/test_torch_models.py holds
the networks: rtol 1e-3 and atol 1e-4 of the output's scale.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.train import train_step as jax_train_step
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.models import tartanvo as ttvo
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           state_dict_from_jax)

from tests.test_torch_slice import _with_constant_heads
from tests.test_torch_slice import shared_jax_init  # noqa: F401
from tests.test_torch_train import _jax_trainer, _pose_sd

torch.set_num_threads(1)

W5 = (1.0, 0.1, 10.0, 0.1, 0.5)
H, W, B = 64, 128, 2


# ---------------------------------------------------------------------------
# --frozen-bn-eval: the VO forward and the Trainer's rule
# ---------------------------------------------------------------------------

def _with_running_stats(variables, seed=0):
    """Random BatchNorm running stats (mean ~0.1, var in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.array, variables)

    def draw(path, x):
        leaf = path[-1].key
        if leaf == "mean":
            return rng.normal(size=x.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(draw,
                                                        v["batch_stats"])
    return v


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = [rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
           for _ in range(4)]
    intr = rng.normal(size=(B, H // 4, W // 4, 2)).astype(np.float32)
    calib = np.tile(np.array([[320.0, 320.0, 64.0, 32.0]], np.float32),
                    (B, 1))
    return img, intr, calib, np.full((B,), 0.5, np.float32)


def test_forward_frozen_bn_eval_matches_jax():
    """Running-stats BatchNorm in the stereo net: disparity and motion as
    the JAX forward gives them (tests/test_torch_models.py's tolerances),
    and not what train-mode BatchNorm gives."""
    variables = _with_running_stats(jax.device_get(
        jtvo.init_params(jax.random.PRNGKey(0), H, W)))
    model = ttrain.tvo.VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    img, intr, calib, baseline = _inputs(4)
    ref = jtvo.forward(variables, *img, intr, calib, baseline,
                       frozen_bn_eval=True)
    t = [torch.from_numpy(x) for x in (*img, intr, calib, baseline)]
    with torch.no_grad():
        out = ttvo.forward(model, *t, frozen_bn_eval=True)
        train_bn = ttvo.forward(model, *t)
    jdisp = np.moveaxis(np.asarray(ref["disp"]), -1, 1)
    scale = np.abs(jdisp).max()
    np.testing.assert_allclose(out["disp"].numpy(), jdisp, rtol=1e-3,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(out["motion"].numpy(),
                               np.asarray(ref["motion"]), atol=1e-4)
    np.testing.assert_allclose(out["intrinsic"].numpy(),
                               np.asarray(ref["intrinsic"]), rtol=1e-6)
    assert np.abs(train_bn["disp"].numpy() - jdisp).max() > 1e-2 * scale


@pytest.mark.parametrize("parts", [["flow", "stereo"], ["flow"]])
def test_trainer_frozen_bn_eval_needs_a_frozen_stereo_net(parts):
    """The flag takes effect only with stereo in --fix-model-parts
    (islam_tpu/train.py:335-336)."""
    ds = SyntheticTrajDataset(num_frames=B + 1, height=H, width=W,
                              transform=ttrain.make_transform(H, W))
    tr = ttrain.Trainer(get_args(["--device", "cpu", "--data-type",
                                  "synthetic", "--frozen-bn-eval",
                                  "--fix-model-parts", *parts]), ds,
                        device="cpu")
    assert tr.frozen_bn_eval == ("stereo" in parts)


# ---------------------------------------------------------------------------
# One window of train_step, 'vo' and 'imu', implicit and unrolled, with the
# dense reprojection factor and --frozen-bn-eval, vs the JAX train_step
# ---------------------------------------------------------------------------

MODES = ("implicit", "unrolled")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    from islam_tpu.imu import denoiser as jdn

    tmp = tmp_path_factory.mktemp("bilevel")
    variables = _with_running_stats(_with_constant_heads(jax.device_get(
        jtvo.init_params(jax.random.PRNGKey(0), H, W))))
    dn_params = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    pkl = str(tmp / "denoiser.pkl")
    torch.save(denoiser_state_dict_from_jax(dn_params), pkl)
    jtr, _ = _jax_trainer(variables, pkl)
    jds, jimu = jtr.dataset, jtr.imu_module
    batch, win, init = jtesting.make_step_inputs(jds, jimu, 0, B)
    static = dict(datatype="kitti", correct_scale=False, use_kitti_coord=True,
                  denoise_accel=True, denoise_gyro=False, loss_weight=W5,
                  rot_w=1.0, trans_w=0.1, use_reproj=True,
                  frozen_bn_eval=True)
    jout = {}
    for mode in MODES:
        for target in ("vo", "imu"):
            prev = None if target == "vo" else jout[mode, "vo"][2]["motions"]
            jout[mode, target] = jax.device_get(jax_train_step(
                variables, jtr.dn_params, batch, win, init, jtr.rgb2imu_pose,
                jimu.gravity, jimu.accel_bias, jimu.gyro_bias,
                jnp.asarray(jimu.optm_bias), target=target, prev_motions=prev,
                bilevel=mode, **static))

    tds = SyntheticTrajDataset(num_frames=B + 1, height=H, width=W,
                               transform=ttrain.make_transform(H, W))
    ttr = ttrain.Trainer(get_args([
        "--device", "cpu", "--data-type", "synthetic",
        "--imu-denoise-model-name", pkl,
        "--fix-model-parts", "flow", "stereo", "--frozen-bn-eval"]), tds,
        device="cpu", state_dict=state_dict_from_jax(variables))
    assert ttr.frozen_bn_eval
    tbatch = ttrain.device_batch(collate([tds[i] for i in range(B)]), 0,
                                 "cpu")

    def port(target, mode, prev=None, **kw):
        return ttrain.train_step(
            ttr.model, tbatch, ttr.imu_module.window_inputs(0, B),
            ttr._state(tds.imu_init), ttr.rgb2imu_pose,
            ttr.imu_module.gravity, ttr.imu_module.accel_bias,
            ttr.imu_module.gyro_bias, torch.tensor(ttr.imu_module.optm_bias),
            target=target, denoiser=ttr.denoiser, prev_motions=prev,
            bilevel=mode, **{**static, **kw})

    tout = {}
    for mode in MODES:
        tout[mode, "vo"] = port("vo", mode)
        prev = torch.from_numpy(np.asarray(jout[mode, "vo"][2]["motions"]))
        tout[mode, "imu"] = port("imu", mode, prev)
    return {"jout": jout, "tout": tout, "port": port}


def _ref_grads(target, grads):
    return (_pose_sd(grads) if target == "vo"
            else denoiser_state_dict_from_jax(grads))


@pytest.mark.parametrize("target", ["vo", "imu"])
@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(steps, mode, target):
    jloss, jgrads, jaux = steps["jout"][mode, target]
    tloss, tgrads, taux = steps["tout"][mode, target]
    assert bool(taux["ok"]) and bool(jaux["ok"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    for k in ("trans_loss", "rot_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-3,
                                   atol=1e-9, err_msg=k)
    for k, atol in (("motions", 1e-4), ("imu_poses", 2e-5),
                    ("imu_vels", 2e-5), ("pgo_poses", 1e-4),
                    ("pgo_vels", 2e-3)):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   atol=atol, err_msg=k)
    for got, ref, atol in zip(taux["carry"], jaux["carry"],
                              (1e-4, 1e-4, 2e-3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    ref = _ref_grads(target, jgrads)
    assert sorted(tgrads) == sorted(ref)
    gmax = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    assert gmax > 0
    for k in ref:
        np.testing.assert_allclose(tgrads[k].numpy(), ref[k].numpy(),
                                   atol=2e-3 * gmax, err_msg=k)
    # the factor ran on a nonempty mask where the VO forward ran
    assert (int(taux["reproj_pixels"]) > 0) == (target == "vo")


def test_train_step_vo_gradient_differs_from_detached(steps):
    """Through the solve, with the factor on: the implicit 'vo' gradient is
    not the detached one, and the factor moves the loss."""
    _, g_imp, aux = steps["tout"]["implicit", "vo"]
    loss_det, g_det, _ = steps["port"]("vo", "detached")
    loss_no, _, aux_no = steps["port"]("vo", "detached", use_reproj=False)
    diff = max(float((g_imp[k] - g_det[k]).abs().max()) for k in g_det)
    assert diff > 1e-3 * max(float(g.abs().max()) for g in g_det.values())
    assert int(aux_no["reproj_pixels"]) == 0
    assert float(loss_det) != float(loss_no)


# ---------------------------------------------------------------------------
# The entry point on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,data", [("implicit", "synthetic"),
                                       ("unrolled", "synthetic"),
                                       ("implicit", "kitti")])
def test_main_trains_through_the_solve_on_cpu(mode, data, tmp_path):
    """``main --bilevel MODE --reproj-points 1 --frozen-bn-eval`` at 64x128:
    a 'vo' and an 'imu' epoch with finite snapshots, on synthetic data and
    on a KITTI raw folder."""
    from islam_tpu_torch.data import fixtures
    from islam_tpu_torch.imu.denoiser import init_denoiser

    pkl = str(tmp_path / "denoiser.pkl")
    torch.save(init_denoiser(1, "cpu").state_dict(), pkl)
    if data == "kitti":
        root = fixtures.write_kitti(str(tmp_path / "raw"), n=6, h=60,
                                    w=120)
        source = ["--data-type", "kitti", "--data-root", root]
        frames = 5
    else:
        source = ["--data-type", "synthetic", "--synthetic-frames", "5"]
        frames = 5
    trainer = ttrain.main([
        *source, "--image-height", str(H), "--image-width", str(W),
        "--batch-size", str(B), "--device", "cpu", "--train-epoch", "2",
        "--bilevel", mode, "--reproj-points", "1", "--frozen-bn-eval",
        "--fix-model-parts", "flow", "stereo", "--loss-weight", str(W5),
        "--trans-w", "0.1", "--imu-denoise-model-name", pkl,
        "--print-interval", "0", "--result-dir", str(tmp_path / "out")])
    assert trainer.frozen_bn_eval
    assert [len(trainer.reproj_pixels[e]) for e in (1, 2)] == [2, 2]
    assert trainer.reproj_pixels[2] == [0, 0]   # 'imu' replays the motions
    for e in (1, 2):
        assert np.isfinite(trainer.window_losses[e]).all()
    assert sorted(trainer.last_grads) == sorted(trainer.imu_params)
    for epoch in ("1", "2"):
        for name in ("vo_pose", "pgo_pose", "imu_pose"):
            rows = np.loadtxt(os.path.join(tmp_path, "out", epoch,
                                           f"{name}.txt"))
            assert rows.shape == (frames, 7) and np.isfinite(rows).all()
