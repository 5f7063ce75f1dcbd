"""The port's eval-only window vs JAX ``train_step(target='')``, and the
port's ``main --eval-only`` on the CPU.

Two chained windows of B=2 frame-pairs at 64x128 on the synthetic
trajectory, the same VO weights on both sides (JAX init carried over with
``state_dict_from_jax``), window 2 starting from each side's own carry.

Tolerances.  The VO motions come out of ~80 float32 conv layers summed in
different orders (XLA:CPU vs oneDNN) and agree to ~1e-7: atol 1e-4.  The
first window's IMU outputs are float32 prefix products and sums from one
init state (atol 2e-5, as in tests/test_torch_imu.py).  PVGO positions are
pinned by the VO factor (weight 1): atol 1e-4.  PVGO velocities are not
pinned that well: only the transvel and IMU factors (weight 0.1, dt 0.1 s)
see them, so a velocity change of 1e-3 moves the cost by ~1e-10, under one
float32 ulp of the ~1e-3 cost, and an LM trial that moves along it is
accepted or rejected on a tie (measured: same step count, same costs to
7 digits, velocities 2e-4 apart).  Velocities are compared at 2e-3, and the
second window's IMU positions, which integrate the carried velocity over
0.2 s, at 5e-4.
"""

import fcntl
import hashlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.train import train_step as jax_train_step
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.module import IMUModule
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.utils.weights import state_dict_from_jax

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B = 64, 128, 2
WEIGHTS = (1.0, 0.1, 10.0, 0.1)
KEYS = ("motions", "imu_poses", "imu_vels", "pgo_poses", "pgo_vels")


_INIT_MEMO = {}


@pytest.fixture(scope="module", autouse=True)
def shared_jax_init(tmp_path_factory):
    """Serve the JAX package's ``tartanvo.init_params`` once per (key, size,
    train_bn) in a test run: kept in the process, and on disk for the run's
    other xdist workers (one worker computes while the others wait on its
    lock).  A call traces and lowers flax's init and reads its executable
    back from the compilation cache (~15 s on a CPU host with a warm
    cache, minutes to compile on a cold one), and the port's tests hold
    many JAX trainers and weight sets; the values are init's own, bit for
    bit.  Each call gets fresh containers, so a caller that edits its
    tree edits no one else's."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"jax-init-{uid}" if uid else base / "jax-init"
    root.mkdir(exist_ok=True)
    init = getattr(jtvo.init_params, "__wrapped__", jtvo.init_params)

    def memo(key, height=448, width=640, train_bn=True):
        k = (tuple(np.asarray(key).ravel().tolist()), height, width,
             bool(train_bn))
        if k not in _INIT_MEMO:
            path = root / hashlib.sha1(repr(k).encode()).hexdigest()
            with open(path.with_suffix(".lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if path.exists():
                    tree = pickle.loads(path.read_bytes())
                else:
                    tree = jax.device_get(init(key, height, width, train_bn))
                    part = path.with_suffix(f".{os.getpid()}")
                    part.write_bytes(pickle.dumps(tree))
                    os.replace(part, path)
            _INIT_MEMO[k] = jax.tree_util.tree_map(jnp.asarray, tree)
        return jax.tree_util.tree_map(lambda x: x, _INIT_MEMO[k])

    memo.__wrapped__ = init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtvo, "init_params", memo)
        yield


def _with_constant_heads(variables):
    """Random weights give negative disparity and huge flow, so the scale
    least squares would see an empty mask and return 0.  Constant heads (a
    1-px flow, a 10-px disparity) give it real masks on both sides, so the
    translations it scales are exercised too."""
    v = jax.tree_util.tree_map(np.array, variables)
    flow, stereo = v["params"]["flowNet"], v["params"]["stereoNet"]
    flow["predict_flow2"]["kernel"][:] = 0.0
    flow["predict_flow2"]["bias"][:] = (0.2, 0.1)  # x 5 -> (1, 0.5) px
    flow["dc_conv7"]["kernel"][:] = 0.0
    flow["dc_conv7"]["bias"][:] = 0.0
    stereo["conv_c13"]["kernel"][:] = 0.0
    stereo["conv_c13"]["bias"][:] = 0.8  # x 12.5 -> 10 px >= DISP_TH 5
    return v


@pytest.fixture(scope="module")
def windows():
    """Both sides' aux for two chained windows."""
    variables = _with_constant_heads(jax.device_get(
        jtvo.init_params(jax.random.PRNGKey(0), H, W)))
    jds = jtesting.make_dataset(num_frames=2 * B + 1, height=H, width=W)
    jimu = jtesting.make_imu_module(jds, batch_frames=B)
    pose = jnp.asarray(np.asarray(jds.rgb2imu_pose), jnp.float32)

    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    tds = SyntheticTrajDataset(num_frames=2 * B + 1, height=H, width=W,
                               transform=ttrain.make_transform(H, W))
    timu = IMUModule(tds.accels, tds.gyros, tds.imu_dts, tds.accel_bias,
                     tds.gyro_bias, gravity=tds.gravity,
                     rgb2imu_sync=tds.rgb2imu_sync, denoise_accel=True,
                     denoise_gyro=False, batch_frames=B, device="cpu")
    tpose = torch.tensor(np.asarray(tds.rgb2imu_pose), dtype=torch.float32)

    _, _, jinit = jtesting.make_step_inputs(jds, jimu, 0, B)
    tinit = IMUState(*(torch.tensor(np.asarray(tds.imu_init[k]),
                                    dtype=torch.float32)
                       for k in ("pos", "rot", "vel")))
    out = []
    for st in (0, B):
        jbatch, jwin, _ = jtesting.make_step_inputs(jds, jimu, st, B)
        _, grads, jaux = jax_train_step(
            variables, None, jbatch, jwin, jinit, pose, jimu.gravity,
            jimu.accel_bias, jimu.gyro_bias, jnp.asarray(True), target="",
            datatype="kitti", correct_scale=False, use_kitti_coord=True,
            denoise_accel=True, denoise_gyro=False, loss_weight=WEIGHTS,
            rot_w=1.0, trans_w=0.1)
        assert grads is None
        # the scale path ran: nonzero VO translations
        assert np.abs(np.asarray(jaux["motions"])[:, :3]).max() > 1e-3
        sample = collate([tds[i] for i in range(st, st + B)])
        tbatch = ttrain.device_batch(sample, st, "cpu")
        assert "frames" in tbatch  # the shared-pyramid path
        loss, tgrads, taux = ttrain.train_step(
            model, tbatch, timu.window_inputs(st, st + B), tinit, tpose,
            timu.gravity, timu.accel_bias, timu.gyro_bias,
            torch.tensor(True), target="", datatype="kitti",
            use_kitti_coord=True, denoise_accel=True, denoise_gyro=False,
            loss_weight=WEIGHTS, rot_w=1.0, trans_w=0.1)
        assert tgrads is None and float(loss) == 0.0
        out.append((jax.device_get(jaux), taux))
        jinit, tinit = jaux["carry"], taux["carry"]
    return out


VEL_ATOL = 2e-3


def _atol(key, window):
    if key.endswith("vels") and (window > 0 or key.startswith("pgo")):
        return VEL_ATOL
    if key.startswith("imu"):
        return 2e-5 if window == 0 else 5e-4
    return 1e-4


@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("key", KEYS)
def test_window_outputs_match_jax(windows, window, key):
    jaux, taux = windows[window]
    np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                               atol=_atol(key, window))


@pytest.mark.parametrize("window", [0, 1])
def test_carry_and_guard_match_jax(windows, window):
    jaux, taux = windows[window]
    assert bool(taux["ok"]) and bool(jaux["ok"])
    for t, j, atol in zip(taux["carry"], jaux["carry"],
                          (1e-4, 1e-4, VEL_ATOL)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


def test_nonfinite_window_falls_back_to_its_init_state():
    init = IMUState(torch.zeros(3), torch.tensor([0., 0., 0., 1.]),
                    torch.ones(3))
    aux = {"carry": IMUState(torch.full((3,), 5.0),
                             torch.tensor([0., 1., 0., 0.]), torch.zeros(3))}
    grads, out = ttrain._guard_nonfinite(torch.tensor(float("nan")), None,
                                         aux, init)
    assert grads is None and not bool(out["ok"])
    for c, i in zip(out["carry"], init):
        assert torch.equal(c, i)


def test_main_eval_only_on_cpu(tmp_path):
    """The entry point, as a user runs it, on the CPU: snapshot files with
    finite 7-column rows, one per frame."""
    from islam_tpu_torch.ops import correlation as corr

    before = corr.LAUNCHES
    trainer = ttrain.main([
        "--eval-only", "--data-type", "synthetic", "--image-height", str(H),
        "--image-width", str(W), "--batch-size", str(B),
        "--synthetic-frames", str(2 * B + 1), "--device", "cpu",
        "--loss-weight", str(WEIGHTS), "--trans-w", "0.1",
        "--result-dir", str(tmp_path)])
    assert corr.LAUNCHES == before  # CPU tensors never reach the kernel
    assert len(trainer.window_seconds[0]) == 2
    for name in ("vo_pose", "pgo_pose", "imu_pose"):
        rows = np.loadtxt(os.path.join(tmp_path, "0", f"{name}.txt"))
        assert rows.shape == (2 * B + 1, 7) and np.isfinite(rows).all()
    for name in ("pgo_vel", "vo_motion", "pgo_motion", "imu_motion"):
        assert np.isfinite(np.loadtxt(
            os.path.join(tmp_path, "0", f"{name}.txt"))).all()
    np.testing.assert_allclose(np.loadtxt(os.path.join(tmp_path,
                                                       "gt_pose.txt")),
                               trainer.dataset.poses, atol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--save-model-dir", "models"], ["--start-epoch", "3"],
    ["--vo-model-name", "vo.pkl"], ["--pose-model-name", "pose.pkl"]],
    ids=lambda f: f[0])
def test_main_without_eval_only_raises(flags, tmp_path):
    """Checkpoint I/O is ported, so these flags no longer raise
    NotImplementedError; what raises, before anything is built, is a
    sequence folder that is not there."""
    with pytest.raises(FileNotFoundError, match="no such kitti sequence"):
        ttrain.main(["--device", "cpu", "--data-type", "kitti",
                     "--data-root", str(tmp_path / "missing"), *flags])


def test_main_trains_vo_then_imu_on_cpu(tmp_path):
    """``main`` without ``--eval-only``: epoch 1 ('vo') steps the pose head,
    epoch 2 ('imu') the denoiser, and both write finite snapshots."""
    from islam_tpu_torch.imu.denoiser import init_denoiser
    from islam_tpu_torch.ops import correlation as corr

    pkl = str(tmp_path / "denoiser.pkl")
    torch.save(init_denoiser(1, "cpu").state_dict(), pkl)
    before = corr.LAUNCHES
    trainer = ttrain.main([
        "--data-type", "synthetic", "--image-height", str(H),
        "--image-width", str(W), "--batch-size", str(B),
        "--synthetic-frames", str(2 * B + 1), "--device", "cpu",
        "--train-epoch", "2", "--loss-weight", str(WEIGHTS),
        "--trans-w", "0.1", "--imu-denoise-model-name", pkl,
        "--print-interval", "0", "--result-dir", str(tmp_path)])
    assert corr.LAUNCHES == before
    assert sorted(trainer.window_seconds) == [1, 2]
    assert all(len(w) == 2 for w in trainer.window_seconds.values())
    assert sorted(trainer.last_grads) == sorted(trainer.imu_params)
    for epoch in ("1", "2"):
        for name in ("vo_pose", "pgo_pose", "imu_pose"):
            rows = np.loadtxt(os.path.join(tmp_path, epoch, f"{name}.txt"))
            assert rows.shape == (2 * B + 1, 7) and np.isfinite(rows).all()


def test_profiled_eval_epoch_runs_the_vo_forward(monkeypatch):
    """``profile_window --epoch 0`` warms up on epoch 0 and profiles it
    again.  The Trainer replays cached motions in every epoch but a 'vo'
    one, so the warm-up must drop them: the profiled epoch runs the VO
    forward once per window, as ``--eval-only`` does."""
    from islam_tpu_torch import profile_window
    from islam_tpu_torch.arguments import get_args

    ds = SyntheticTrajDataset(num_frames=2 * B + 1, height=H, width=W,
                              transform=ttrain.make_transform(H, W))
    trainer = ttrain.Trainer(get_args([
        "--eval-only", "--data-type", "synthetic", "--batch-size", str(B),
        "--device", "cpu",
        "--print-interval", "0"]), ds, device="cpu")
    calls = []
    forward = ttrain.tvo.forward
    monkeypatch.setattr(ttrain.tvo, "forward",
                        lambda *a, **k: calls.append(1) or forward(*a, **k))
    profile_window.warm_up(trainer, 0)
    assert len(calls) == 2 and trainer.prev_vo_motions is None
    trainer.run_epoch(0)
    assert len(calls) == 4
