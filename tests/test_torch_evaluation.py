"""The port's trajectory evaluation against the JAX package's: Umeyama
alignment, ATE and RPE on random trajectories at 1e-9 (the same float64
arithmetic), ``islam_tpu_torch.evaluate`` against ``scripts/evaluate.py``
on one result directory, and the timer."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from islam_tpu.utils import evaluation as jeval
from islam_tpu.utils.timer import Timer as JTimer
from islam_tpu_torch import evaluate
from islam_tpu_torch.utils import evaluation as teval
from islam_tpu_torch.utils.timer import Timer

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-evaluation")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trajectory(n, noise=0.0):
    pos = np.cumsum(RNG.normal(size=(n, 3)), axis=0)
    q = R.from_rotvec(np.cumsum(RNG.normal(scale=0.1, size=(n, 3)),
                                axis=0)).as_quat()
    pos = pos + noise * RNG.normal(size=pos.shape)
    return np.concatenate([pos, q], axis=1)


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_jax(with_scale):
    x = RNG.normal(size=(30, 3))
    y = 1.7 * x @ R.random(random_state=3).as_matrix().T + [1.0, -2.0, 0.5]
    y += 0.01 * RNG.normal(size=y.shape)
    for a, b in zip(teval.umeyama_alignment(x, y, with_scale),
                    jeval.umeyama_alignment(x, y, with_scale)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [2, 17, 60])
@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_matches_jax(n, with_scale):
    est, gt = _trajectory(n), _trajectory(n + 3)
    np.testing.assert_allclose(teval.ate_rmse(est, gt, with_scale),
                               jeval.ate_rmse(est, gt, with_scale),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(delta):
    gt = _trajectory(25)
    est = gt.copy()
    est[:, :3] += 0.05 * RNG.normal(size=(25, 3))
    est[:, 3:] = (R.from_quat(gt[:, 3:]) * R.from_rotvec(
        0.01 * RNG.normal(size=(25, 3)))).as_quat()
    np.testing.assert_allclose(teval.rpe(est, gt, delta),
                               jeval.rpe(est, gt, delta), rtol=0, atol=1e-9)


def _result_dir(root):
    gt = _trajectory(12)
    np.savetxt(os.path.join(root, "gt_pose.txt"), gt)
    for epoch in (0, 1, 2):
        os.makedirs(os.path.join(root, str(epoch)))
        for i, kind in enumerate(evaluate.KINDS):
            est = gt.copy()
            est[:, :3] += (0.1 * (epoch + i + 1)) * RNG.normal(size=(12, 3))
            np.savetxt(os.path.join(root, str(epoch), kind + ".txt"),
                       est[:10 + epoch])
    os.makedirs(os.path.join(root, "models"))   # not an epoch


@pytest.mark.parametrize("flags", [[], ["--with-scale", "--delta", "2"]],
                         ids=["default", "scale-delta2"])
def test_evaluate_matches_the_scripts_evaluate(tmp_path, capsys, flags):
    _result_dir(str(tmp_path))
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "evaluate.py"),
         str(tmp_path), *flags], capture_output=True, text=True, check=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
    records = evaluate.main([str(tmp_path), *flags])
    out = capsys.readouterr().out
    assert out.splitlines() == ref.stdout.splitlines()
    assert len(records) == 9
    assert [json.loads(line) for line in out.splitlines()[:9]] == records


def test_evaluate_needs_ground_truth(tmp_path):
    with pytest.raises(SystemExit, match="no gt_pose.txt"):
        evaluate.main([str(tmp_path)])


def test_timer_matches_jax(monkeypatch):
    """The same tic/toc bookkeeping, on a fake clock (the port reads
    ``perf_counter``, the JAX package ``time``)."""
    import islam_tpu.utils.timer as jt
    import islam_tpu_torch.utils.timer as tt

    times = [1.0, 1.5, 2.0, 4.0]
    monkeypatch.setattr(jt, "time", types.SimpleNamespace(
        time=iter(times).__next__))
    monkeypatch.setattr(tt, "time", types.SimpleNamespace(
        perf_counter=iter(times).__next__))
    for timer in (Timer(), JTimer()):
        assert timer.toc("x") == 0.0 and timer.last("x") == 0.0
        for _ in range(2):
            timer.tic("x")
            timer.toc("x")
        assert timer.last("x") == 2.0
        assert timer.avg("x") == 1.25 and timer.tot("x") == 2.5
