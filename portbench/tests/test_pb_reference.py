"""The plain reference against the program on the CPU at 64x128, B=2: a
whole run of each cell (drive, set-up steps, timed epoch, comparison)
agrees within the cell's limits; and with the timed path broken underneath
(the harness's look for a card skipped) ``correct`` comes out false, for
each fault a cell can have: a step that leaves the state unchanged, half
the batch left out with the loss's mean over the rest, an answer (the VO
motions, the IMU poses, the PVGO velocities or a window's last pose)
altered where it is produced.  (One card: there is no exchange between cards to
leave out.)"""

import time
from unittest import mock

import pytest
import torch

from pb_helpers import CELLS, tiny

SEED = 1307586307


def run(name, seed=SEED, **kw):
    from portbench.harness import cell as runner, report
    c = tiny(name)
    torch.manual_seed(0)
    _, numbers = runner.run(c, seed, 1.0, False, time.perf_counter(),
                            device="cpu", **kw)
    checked = report.checks(c.spec["limits"], numbers)
    return checked, report.correct(checked)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    checked, ok = run(name)
    assert ok, checked
    for c in checked.values():
        assert c["value"] < 1e-3, checked


def _unchanged_state():
    return mock.patch("islam_tpu_torch.optim.apply_updates",
                      lambda params, updates: None)


def _half_batch():
    import islam_tpu_torch.train as T
    real = T.run_pvgo

    def half(*a, **k):
        trans, rot, *rest = real(*a, **k)
        keep = torch.arange(trans.shape[0], device=trans.device) < (
            trans.shape[0] + 1) // 2
        w = keep.to(trans.dtype) * trans.shape[0] / int(keep.sum())
        return (trans * w, rot * w, *rest)
    return mock.patch.object(T, "run_pvgo", half)


def _altered_answer():
    import islam_tpu_torch.train as T
    real = T.tvo.forward

    def altered(*a, **k):
        res = real(*a, **k)
        m = res["motion"].clone()
        m[:, :3] = m[:, :3] * 1.01
        res["motion"] = m
        return res
    return mock.patch.object(T.tvo, "forward", altered)


def _altered_imu():
    import islam_tpu_torch.train as T
    real = T.integrate_window

    def altered(*a, **k):
        out = dict(real(*a, **k))
        pos = out["pos"].clone()
        pos[1:] = pos[1:] + 0.005
        out["pos"] = pos
        return out
    return mock.patch.object(T, "integrate_window", altered)


def _altered_pvgo(kind):
    import islam_tpu_torch.train as T
    real = T.run_pvgo

    def altered(*a, **k):
        trans, rot, poses, vels, *rest = real(*a, **k)
        if kind == "vels":
            vels = vels * 1.05
        else:
            poses = poses.clone()
            poses[-1, :3] = poses[-1, :3] + 0.03
        return (trans, rot, poses, vels, *rest)
    return mock.patch.object(T, "run_pvgo", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer, "altered_imu": _altered_imu,
          "pvgo_vels_5pct": lambda: _altered_pvgo("vels"),
          "pvgo_last_pose_3cm": lambda: _altered_pvgo("pose")}
CASES = [("kitti-f32-vo", f) for f in FAULTS] + [
    ("euroc-f32-eval", f) for f in ("altered_answer", "altered_imu",
                                    "pvgo_vels_5pct", "pvgo_last_pose_3cm")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_path_is_not_correct(name, fault):
    with FAULTS[fault]():
        checked, ok = run(name)
    assert not ok, checked
