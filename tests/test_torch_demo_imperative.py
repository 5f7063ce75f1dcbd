"""The imperative study (``islam_tpu_torch/demo_imperative.py``) against the
JAX package's ``Trainer`` with ``scripts/demo_imperative.py``'s settings.

Both run the seeded synthetic sequence at 64x128 with B=2 (5 frames, 2
windows), float32, detached, Adam at lr 1e-4 for the pose head, the
ground-truth scale, no denoiser, from the same weights (the JAX
``Trainer``'s init, carried over with ``state_dict_from_jax``), for 2
epochs: 'vo', then 'imu', which replays the 'vo' motions.  Tolerances as
``tests/test_torch_train.py`` holds the same epochs: poses (and so the
records' ATE and RPE) 1e-4, PVGO velocities 2e-3, the epoch's gradients
1e-3 x max|g|, and the Adam-updated pose head 2 x lr (Adam's first step is
~lr x sign(g), and a gradient near 0 can flip its sign between the two
sides).
"""

import pathlib
import re

import jax
import numpy as np
import optax
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.arguments import get_args as jax_get_args
from islam_tpu.train import Trainer as JaxTrainer
from islam_tpu.utils.evaluation import ate_rmse as jate
from islam_tpu.utils.evaluation import rpe as jrpe
from islam_tpu_torch import demo_imperative as demo
from islam_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_slice import shared_jax_init  # noqa: F401

torch.set_num_threads(1)

H, W, B, FRAMES, EPOCHS, LR = 64, 128, 2, 5, 2, 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]
# scripts/demo_imperative.py's Args, as flags of the JAX parser
JAX_FLAGS = ["--data-type", "synthetic", "--batch-size", str(B),
             "--vo-optimizer", "adam", "--loss-weight", "(1,0.1,10,0.1)",
             "--rot-w", "1", "--trans-w", "0.1", "--use-gt-scale",
             "--print-interval", "0", "--lr", str(LR),
             "--bilevel", "detached"]
METRICS = ("ate_vo", "ate_pgo", "rpe_rot_vo", "rpe_rot_pgo")


def _pose_sd(tree):
    return state_dict_from_jax({"params": {"flowPoseNet": tree}})


@pytest.fixture(scope="module")
def run():
    # ---- JAX: the demo's loop, its Trainer's optimizer recording ----
    ds = jtesting.make_dataset(num_frames=FRAMES, height=H, width=W)
    jtr = JaxTrainer(jax_get_args(JAX_FLAGS), ds)
    sd = state_dict_from_jax(jax.device_get(jtr.vo_variables))
    jgrads = []
    opt = jtr.vo_opt

    def update(grads, state, params=None):
        jgrads.append(jax.device_get(grads))
        return opt.update(grads, state, params)

    jtr.vo_opt = optax.GradientTransformation(opt.init, update)
    jrecs, jtrajs, jpose = [], [], []
    for epoch in range(1, EPOCHS + 1):
        traj = jtr.run_epoch(epoch)
        vo, pgo = np.stack(traj.vo_poses), np.stack(traj.pgo_poses)
        n = len(pgo)
        gt = ds.poses[:n]
        jrecs.append({"ate_vo": jate(vo[:n], gt), "ate_pgo": jate(pgo, gt),
                      "rpe_rot_vo": jrpe(vo[:n], gt)[1],
                      "rpe_rot_pgo": jrpe(pgo, gt)[1],
                      "target": jtr.train_target[epoch]})
        jtrajs.append(traj)
        jpose.append(_pose_sd(jax.device_get(
            jtr.vo_variables["params"]["flowPoseNet"])))

    # ---- the port: run_study, its trainer read after each epoch ----
    seen = {"trajs": [], "grads": [], "pose": []}

    def on_epoch(epoch, trainer, traj, record):
        seen["trajs"].append(traj)
        seen["grads"].append(trainer.last_grads)
        seen["pose"].append({k: p.detach().clone()
                             for k, p in trainer.vo_params.items()})

    records = demo.run_study(EPOCHS, LR, False, "detached", num_frames=FRAMES,
                             height=H, width=W, batch_size=B, device="cpu",
                             state_dict=sd, on_epoch=on_epoch)
    return {"jrecs": jrecs, "jtrajs": jtrajs, "jgrads": jgrads,
            "jpose": jpose, "records": records, **seen}


@pytest.mark.parametrize("epoch", [1, 2])
def test_records_match_jax(run, epoch):
    rec, ref = run["records"][epoch - 1], run["jrecs"][epoch - 1]
    assert rec["epoch"] == epoch and rec["bilevel"] == "detached"
    assert rec["target"] == ref["target"] == ("vo", "imu")[epoch - 1]
    for k in METRICS:
        assert np.isfinite(rec[k]), k
        np.testing.assert_allclose(rec[k], ref[k], atol=1e-4, err_msg=k)
    # the back-end fuses the exact synthetic IMU
    assert rec["ate_pgo"] < rec["ate_vo"]


@pytest.mark.parametrize("epoch", [1, 2])
def test_trajectories_match_jax(run, epoch):
    t, j = run["trajs"][epoch - 1], run["jtrajs"][epoch - 1]
    for name, atol in (("vo_poses", 1e-4), ("pgo_poses", 1e-4),
                       ("imu_poses", 1e-4), ("pgo_vels", 2e-3)):
        a, b = np.stack(getattr(t, name)), np.stack(getattr(j, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


def test_vo_epoch_gradient_and_update_match_jax(run):
    """Epoch 1's summed gradient (what JAX's optimizer was given) and the
    Adam-updated pose head; epoch 2 ('imu', no denoiser) trains nothing."""
    (jg,) = run["jgrads"]
    ref = _pose_sd(jg)
    tg = run["grads"][0]
    assert sorted(tg) == sorted(ref)
    gmax = max(float(v.abs().max()) for v in ref.values())
    assert gmax > 0
    for k, r in ref.items():
        np.testing.assert_allclose(tg[k].numpy(), r.numpy(),
                                   atol=1e-3 * gmax, err_msg=k)
    for k, r in run["jpose"][0].items():
        np.testing.assert_allclose(run["pose"][0][k].numpy(), r.numpy(),
                                   atol=2 * LR, err_msg=k)
    assert run["grads"][1] is None
    for k, p in run["pose"][1].items():
        assert torch.equal(p, run["pose"][0][k]), k


def test_records_have_the_jax_scripts_keys(run):
    """Each record's keys are those of scripts/demo_imperative.py's, in its
    order; the summary line's too."""
    src = (ROOT / "scripts" / "demo_imperative.py").read_text()
    rec_src = src[src.index("rec = {"):src.index("history.append")]
    keys = re.findall(r'"(\w+)":', rec_src)
    for rec in run["records"]:
        assert list(rec) == keys
    tail = src[src.index("first_vo = "):src.index("__main__")]
    assert list(demo.summary(run["records"])) == re.findall(r'"(\w+)":',
                                                            tail)


@pytest.mark.parametrize("argv,want", [
    ([], (8, 1e-4, False, "detached", "cuda")),
    (["12", "2e-5", "--f32"], (12, 2e-5, True, "detached", "cuda")),
    (["8", "1e-4", "--bilevel=implicit"], (8, 1e-4, False, "implicit",
                                           "cuda")),
    (["4", "--f32", "--bilevel=unrolled", "--device", "cpu"],
     (4, 1e-4, True, "unrolled", "cpu")),
])
def test_main_takes_the_jax_scripts_command_line(argv, want):
    a = demo.parse_args(argv)
    assert (a.epochs, a.lr, a.f32, a.bilevel, a.device) == want


@pytest.mark.parametrize("bf16", [False, True])
def test_study_args_are_the_demos(bf16):
    """The trainer's flags: scripts/demo_imperative.py's Args values."""
    a = demo.study_args(3e-5, bf16, "unrolled")
    assert (a.batch_size, a.vo_optimizer, a.loss_weight, a.rot_w, a.trans_w,
            a.use_gt_scale, a.print_interval, a.lr, a.bilevel, a.bf16,
            a.device) == (8, "adam", (1, 0.1, 10, 0.1), 1.0, 0.1, True, 0,
                          3e-5, "unrolled", bf16, "cuda")
    assert (a.vo_model_name, a.pose_model_name,
            a.imu_denoise_model_name) == ("", "", "")


def test_main_prints_each_record_and_the_summary(monkeypatch, capsys):
    """``main`` prints one JSON line a record as the epochs come, then the
    summary line (``run_study`` replaced by a stand-in that reports two
    epochs)."""
    import json

    recs = [{"epoch": e, "ate_vo": v} for e, v in ((1, 0.5), (2, 0.4))]

    def fake(epochs, lr, bf16, bilevel, *, device, on_epoch):
        assert (epochs, lr, bf16, bilevel, device) == (2, 3e-5, False,
                                                       "implicit", "cpu")
        for rec in recs:
            on_epoch(rec["epoch"], None, None, rec)
        return recs

    monkeypatch.setattr(demo, "run_study", fake)
    demo.main(["2", "3e-5", "--f32", "--bilevel=implicit", "--device",
               "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == recs + [{"vo_ate_first": 0.5, "vo_ate_last": 0.4,
                             "vo_ate_change_pct": -20.0}]
