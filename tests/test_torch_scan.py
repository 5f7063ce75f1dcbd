"""``train_scan`` and ``--scan-chunk`` on the port, and ``--profile-dir``.

Port only: the per-window path these are held against is held against the
JAX package by tests/test_torch_train.py.  On the CPU at 64x128, B=2, 3
windows (7 synthetic frames), K = 2: one chunk and one tail window.

Tolerances.  ``train_scan`` runs the same ``train_step`` calls in the same
order, so it equals the loop bitwise.  A scanned epoch sums each chunk's
gradients before adding them to the epoch's (as the JAX package does), an
order of float32 sums that differs from the per-window epoch's: motions
1e-5, pose head 1e-6 and pgo_pose.txt 1e-4, the tolerances of
tests/test_train_e2e.py's scanned-epoch test.  The pose head trains with
SGD (an update of lr x g, so the sum order moves it by ~1e-12); the
denoiser with Adam, whose first step is ~lr x sign(g), so 2 x imu_lr.  The
chunk prefetch changes no arithmetic: bitwise.
"""

import os

import numpy as np
import pytest
import torch

from islam_tpu_torch import train as ttrain
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.denoiser import init_denoiser

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B, K = 64, 128, 2, 2
FRAMES = 3 * B + 1
IMU_LR = 3e-5
FLAGS = ["--data-type", "synthetic", "--image-height", str(H),
         "--image-width", str(W), "--batch-size", str(B),
         "--synthetic-frames", str(FRAMES), "--loss-weight", "(1,0.1,10,0.1)",
         "--trans-w", "0.1", "--print-interval", "0", "--vo-optimizer", "sgd",
         "--lr", "1e-3", "--imu-lr", str(IMU_LR), "--device", "cpu"]


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scan") / "denoiser.pkl")
    torch.save(init_denoiser(1, "cpu").state_dict(), path)
    return path


def _trainer(pkl, *flags):
    ds = SyntheticTrajDataset(num_frames=FRAMES, height=H, width=W,
                              transform=ttrain.make_transform(H, W))
    return ttrain.Trainer(get_args([*FLAGS, "--imu-denoise-model-name", pkl,
                                    *flags]), ds, device="cpu")


def _snapshot(tr):
    return {"motions": tr.prev_vo_motions.clone(),
            "pose": {k: p.detach().clone() for k, p in tr.vo_params.items()},
            "denoiser": {k: p.detach().clone()
                         for k, p in tr.imu_params.items()},
            "grads": {k: g.clone() for k, g in tr.last_grads.items()}}


def _epochs(pkl, tmp, *flags):
    """Epochs 1 ('vo') and 2 ('imu') with snapshots under ``tmp``; the
    state after each."""
    tr = _trainer(pkl, *flags)
    out = []
    for epoch in (1, 2):
        tr.run_epoch(epoch, snapshot_dir=str(tmp))
        out.append(_snapshot(tr))
    return tr, out


@pytest.fixture(scope="module")
def runs(pkl, tmp_path_factory):
    """Window by window (with --profile-dir) and with --scan-chunk 2."""
    tmp = tmp_path_factory.mktemp("runs")
    per_window = _epochs(pkl, tmp / "per_window", "--profile-dir",
                         str(tmp / "profile"))
    scanned = _epochs(pkl, tmp / "scanned", "--scan-chunk", str(K))
    return {"tmp": tmp, "per_window": per_window, "scanned": scanned}


def _windows(tr, n):
    """The first ``n`` windows' device inputs, as ``prepare`` makes them."""
    return [tr.prepare(bi)[:2] for bi in range(n)]


def _step_args(tr):
    return (tr.rgb2imu_pose, tr.imu_module.gravity, tr.imu_module.accel_bias,
            tr.imu_module.gyro_bias, torch.tensor(tr.imu_module.optm_bias))


@pytest.fixture(scope="module")
def trainer(pkl):
    return _trainer(pkl)


def _replayed(seed=0):
    """(K, B, 7) motions near the identity, for 'imu' windows to replay."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((K, B, 7), generator=gen) * 1e-2
            + torch.tensor([0, 0, 0, 0, 0, 0, 1.0]))


@pytest.mark.parametrize("target", ["vo", "imu"])
def test_train_scan_equals_a_loop_of_train_step(trainer, target):
    """Losses, summed gradients and the carry, bitwise; for 'imu' (which
    replays motions) also with the K windows stacked on a leading axis."""
    tr = trainer
    kw = dict(target=target, denoiser=tr.denoiser, datatype="kitti",
              use_kitti_coord=True, denoise_gyro=False,
              loss_weight=(1.0, 0.1, 10.0, 0.1), trans_w=0.1)
    wins = _windows(tr, K)
    init = tr._state(tr.dataset.imu_init)
    prev = _replayed() if target == "imu" else None
    losses, grads, state, carries = [], None, init, []
    for k, (batch, win) in enumerate(wins):
        loss, g, aux = ttrain.train_step(
            tr.model, batch, win, state, *_step_args(tr),
            prev_motions=None if prev is None else prev[k], **kw)
        grads = g if grads is None else {n: grads[n] + g[n] for n in g}
        state = aux["carry"]
        losses.append(loss)
        carries.append(aux["pgo_poses"])
    stacked_batches = {n: torch.stack([b[n] for b, _ in wins])
                       for n in wins[0][0]}
    stacked_wins = tuple(torch.stack(x) for x in zip(*(w for _, w in wins)))
    forms = [([b for b, _ in wins], [w for _, w in wins])]
    if target == "imu":
        forms.append((stacked_batches, stacked_wins))
    for batches, imu_wins in forms:
        sl, sg, saux = ttrain.train_scan(
            tr.model, batches, imu_wins, init, *_step_args(tr),
            prev_motions=prev, **kw)
        assert torch.equal(sl, torch.stack(losses))
        assert sorted(sg) == sorted(grads)
        assert all(torch.equal(sg[n], grads[n]) for n in grads)
        assert all(torch.equal(a, b) for a, b in zip(saux["carry"], state))
        assert torch.equal(saux["pgo_poses"], torch.stack(carries))
        assert saux["ok"].shape == (K,) and bool(saux["ok"].all())


def test_concat_free_keyword_reaches_the_flow_net(trainer):
    """``concat_free`` on ``train_step`` and ``train_scan`` (a keyword, as
    islam_tpu/train.py:56,212 has it) runs the flow net's concat-free
    decoder, which computes the same flow: the losses within 1e-5 relative
    and the 'vo' gradients within 1e-3 of the largest (the port's 1e-3 x
    max|g| gradient tolerance against JAX)."""
    tr = trainer
    kw = dict(target="vo", denoiser=tr.denoiser, datatype="kitti",
              use_kitti_coord=True, denoise_gyro=False,
              loss_weight=(1.0, 0.1, 10.0, 0.1), trans_w=0.1)
    wins = _windows(tr, K)
    init = tr._state(tr.dataset.imu_init)
    seen = []
    hook = tr.model.flowNet.register_forward_pre_hook(
        lambda m, args, kwargs: seen.append(kwargs.get("concat_free")),
        with_kwargs=True)
    try:
        out = {cf: ttrain.train_scan(
            tr.model, [b for b, _ in wins], [w for _, w in wins], init,
            *_step_args(tr), concat_free=cf, **kw) for cf in (False, True)}
        step = ttrain.train_step(tr.model, *wins[0], init, *_step_args(tr),
                                 concat_free=True, **kw)
    finally:
        hook.remove()
    assert seen == [False] * K + [True] * K + [True]
    (l0, g0, _), (l1, g1, _) = out[False], out[True]
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5)
    np.testing.assert_allclose(step[0].numpy(), l1[0].numpy(), rtol=1e-6)
    gmax = max(float(g.abs().max()) for g in g0.values())
    for n in g0:
        _close(g1[n], g0[n], 1e-3 * gmax)


def test_train_scan_refuses_inference_targets(trainer):
    tr = trainer
    (batch, win), = _windows(tr, 1)
    with pytest.raises(ValueError, match="inference epochs use train_step"):
        ttrain.train_scan(tr.model, [batch], [win],
                          tr._state(tr.dataset.imu_init), *_step_args(tr),
                          target="")


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_scanned_vo_epoch_matches_per_window(runs):
    (ref_tr, ref), (scan_tr, scan) = runs["per_window"], runs["scanned"]
    assert scan_tr.chunk_seconds[1] and len(scan_tr.chunk_seconds[1]) == 1
    assert len(scan_tr.window_seconds[1]) == 3 and not ref_tr.chunk_seconds[1]
    _close(scan[0]["motions"], ref[0]["motions"], 1e-5)
    for k in ref[0]["pose"]:
        _close(scan[0]["pose"][k], ref[0]["pose"][k], 1e-6)
    for epoch in ("1", "2"):
        _close(np.loadtxt(runs["tmp"] / "scanned" / epoch / "pgo_pose.txt"),
               np.loadtxt(runs["tmp"] / "per_window" / epoch /
                          "pgo_pose.txt"), 1e-4)


def test_scanned_imu_epoch_with_denoiser_matches_per_window(runs):
    (ref_tr, ref), (scan_tr, scan) = runs["per_window"], runs["scanned"]
    assert len(scan_tr.chunk_seconds[2]) == 1
    gmax = max(float(g.abs().max()) for g in ref[1]["grads"].values())
    for k, g in ref[1]["grads"].items():
        _close(scan[1]["grads"][k], g, 1e-5 * gmax)
    for k in ref[1]["denoiser"]:
        _close(scan[1]["denoiser"][k], ref[1]["denoiser"][k], 2 * IMU_LR)
    _close(scan[1]["motions"], ref[1]["motions"], 1e-5)
    assert scan_tr.window_losses[2] == pytest.approx(ref_tr.window_losses[2],
                                                     rel=1e-4)


def test_chunk_prefetch_matches_serial(pkl, monkeypatch):
    """The next chunk is prepared on a worker thread (forced on with two
    cores) while the current one runs: bitwise the serial run.  An 'imu'
    epoch that replays given motions (the VO forward would add nothing to
    what the prefetch does)."""
    motions = torch.cat([_replayed(0), _replayed(1)[:1]]).reshape(-1, 7)
    out = []
    for workers in ("0", "1"):
        if workers == "1":
            monkeypatch.setattr(os, "cpu_count", lambda: 2)
        tr = _trainer(pkl, "--scan-chunk", str(K), "--worker-num", workers)
        tr.prev_vo_motions = motions
        tr.run_epoch(2)
        assert len(tr.chunk_seconds[2]) == 1
        out.append((tr.window_losses[2], _snapshot(tr)))
    (serial_losses, serial), (losses, threaded) = out
    assert losses == serial_losses
    for name in ("denoiser", "grads"):
        for k, v in serial[name].items():
            assert torch.equal(threaded[name][k], v), (name, k)


def test_eval_epoch_with_scan_chunk_runs_window_by_window(runs):
    """Inference epochs are never scanned (islam_tpu/train.py:458)."""
    scan_tr = runs["scanned"][0]
    scan_tr.prev_vo_motions = None
    scan_tr.run_epoch(0)
    assert scan_tr.chunk_seconds[0] == []
    assert len(scan_tr.window_seconds[0]) == 3


def test_profile_dir_traces_the_second_window_only(runs):
    """Two epochs with --profile-dir: one trace, of epoch 1's window 1."""
    files = sorted(os.listdir(runs["tmp"] / "profile"))
    assert files == ["epoch1_window1_trace.json"]
    path = runs["tmp"] / "profile" / files[0]
    assert os.path.getsize(path) > 0
    assert '"traceEvents"' in open(path).read(4096)


def test_profile_dir_trace_holds_the_step_ranges(runs):
    """The --profile-dir trace wraps the window's ``islam::step`` range and
    the ranges inside it ('vo' epoch: all five)."""
    path = runs["tmp"] / "profile" / "epoch1_window1_trace.json"
    text = open(path).read()
    for name in ("step", "vo_forward", "imu", "pvgo", "backward", "guard"):
        assert f'"islam::{name}"' in text, name
