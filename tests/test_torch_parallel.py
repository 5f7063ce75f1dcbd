"""The port's multi-sequence training on ``torch.distributed`` against the
JAX package's ``MultiSequenceTrainer``, and the port's own cases of
tests/test_parallel.py.

Two synthetic sequences of 7 frames (3 windows) at 64x128, B=2 (seeds 0 and
1; sequence 1 on the distinct calibration of tests/test_parallel.py,
``testing.make_sequences``), one VONet parameter tree
from ``jax.eval_shape`` filled from a seed, with constant flow and disparity
heads (tests/test_torch_slice.py::_with_constant_heads, so the scale least
squares sees real masks), and the seed-1 JAX denoiser; weights cross over
with ``state_dict_from_jax`` and ``denoiser_state_dict_from_jax``.  JAX
runs on ``make_mesh(2)`` of the suite's 8 virtual CPU devices; the port on
a one-rank gloo group in this process, both sequences local.  One module
fixture runs epoch 1 ('vo') then epoch 2 ('imu' replay) on both sides, and
records the sequence-mean gradients JAX's trainer hands its optimizers.

Tolerances, from tests/test_parallel.py: motion cache 1e-4, per-sequence
pgo_pose snapshots 1e-3, epoch-end carries 1e-4, the pose head after the
'vo' update 1e-5 (Adam at lr 3e-6: a gradient entry near 0 whose sign
differs moves by 2 lr), the denoiser after the 'imu' update 1e-4 (lr
3e-5); window losses rtol 1e-3, as tests/test_torch_train.py holds one
window's.  The Adam steps cannot show the gradients' scale (Adam's step is
~lr x sign(g)), so the epoch's summed sequence-mean gradients are held to
JAX's at 1e-3 x max|g|, as tests/test_torch_train.py holds an epoch's.

Across processes: ``python -m islam_tpu_torch.validate_multihost --device
cpu`` (2 gloo ranks, 2 sequences each) against the same 4 sequences in
this process.  Its one step: loss and gradient checksum within 1e-6
relative.  Its trainer ('vo' and 'imu' epochs, save, resume): window
losses, gradient checksums and every sequence's snapshots within 1e-6
relative (the same arithmetic but for the order of the sequence sums),
the saved carries 1e-6, the saved parameters 2 lr (Adam's sign flips).
Both ranks' checksums and parameters are bitwise equal, and both resumed
bitwise.  Every collective has a timeout
(``initialize_distributed(timeout=)``), and the subprocess its own.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from islam_tpu import testing as jtesting
from islam_tpu.imu import denoiser as jdn
from islam_tpu.models.vonet import VONet as JVONet
from islam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from islam_tpu.parallel.trainer import MultiSequenceTrainer as JaxTrainer
from islam_tpu_torch import testing
from islam_tpu_torch import validate_multihost as vm
from islam_tpu_torch.parallel import mesh as tmesh
from islam_tpu_torch.parallel.trainer import MultiSequenceTrainer
from islam_tpu_torch.utils import checkpoints as ckpt
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           state_dict_from_jax)

from tests.test_torch_slice import _with_constant_heads
from tests.test_torch_variants import jax_variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 128, 2
LR, IMU_LR = 3e-6, 3e-5
FRAMES = 7             # 3 windows
TIMEOUT = 120          # seconds a collective may wait
SUBPROCESS_TIMEOUT = 300
STATE = ("pos", "rot", "vel")


def _recording(opt, log):
    """An optax transform that records the gradients it is given."""
    def update(grads, state, params=None):
        log.append(jax.device_get(grads))
        return opt.update(grads, state, params)
    return optax.GradientTransformation(opt.init, update)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for this module's port trainers."""
    tmesh.initialize_distributed(f"localhost:{tmesh.free_port()}", 1, 0,
                                 device="cpu", timeout=TIMEOUT)
    yield tmesh.make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def weights():
    z = np.zeros((1, H, W, 3), np.float32)
    zi = np.zeros((1, H // 4, W // 4, 2), np.float32)
    variables = _with_constant_heads(jax_variables(JVONet(), z, z, z, z, zi,
                                                   seed=0))
    dn_params = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    return {"jax": (variables, dn_params),
            "port": (state_dict_from_jax(variables),
                     denoiser_state_dict_from_jax(dn_params))}


def _port_trainer(group, weights, frames=5, denoiser=True):
    sd, dn_sd = weights["port"]
    return MultiSequenceTrainer(
        testing.make_sequences(range(2), frames, H, W), batch_size=B,
        lr=LR, imu_lr=IMU_LR, mesh=group,
        state_dict=sd, denoiser_state_dict=dn_sd if denoiser else None,
        device="cpu")


def _snapshot(root, s, epoch, name="pgo_pose"):
    return np.loadtxt(os.path.join(root, f"seq{s}", str(epoch),
                                   f"{name}.txt"))


@pytest.fixture(scope="module")
def runs(group, weights, tmp_path_factory):
    """Epochs 1 and 2 of both trainers, with snapshots, and the gradients
    each hands its optimizers."""
    variables, dn_params = weights["jax"]
    tmp = tmp_path_factory.mktemp("parallel")
    out = {"jax": {}, "port": {}}

    datasets = [jtesting.make_dataset(num_frames=FRAMES, height=H, width=W,
                                      seed=s) for s in range(2)]
    for k, v in testing.SEQ1_CALIB.items():
        setattr(datasets[1], k, v)
    jtr = JaxTrainer(datasets, batch_size=B, lr=LR, imu_lr=IMU_LR,
                     mesh=jax_make_mesh(2), vo_variables=variables,
                     dn_params=dn_params)
    jlog = []
    jtr.opt = _recording(jtr.opt, jlog)
    jtr.imu_opt = _recording(jtr.imu_opt, jlog)
    ttr = _port_trainer(group, weights, FRAMES)
    for side, tr in (("jax", jtr), ("port", ttr)):
        snap = str(tmp / side)
        r = out[side]
        r["snap"] = snap
        r["losses1"] = tr.run_epoch(epoch=1, snapshot_dir=snap)
        r["motions1"] = np.array(tr.prev_vo_motions)
        r["carry1"] = [{k: np.array(st[k]) for k in STATE}
                       for st in tr._init_states]
        if side == "jax":
            r["pose1"] = state_dict_from_jax({"params": {
                "flowPoseNet": jax.device_get(
                    tr.vo_variables["params"]["flowPoseNet"])}})
        else:
            r["pose1"] = {k: p.detach().clone()
                          for k, p in tr.vo_params.items()}
            r["grads1"] = {k: g.clone() for k, g in tr.last_grads.items()}
        r["losses2"] = tr.run_epoch(epoch=2, snapshot_dir=snap)
        r["motions2"] = np.array(tr.prev_vo_motions)
        r["carry2"] = [{k: np.array(st[k]) for k in STATE}
                       for st in tr._init_states]
        if side == "port":
            r["grads2"] = {k: g.clone() for k, g in tr.last_grads.items()}
    jg1, jg2 = jlog
    out["jax"]["grads1"] = state_dict_from_jax({"params": {
        "flowPoseNet": jg1}})
    out["jax"]["grads2"] = denoiser_state_dict_from_jax(jg2)
    out["jax"]["dn2"] = denoiser_state_dict_from_jax(
        jax.device_get(jtr.dn_params))
    out["port"]["dn2"] = {k: p.detach().clone()
                          for k, p in ttr.imu_params.items()}
    out["port"]["trainer"] = ttr
    return out


@pytest.mark.parametrize("epoch", [1, 2])
def test_losses_motions_and_carries_match_jax(runs, epoch):
    j, t = runs["jax"], runs["port"]
    assert len(t[f"losses{epoch}"]) == 3
    np.testing.assert_allclose(t[f"losses{epoch}"], j[f"losses{epoch}"],
                               rtol=1e-3)
    assert t[f"motions{epoch}"].shape == j[f"motions{epoch}"].shape == (
        2, 6, 7)
    np.testing.assert_allclose(t[f"motions{epoch}"], j[f"motions{epoch}"],
                               atol=1e-4)
    for s in range(2):
        for k in STATE:
            np.testing.assert_allclose(t[f"carry{epoch}"][s][k],
                                       j[f"carry{epoch}"][s][k], atol=1e-4,
                                       err_msg=f"sequence {s} {k}")
        got = _snapshot(t["snap"], s, epoch)
        assert got.shape == (FRAMES, 7)
        np.testing.assert_allclose(got, _snapshot(j["snap"], s, epoch),
                                   atol=1e-3, err_msg=f"sequence {s}")


@pytest.mark.parametrize("epoch", [1, 2], ids=["vo", "imu"])
def test_epoch_gradients_match_jax(runs, epoch):
    """The gradients of the epoch's one optimizer update: each window's
    mean over the two sequences, summed over the windows."""
    ref, got = runs["jax"][f"grads{epoch}"], runs["port"][f"grads{epoch}"]
    assert sorted(got) == sorted(ref)
    atol = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    assert atol > 0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)


def test_updates_match_jax(runs):
    """The pose head after the 'vo' epoch, the denoiser after 'imu'."""
    j, t = runs["jax"], runs["port"]
    assert sorted(t["pose1"]) == sorted(j["pose1"])
    for k, v in j["pose1"].items():
        np.testing.assert_allclose(t["pose1"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    assert sorted(t["dn2"]) == sorted(j["dn2"])
    for k, v in j["dn2"].items():
        np.testing.assert_allclose(t["dn2"][k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)


def test_imu_epoch_replays_the_motion_cache(runs):
    """'imu' replays the 'vo' epoch's motions: the cache is bitwise
    unchanged, and the sequences' own calibrations made them differ."""
    for side in ("jax", "port"):
        np.testing.assert_array_equal(runs[side]["motions2"],
                                      runs[side]["motions1"], err_msg=side)
    m = runs["port"]["motions1"]
    assert not np.allclose(m[0], m[1], atol=1e-3)


# ---------------------------------------------------------------------------
# the port alone, as tests/test_parallel.py holds the JAX trainer
# ---------------------------------------------------------------------------

def _pose(tr):
    return {k: p.detach().clone() for k, p in tr.vo_params.items()}


@pytest.mark.parametrize("scan_chunk", [3, 2],
                         ids=["one-chunk", "chunk+tail"])
def test_scan_chunk_matches_per_window(group, weights, runs, scan_chunk,
                                       tmp_path):
    """A 'vo' epoch of 3 windows scanned against the fixture's window by
    window: one chunk of 3, and one chunk of 2 with a tail window on the
    per-window step, with snapshots after every window.  The scan sums the
    gradients in another order, so not bitwise: losses 1e-5, pose head
    1e-6, carries 1e-4, as tests/test_parallel.py."""
    ref = runs["port"]
    t = _port_trainer(group, weights, FRAMES)
    snap = str(tmp_path / "snaps")
    losses = t.run_epoch(scan_chunk=scan_chunk, epoch=1, snapshot_dir=snap,
                         snapshot_interval=1)
    assert len(losses) == (FRAMES - 1) // B
    assert len(t.collective[1]) == 1 + (scan_chunk == 2)
    np.testing.assert_allclose(losses, ref["losses1"], atol=1e-5)
    for k, v in ref["pose1"].items():
        np.testing.assert_allclose(t.vo_params[k].detach().numpy(),
                                   v.numpy(), atol=1e-6, err_msg=k)
    for s in range(2):
        for k in STATE:
            np.testing.assert_allclose(t._init_states[s][k],
                                       ref["carry1"][s][k], atol=1e-4)
        d = os.path.join(snap, f"seq{s}", "1")
        for f in ("vo_pose.txt", "pgo_pose.txt", "pgo_vel.txt",
                  "imu_pose.txt", "vo_motion.txt", "pgo_motion.txt"):
            assert os.path.isfile(os.path.join(d, f)), f
        vo = np.loadtxt(os.path.join(d, "vo_pose.txt"))
        assert vo.shape == (FRAMES, 7) and np.isfinite(vo).all()


def test_multi_sequence_train_scan_equals_the_epoch(group, weights, runs):
    """``multi_sequence_train_scan`` over both sequences' 3 windows as one
    chunk, 'imu' on the fixture's replayed 'vo' motions, with stacked
    inputs placed by ``shard_batch``, against the fixture trainer's
    per-window epoch 2: its window losses, mean gradients and carries (the
    same sums in another order: 1e-6).  The trainer's scan tests above run
    it for 'vo' from lists."""
    K = (FRAMES - 1) // B
    t = _port_trainer(group, weights, FRAMES)
    wins = [t._window_inputs(k * B) for k in range(K)]
    batches, imu = (tmesh.shard_batch(group, tmesh.stack(
        [tmesh.stack([wins[k][i][s] for k in range(K)]) for s in range(2)]))
        for i in (0, 1))
    inits = tmesh.shard_batch(group, tmesh.stack(
        [testing.init_state(ds, "cpu") for ds in t.datasets]))
    ref = runs["port"]
    prev = tmesh.shard_batch(group, torch.as_tensor(
        ref["motions1"]).reshape(2, K, B, 7))
    step = tmesh.multi_sequence_train_scan(group, target="imu",
                                           **t._static_kwargs)
    record = {}
    losses, grads, aux = step(t.model, t.denoiser, batches, imu, inits,
                              *t._consts, prev, record=record)
    assert losses.shape == (2, K)
    np.testing.assert_allclose(losses.mean(0).numpy(), ref["losses2"],
                               rtol=1e-6)
    gmax = max(float(g.abs().max()) for g in ref["grads2"].values())
    assert sorted(grads) == sorted(ref["grads2"])
    for k, g in ref["grads2"].items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                   atol=1e-6 * gmax, err_msg=k)
    for s in range(2):
        for i, k in enumerate(STATE):
            np.testing.assert_allclose(aux["carry"][i][s].numpy(),
                                       ref["carry2"][s][k], atol=1e-6)
    # one buffer: the (2, K) losses and every denoiser gradient, float32
    assert record["bytes"] == 4 * (2 * K + sum(g.numel()
                                               for g in grads.values()))


def test_inference_epoch_with_scan_chunk_and_denoiser(group, weights):
    """Epoch 0 with ``scan_chunk`` and a denoiser steps window by window
    (the JAX trainer's guard): finite losses, no update."""
    t = _port_trainer(group, weights)
    before = _pose(t)
    losses = t.run_epoch(scan_chunk=2, epoch=0)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert t.last_grads is None
    for k, v in before.items():
        assert torch.equal(t.vo_params[k], v), k


@pytest.mark.parametrize("built_with_denoiser", [True, False])
def test_save_resume_round_trip(group, weights, runs, tmp_path,
                                built_with_denoiser):
    """The fixture's trainer after epochs 1 and 2, saved; a fresh trainer
    resumes it bitwise, with or without a denoiser of its own; without,
    the resume builds it and its Adam, and an 'imu' epoch trains it on."""
    from islam_tpu_torch import optim

    src = runs["port"]["trainer"]
    src.save_models(str(tmp_path), 2)
    t = _port_trainer(group, weights, denoiser=built_with_denoiser)
    assert (t.denoiser is not None) == built_with_denoiser
    assert t.resume(str(tmp_path), start_epoch=3) == 2
    for a, b in ((t.model.state_dict(), src.model.state_dict()),
                 (t.denoiser.state_dict(), src.denoiser.state_dict())):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in ((t.opt_state, src.opt_state),
                 (t.imu_opt_state, src.imu_opt_state)):
        a, b = optim.state_dict(a), optim.state_dict(b)
        assert a["count"] == b["count"]
        for part in ("mu", "nu"):
            for k in b[part]:
                assert torch.equal(a[part][k], b[part][k]), (part, k)
    for s in range(2):
        for k in STATE:
            np.testing.assert_array_equal(t._init_states[s][k],
                                          src._init_states[s][k])
    if not built_with_denoiser:   # 'imu' through the Adam the resume built
        dn = {k: p.detach().clone() for k, p in t.imu_params.items()}
        t.prev_vo_motions = src.prev_vo_motions   # replay, no VO forward
        losses = t.run_epoch(epoch=2)
        assert np.isfinite(losses).all()
        assert any(not torch.equal(p, dn[k])
                   for k, p in t.imu_params.items())


@pytest.mark.parametrize("n,world,rank,want", [
    (8, 1, 0, (0, 8)), (4, 2, 1, (2, 4)), (3, 2, 0, None)])
def test_host_local_batch_slice(group, monkeypatch, n, world, rank, want):
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: world)
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda: rank)
    if want is None:
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.host_local_batch_slice(n)
    else:
        s = tmesh.host_local_batch_slice(n)
        assert (s.start, s.stop) == want


def test_initialize_distributed_is_a_no_op_the_second_time(group):
    before = dist.group.WORLD
    # an address no store listens on: joining it would hang, then raise
    tmesh.initialize_distributed("localhost:1", 2, 1, device="cpu",
                                 timeout=1)
    assert dist.group.WORLD is before and dist.get_world_size() == 1
    assert tmesh.make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="needs as many ranks"):
        tmesh.make_mesh(2, device="cpu")


@pytest.fixture(scope="module")
def procs(group, tmp_path_factory):
    """``validate_multihost --device cpu`` (2 gloo processes of 2 sequences
    each) and, while it runs, the same 4 sequences in this process."""
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "islam_tpu_torch.validate_multihost",
         "--device", "cpu", "--height", str(H), "--width", str(W),
         "--batch-size", str(B), "--timeout", str(TIMEOUT),
         "--wait", str(SUBPROCESS_TIMEOUT - 30), "--out", str(tmp / "two")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        one = vm.run_trainer(group, range(4), H, W, B, str(tmp / "one"),
                             vm.initial_weights(H, W))
        out, _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    summary = [json.loads(line) for line in out.splitlines()
               if line.startswith('{"validate_multihost"')]
    assert len(summary) == 1, out[-6000:]
    ranks = summary[0]["ranks"]
    assert [r["sequences"] for r in ranks] == [[0, 1], [2, 3]]
    assert all(r["finite"] and r["backend"] == "gloo" for r in ranks)
    return {"ranks": ranks, "one": one, "dirs": (tmp / "two", tmp / "one")}


def test_two_processes_equal_one(procs):
    """The one 'vo' step and its Adam step: ranks bitwise equal, and equal
    within 1e-6 to the same window in one process, the one-process
    trainer's 'vo' epoch (loss, gradient checksum, collective bytes)."""
    ranks, one = procs["ranks"], procs["one"]
    for key in ("loss", "grad_checksum", "params_sha256"):
        assert ranks[0][key] == ranks[1][key], key
    np.testing.assert_allclose(ranks[0]["loss"], one["trainer_losses"][0][0],
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["grad_checksum"],
                               one["trainer_grad_checksums"][0], rtol=1e-6)
    (vo_window,) = one["trainer_collective"][1]
    assert ranks[0]["collective_bytes"] == vo_window["bytes"]


def test_two_process_trainer_equals_one(procs):
    """``MultiSequenceTrainer`` on 2 ranks of 2 sequences against 1 rank
    of 4: 'vo' and 'imu' window losses and gradient checksums, every
    sequence's snapshots (written by the rank that owns it), and the save
    rank 0 wrote (parameters, optimizer counts, all 4 carries); parameters
    bitwise equal across the ranks; both resumed bitwise."""
    ranks, one = procs["ranks"], procs["one"]
    for key in ("trainer_losses", "trainer_grad_checksums",
                "trainer_params_sha256"):
        assert ranks[0][key] == ranks[1][key], key
    assert all(r["resumed"] and one["resumed"] for r in ranks), [
        r["resume_unequal"] for r in ranks]
    for key in ("trainer_losses", "trainer_grad_checksums"):
        np.testing.assert_allclose(ranks[0][key], one[key], rtol=1e-6,
                                   err_msg=key)
    two_dir, one_dir = procs["dirs"]
    for s in range(4):
        for epoch in (1, 2):
            for name in ("vo_motion", "pgo_pose", "pgo_vel", "imu_pose"):
                got, want = (np.loadtxt(os.path.join(
                    d, "snapshots", f"seq{s}", str(epoch), f"{name}.txt"))
                    for d in (two_dir, one_dir))
                assert got.shape == want.shape and len(got) >= B, name
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"seq{s}/{epoch}/{name}")
    two, ref = (ckpt.restore_checkpoint(os.path.join(d, "models"), 2)
                for d in (two_dir, one_dir))
    assert len(two["seq_states"]) == len(ref["seq_states"]) == 4
    for a, b in zip(two["seq_states"], ref["seq_states"]):
        for k in STATE:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       atol=1e-6)
    for part, atol in (("model", 2 * LR), ("denoiser", 2 * IMU_LR)):
        assert sorted(two[part]) == sorted(ref[part])
        for k, v in ref[part].items():
            np.testing.assert_allclose(
                two[part][k].float().numpy(), v.float().numpy(),
                atol=atol + 2 * float(np.spacing(np.float32(
                    v.float().abs().max()))), err_msg=f"{part} {k}")
    for opt in ("vo_opt_state", "imu_opt_state"):
        assert int(two[opt]["count"]) == int(ref[opt]["count"]) == 1, opt
