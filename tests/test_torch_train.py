"""The port's training path vs the JAX package: ``train_step`` for the 'vo'
and 'imu' targets, one SGD epoch of each against the JAX ``Trainer``, the
optimizers against optax, and ``--fix-model-parts``.

Two windows of B=2 frame-pairs at 64x128 on the synthetic trajectory.  Both
sides start from the same weights: the JAX initialisation with constant flow
and disparity heads (``_with_constant_heads``, so the scale least squares
sees real masks and the translation part of the 'vo' gradient is exercised),
carried over with ``state_dict_from_jax``, and the JAX denoiser (PRNGKey(1))
written as a reference ``.pkl`` that both trainers read.  One module fixture
runs the JAX side once: the window calls and the ``Trainer`` epochs use the
same two compiled programs.

Tolerances.  Losses, aux and carries as in tests/test_torch_slice.py (VO
motions and PVGO poses 1e-4, IMU outputs 2e-5 in the first window, PVGO
velocities 2e-3).  Gradients at atol 1e-3 x max|g|, the largest entry of
all the window's (or epoch's) gradients: the rotation head's agree to
~5e-6 relative (float32 convolutions summed in other orders).  The
translation head's are 1e-7 of that, because the translation part of the
VO loss sits near its minimum (the PVGO solution follows the VO
translations), and they carry ~5 % float32 rounding; they are held to the
same atol and, on their own, to a cosine of 0.99 with JAX's.  SGD-updated
parameters: exact arithmetic on top of those gradients, so atol
1e-3 x lr x max|g| + 2 ulp of the parameter.  The denoiser's Adam step
is ~lr x sign(g), and a gradient near 0 can flip its sign between the two
sides, so the Adam-updated parameters are compared at atol 2 x lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from islam_tpu import testing as jtesting
from islam_tpu.arguments import get_args as jax_get_args
from islam_tpu.imu import denoiser as jdn
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.train import Trainer as JaxTrainer
from islam_tpu.train import train_step as jax_train_step
from islam_tpu_torch import optim
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.utils.weights import (denoiser_state_dict_from_jax,
                                           flax_path_to_torch_key,
                                           grads_from_jax, state_dict_from_jax)

from tests.rng_helpers import PerTestRNG
from tests.test_torch_data import kitti_from_origin
from tests.test_torch_slice import _with_constant_heads
from tests.test_torch_slice import shared_jax_init  # noqa: F401

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B = 64, 128, 2
FRAMES = 2 * B + 1
WEIGHTS = (1.0, 0.1, 10.0, 0.1)
LR, IMU_LR = 1e-3, 3e-5
KEYS = ("motions", "imu_poses", "imu_vels", "pgo_poses", "pgo_vels")
RNG = PerTestRNG("torch-train")
COMMON = ["--data-type", "synthetic", "--image-height", str(H),
          "--image-width", str(W), "--batch-size", str(B),
          "--synthetic-frames", str(FRAMES), "--loss-weight", str(WEIGHTS),
          "--rot-w", "1", "--trans-w", "0.1", "--print-interval", "0",
          "--vo-optimizer", "sgd", "--lr", str(LR)]


def _recording(opt, log):
    """An optax transform that records the gradients it is given."""
    def update(grads, state, params=None):
        log.append(jax.device_get(grads))
        return opt.update(grads, state, params)
    return optax.GradientTransformation(opt.init, update)


def _jax_trainer(variables, pkl, fix=()):
    argv = COMMON + ["--imu-denoise-model-name", pkl]
    if fix:
        argv += ["--fix-model-parts", *fix]
    tr = JaxTrainer(jax_get_args(argv), jtesting.make_dataset(
        num_frames=FRAMES, height=H, width=W))
    tr.vo_variables = variables
    log = {"vo": [], "imu": []}
    tr.vo_opt = _recording(tr.vo_opt, log["vo"])
    tr.vo_opt_state = tr.vo_opt.init(variables["params"]["flowPoseNet"])
    tr.imu_opt = _recording(tr.imu_opt, log["imu"])
    return tr, log


def _pose_sd(tree):
    """A flowPoseNet pytree (params or grads) -> port state_dict keys."""
    return state_dict_from_jax({"params": {"flowPoseNet": tree}})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    variables = _with_constant_heads(jax.device_get(
        jtvo.init_params(jax.random.PRNGKey(0), H, W)))
    dn_params = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    pkl = str(tmp / "denoiser.pkl")
    torch.save(denoiser_state_dict_from_jax(dn_params), pkl)
    sd = state_dict_from_jax(variables)

    # ---- JAX: per-window train_step, as the Trainer calls it ----
    jtr, jlog = _jax_trainer(variables, pkl)
    jds, jimu = jtr.dataset, jtr.imu_module
    static = dict(datatype="kitti", correct_scale=False, use_kitti_coord=True,
                  denoise_accel=True, denoise_gyro=False,
                  loss_weight=WEIGHTS, rot_w=1.0, trans_w=0.1, bf16=False,
                  use_reproj=False, bilevel="detached", frozen_bn_eval=False)
    jwin = {"vo": [], "imu": []}
    for target in ("vo", "imu"):
        init = jtesting.make_step_inputs(jds, jimu, 0, B)[2]
        for w, st in enumerate((0, B)):
            batch, win, _ = jtesting.make_step_inputs(jds, jimu, st, B)
            prev = None if target == "vo" else jwin["vo"][w][2]["motions"]
            loss, grads, aux = jax_train_step(
                variables, jtr.dn_params, batch, win, init, jtr.rgb2imu_pose,
                jimu.gravity, jimu.accel_bias, jimu.gyro_bias,
                jnp.asarray(jimu.optm_bias), target=target,
                prev_motions=prev, **static)
            jwin[target].append(jax.device_get((loss, grads, aux)))
            init = aux["carry"]
    # ---- JAX: one 'vo' and one 'imu' epoch of the Trainer ----
    jtr.run_epoch(1)
    jvo_after = _pose_sd(jtr.vo_variables["params"]["flowPoseNet"])
    jtr.run_epoch(2)
    jdn_after = denoiser_state_dict_from_jax(jax.device_get(jtr.dn_params))

    # ---- the port: the same windows, then the same two epochs ----
    tds = SyntheticTrajDataset(num_frames=FRAMES, height=H, width=W,
                               transform=ttrain.make_transform(H, W))
    ttr = ttrain.Trainer(get_args(COMMON + [
        "--imu-denoise-model-name", pkl, "--device", "cpu"]), tds,
        device="cpu", state_dict=sd)
    twin = {"vo": [], "imu": []}
    for target in ("vo", "imu"):
        init = ttr._state(tds.imu_init)
        for w, st in enumerate((0, B)):
            batch = ttrain.device_batch(
                collate([tds[i] for i in range(st, st + B)]), st, "cpu")
            prev = None
            if target == "imu":
                prev = torch.tensor(np.asarray(jwin["vo"][w][2]["motions"]))
            out = ttrain.train_step(
                ttr.model, batch, ttr.imu_module.window_inputs(st, st + B),
                init, ttr.rgb2imu_pose, ttr.imu_module.gravity,
                ttr.imu_module.accel_bias, ttr.imu_module.gyro_bias,
                torch.tensor(ttr.imu_module.optm_bias), target=target,
                denoiser=ttr.denoiser, prev_motions=prev, datatype="kitti",
                use_kitti_coord=True, denoise_accel=True, denoise_gyro=False,
                loss_weight=WEIGHTS, rot_w=1.0, trans_w=0.1)
            twin[target].append(out)
            init = out[2]["carry"]
    tvo_before = {k: p.detach().clone() for k, p in ttr.vo_params.items()}
    ttr.run_epoch(1)
    tvo_grads = ttr.last_grads
    tvo_after = {k: p.detach().clone() for k, p in ttr.vo_params.items()}
    tdn_before = {k: p.detach().clone() for k, p in ttr.imu_params.items()}
    ttr.run_epoch(2)
    return {"jwin": jwin, "twin": twin, "jlog": jlog, "jtr": jtr,
            "jvo_after": jvo_after, "jdn_after": jdn_after, "ttr": ttr,
            "tvo_before": tvo_before, "tvo_grads": tvo_grads,
            "tvo_after": tvo_after, "tdn_before": tdn_before, "sd": sd,
            "variables": variables, "pkl": pkl, "tds": tds}


def _atol(key, window):
    if key.endswith("vels") and (window > 0 or key.startswith("pgo")):
        return 2e-3
    if key.startswith("imu"):
        return 2e-5 if window == 0 else 5e-4
    return 1e-4


def _gmax(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads.values())


def _close_grads(port, ref, what):
    assert sorted(port) == sorted(ref), what
    atol = 1e-3 * _gmax(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("window", [0, 1])
@pytest.mark.parametrize("target", ["vo", "imu"])
def test_train_step_matches_jax(run, target, window):
    jloss, jgrads, jaux = run["jwin"][target][window]
    tloss, tgrads, taux = run["twin"][target][window]
    assert bool(taux["ok"]) and bool(jaux["ok"])
    assert float(tloss) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    for k in ("trans_loss", "rot_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-3,
                                   atol=1e-9, err_msg=k)
    for k in KEYS:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   atol=_atol(k, window), err_msg=k)
    for t, j, atol in zip(taux["carry"], jaux["carry"], (1e-4, 1e-4, 2e-3)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)
    ref = (_pose_sd(jgrads) if target == "vo"
           else denoiser_state_dict_from_jax(jgrads))
    _close_grads(tgrads, ref, f"{target} window {window}")


@pytest.mark.parametrize("window", [0, 1])
def test_vo_gradient_has_both_parts(run, window):
    """With the constant heads the scale is nonzero, so the translation
    head gets a gradient as well as the rotation head, in JAX's direction."""
    tg = run["twin"]["vo"][window][1]
    ref = _pose_sd(run["jwin"]["vo"][window][1])
    for k in ref:
        if ".voflow_" not in k:
            continue
        a, b = tg[k].numpy().ravel(), ref[k].numpy().ravel()
        assert np.abs(a).max() > 0, k
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99, k


def test_vo_epoch_matches_jax_trainer(run):
    """Accumulated gradients and the SGD-updated pose head after epoch 1.
    The translation head's steps (lr x ~1e-7 of max|g|) fall below one ulp
    of its weights, so only the rotation head must have moved."""
    (jg,) = run["jlog"]["vo"]
    ref = _pose_sd(jg)
    _close_grads(run["tvo_grads"], ref, "vo epoch")
    gmax = _gmax(ref)
    for k, r in run["jvo_after"].items():
        np.testing.assert_allclose(
            run["tvo_after"][k].numpy(), r.numpy(),
            atol=1e-3 * LR * gmax + 2 * np.spacing(np.abs(r.numpy()).max()),
            err_msg=k)
        if ".voflow_rot." in k:
            assert not torch.equal(run["tvo_after"][k],
                                   run["tvo_before"][k]), k


def test_imu_epoch_matches_jax_trainer(run):
    """Epoch 2 replays epoch 1's motions: accumulated denoiser gradients
    and the Adam-updated denoiser."""
    ttr = run["ttr"]
    (jg,) = run["jlog"]["imu"]
    _close_grads(ttr.last_grads, denoiser_state_dict_from_jax(jg),
                 "imu epoch")
    for k, r in run["jdn_after"].items():
        np.testing.assert_allclose(ttr.imu_params[k].detach().numpy(),
                                   r.numpy(), atol=2 * IMU_LR, err_msg=k)
    moved = [not torch.equal(ttr.imu_params[k], run["tdn_before"][k])
             for k in ttr.imu_params]
    assert all(moved)
    # the pose head is untouched by an 'imu' epoch
    for k, p in ttr.vo_params.items():
        assert torch.equal(p, run["tvo_after"][k]), k


def test_imu_epoch_replays_the_vo_motions(run):
    """The 'imu' epoch ran no VO forward: its motions are epoch 1's."""
    ttr = run["ttr"]
    assert ttr.prev_vo_motions.shape == (2 * B, 7)
    np.testing.assert_allclose(
        ttr.prev_vo_motions.numpy(),
        np.concatenate([np.asarray(a[2]["motions"]) for a in run["jwin"]["vo"]]),
        atol=1e-4)


def test_imu_target_without_replay_runs_the_vo_forward(run):
    """Without cached motions the 'imu' step runs the VO forward itself and
    gets what the replay gets from the same motions."""
    ttr, tds = run["ttr"], run["tds"]
    batch = ttrain.device_batch(collate([tds[i] for i in range(B)]), 0, "cpu")
    args = (ttr.model, batch, ttr.imu_module.window_inputs(0, B),
            ttr._state(tds.imu_init), ttr.rgb2imu_pose,
            ttr.imu_module.gravity, ttr.imu_module.accel_bias,
            ttr.imu_module.gyro_bias, torch.tensor(False))
    kw = dict(target="imu", denoiser=ttr.denoiser, datatype="kitti",
              denoise_gyro=False, loss_weight=WEIGHTS, trans_w=0.1)
    loss, grads, aux = ttrain.train_step(*args, **kw)
    loss2, grads2, _ = ttrain.train_step(*args, prev_motions=aux["motions"],
                                         **kw)
    assert float(loss) == float(loss2)
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k


def test_imu_target_without_denoiser_trains_nothing(run):
    ttr, tds = run["ttr"], run["tds"]
    batch = ttrain.device_batch(collate([tds[i] for i in range(B)]), 0, "cpu")
    loss, grads, aux = ttrain.train_step(
        ttr.model, batch, ttr.imu_module.window_inputs(0, B),
        ttr._state(tds.imu_init), ttr.rgb2imu_pose, ttr.imu_module.gravity,
        ttr.imu_module.accel_bias, ttr.imu_module.gyro_bias,
        torch.tensor(True), target="imu", denoiser=None,
        prev_motions=ttr.prev_vo_motions[:B], loss_weight=WEIGHTS)
    assert grads is None and np.isfinite(float(loss)) and bool(aux["ok"])


def test_fix_model_parts_freezes_bitwise(run):
    """``--fix-model-parts feat``: the port leaves feat_net bitwise
    unchanged and still steps the heads.  The JAX trainer's
    ``optax.masked`` passes the raw gradient through for the masked leaves,
    so there feat_net moves by +g (an ascent step): a fault of the
    reference, not carried over."""
    variables = run["variables"]
    jtr, jlog = _jax_trainer(variables, run["pkl"], fix=("feat",))
    jtr.run_epoch(1)
    (jg,) = jlog["vo"]
    before = _pose_sd(variables["params"]["flowPoseNet"])
    after = _pose_sd(jtr.vo_variables["params"]["flowPoseNet"])
    grads = _pose_sd(jg)
    for k in before:
        if ".feat_net." in k:
            np.testing.assert_allclose(
                (after[k] - before[k]).numpy(), grads[k].numpy(),
                atol=2 * np.spacing(np.abs(before[k].numpy()).max()), err_msg=k)

    tr = ttrain.Trainer(get_args(COMMON + [
        "--device", "cpu", "--fix-model-parts", "feat"]), run["tds"],
        device="cpu", state_dict=run["sd"])
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    tr.run_epoch(1)
    assert not any(".feat_net." in k for k in tr.last_grads)
    assert any(".voflow_trans." in k for k in tr.last_grads)
    for k, p in tr.model.named_parameters():
        if k.startswith("flowPoseNet.feat_net.") or not k.startswith(
                "flowPoseNet."):
            assert torch.equal(p, before[k]), k
        elif ".voflow_rot." in k:  # the trans head's steps are sub-ulp
            assert not torch.equal(p, before[k]), k


def test_grads_from_jax_lays_out_like_the_parameter():
    path = ("params", "flowPoseNet", "rot_fc1", "kernel")
    g = RNG.normal(size=(12, 5)).astype(np.float32)
    out = grads_from_jax(path, g)
    assert flax_path_to_torch_key(path) == "flowPoseNet.voflow_rot.0.0.weight"
    np.testing.assert_array_equal(out.numpy(), g.T)


def test_guard_zeroes_nonfinite_gradients():
    init = IMUState(torch.zeros(3), torch.tensor([0., 0., 0., 1.]),
                    torch.ones(3))
    aux = {"carry": IMUState(torch.full((3,), 5.0),
                             torch.tensor([0., 1., 0., 0.]), torch.zeros(3))}
    grads = {"a": torch.tensor([1.0, float("inf")]), "b": torch.ones(2)}
    g, out = ttrain._guard_nonfinite(torch.tensor(1.0), grads, aux, init)
    assert not bool(out["ok"])
    assert all(float(v.abs().sum()) == 0 for v in g.values())
    for c, i in zip(out["carry"], init):
        assert torch.equal(c, i)
    g, out = ttrain._guard_nonfinite(torch.tensor(1.0), {"b": torch.ones(2)},
                                     aux, init)
    assert bool(out["ok"]) and torch.equal(g["b"], torch.ones(2))
    assert torch.equal(out["carry"].pos, torch.full((3,), 5.0))


# ---- the optimizers against optax on fixed gradients ----

def _optax(name, lr):
    return {"adam": optax.adam, "rmsprop": optax.rmsprop,
            "sgd": optax.sgd}[name](lr)


@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_optimizer_matches_optax(name):
    """Three steps from fixed parameters and gradients (some tiny, some
    zero).  float32 either side: rtol 1e-5 of the step."""
    lr = 1e-3
    params = {"w": RNG.normal(size=(4, 3)).astype(np.float32),
              "b": RNG.normal(size=(3,)).astype(np.float32)}
    steps = []
    for _ in range(3):
        g = {k: (RNG.normal(size=v.shape) * 10.0 ** RNG.integers(
            -6, 1, size=v.shape)).astype(np.float32) for k, v in params.items()}
        g["b"][0] = 0.0
        steps.append(g)

    jopt = _optax(name, lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = optim.OPTIMIZERS[name](lr)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in steps:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts)
        optim.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=2 * np.spacing(np.float32(
                                           np.abs(params[k]).max() + 1)))


def test_rmsprop_is_not_torchs():
    """optax's RMSprop (decay 0.9, eps inside the root) and torch's
    (alpha 0.99, eps outside) take different first steps."""
    g = torch.tensor([1e-3, 1.0])
    ours, _ = optim.rmsprop(1e-2).update({"p": g}, optim.rmsprop(1e-2).init(
        {"p": g}))
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.RMSprop([p], lr=1e-2)
    p.grad = g.clone()
    opt.step()
    assert not torch.allclose(ours["p"], p.detach(), rtol=1e-2)
    np.testing.assert_allclose(ours["p"].numpy(),
                               -1e-2 * g.numpy() / np.sqrt(0.1 * g.numpy() ** 2
                                                           + 1e-8), rtol=1e-6)


def test_adam_is_torchs():
    """optax.adam (eps outside the root, no eps_root) is torch.optim.Adam."""
    g = torch.tensor([1e-3, -2.0, 0.0])
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=1e-2)
    ours = {"p": torch.ones(3)}
    adam = optim.adam(1e-2)
    state = adam.init(ours)
    for _ in range(3):
        p.grad = g.clone()
        opt.step()
        u, state = adam.update({"p": g}, state)
        optim.apply_updates(ours, u)
    torch.testing.assert_close(ours["p"], p.detach(), rtol=1e-6, atol=1e-7)


def test_trainable_leaves_out_frozen_prefixes():
    named = [("flowPoseNet.feat_net.0.0.weight", torch.zeros(1)),
             ("flowPoseNet.voflow_rot.2.bias", torch.zeros(1)),
             ("flowPoseNet.voflow_trans.2.bias", torch.zeros(1))]
    got = optim.trainable(named, [ttrain.POSE_FIX["feat"],
                                  ttrain.POSE_FIX["trans"]])
    assert list(got) == ["flowPoseNet.voflow_rot.2.bias"]
    assert list(optim.trainable(named)) == [k for k, _ in named]


# ---- the folder datasets through ``main`` (KITTI, TartanAir fixtures) ----

def _jax_folder_epoch(kind, root, pkl, out):
    """The JAX ``Trainer``'s eval epoch on a sequence folder, built as the
    JAX ``main`` builds it, with the VO weights from ``pkl``."""
    from islam_tpu.data.dataset import TrajFolderDataset
    from islam_tpu.data.transforms import (Compose, CropCenter,
                                           DownscaleFlow, Normalize,
                                           ToNHWCTensor)
    args = jax_get_args(["--data-type", kind, "--data-root", root,
                         "--vo-model-name", pkl, *FOLDER])
    ds = TrajFolderDataset(root, kind, transform=Compose([
        CropCenter((H, W), fix_ratio=True), DownscaleFlow(),
        Normalize(mean=ttrain.MEAN, std=ttrain.STD, keep_old=True),
        ToNHWCTensor()]))
    JaxTrainer(args, ds).run_epoch(0, snapshot_dir=out)


FOLDER = ["--image-height", str(H), "--image-width", str(W), "--batch-size",
          str(B), "--loss-weight", str(WEIGHTS), "--rot-w", "1",
          "--trans-w", "0.1", "--print-interval", "0"]
# snapshot file -> atol, as tests/test_torch_slice.py holds the window's
# outputs (VO motions and PVGO poses 1e-4, PVGO velocities 2e-3, IMU
# poses of a second window 5e-4); the VO poses chain four motions
SNAPSHOT_ATOL = {"vo_motion": 1e-4, "vo_pose": 4e-4, "pgo_pose": 1e-4,
                 "pgo_vel": 2e-3, "imu_pose": 5e-4}


@pytest.fixture(scope="module")
def folder(run, tmp_path_factory):
    """KITTI (60x120, upscaled to 64x128) and TartanAir fixtures of 6
    frames (4 links: two windows of B=2), and the constant-head weights
    of ``run`` as a reference .pkl."""
    from islam_tpu_torch.data import fixtures
    tmp = tmp_path_factory.mktemp("folder")
    pkl = str(tmp / "vonet.pkl")
    torch.save(run["sd"], pkl)
    return {"pkl": pkl, "tmp": tmp,
            "kitti": fixtures.write_kitti(str(tmp / "k"), n=6, h=60, w=120),
            "tartanair": fixtures.write_tartanair(str(tmp / "t"), n=6)}


def _port_folder_epoch(kind, folder, out, *flags):
    return ttrain.main(["--eval-only", "--data-type", kind, "--data-root",
                        folder[kind], "--vo-model-name", folder["pkl"],
                        "--device", "cpu", "--result-dir", out, *FOLDER,
                        *flags])


def _snapshots_close(out, ref, expect_equal=True):
    worst = {}
    for name, atol in SNAPSHOT_ATOL.items():
        a = np.loadtxt(os.path.join(out, "0", f"{name}.txt"))
        b = np.loadtxt(os.path.join(ref, "0", f"{name}.txt"))
        assert a.shape == b.shape and np.isfinite(a).all(), name
        worst[name] = (float(np.abs(a - b).max()), atol)
    return all(d <= atol for d, atol in worst.values()), worst


@pytest.mark.parametrize("kind", ["kitti", "tartanair"])
def test_folder_eval_epoch_matches_jax_trainer(folder, kind, monkeypatch):
    """``main --eval-only --data-type kitti|tartanair`` on the CPU against
    the JAX ``Trainer`` on the same folder and weights: decoded, upscaled
    (KITTI) images, the loaded .pkl, and the frame of the VO motions
    (KITTI's for KITTI, TartanAir's own for TartanAir).  JAX's KITTI
    positions are taken from the first packet, as the port's are."""
    kitti_from_origin(monkeypatch)
    out, ref = (str(folder["tmp"] / f"{kind}_{s}") for s in ("port", "jax"))
    _jax_folder_epoch(kind, folder[kind], folder["pkl"], ref)
    trainer = _port_folder_epoch(kind, folder, out)
    assert len(trainer.window_seconds[0]) == 2
    assert np.abs(np.loadtxt(os.path.join(out, "0", "vo_motion.txt"))[
        :, :3]).max() > 1e-3   # the stereo scale path ran
    ok, worst = _snapshots_close(out, ref)
    assert ok, worst
    folder[f"{kind}_ref"] = ref


def test_tartanair_motions_are_not_in_kitti_coordinates(folder,
                                                        monkeypatch):
    """The port once passed ``use_kitti_coord=True`` for every dataset; on
    TartanAir that puts the VO motions in the wrong frame, and the epoch
    no longer matches JAX's."""
    ref = folder.get("tartanair_ref")
    if ref is None:
        ref = str(folder["tmp"] / "tartanair_jax2")
        _jax_folder_epoch("tartanair", folder["tartanair"], folder["pkl"],
                          ref)
    step = ttrain.train_step
    seen = []

    def old_step(*a, **kw):
        seen.append(kw["use_kitti_coord"])
        return step(*a, **{**kw, "use_kitti_coord": True})

    monkeypatch.setattr(ttrain, "train_step", old_step)
    out = str(folder["tmp"] / "tartanair_old")
    _port_folder_epoch("tartanair", folder, out)
    assert seen == [False, False]
    ok, worst = _snapshots_close(out, ref)
    assert not ok and worst["vo_motion"][0] > 1e-2, worst


def test_prefetch_on_and_off_give_equal_trajectories(folder):
    outs = []
    for workers in ("0", "2"):
        out = str(folder["tmp"] / f"kitti_workers{workers}")
        trainer = _port_folder_epoch("kitti", folder, out, "--worker-num",
                                     workers)
        outs.append(out)
        split = trainer.prep_split_seconds[0]
        assert len(split) == 2 and all(s["decode"] > 0 for s in split)
    for name in SNAPSHOT_ATOL:
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(outs[0], "0", f"{name}.txt")),
            np.loadtxt(os.path.join(outs[1], "0", f"{name}.txt")))


def test_prefetcher_reraises_worker_errors():
    def fn(key):
        if key == 1:
            raise ValueError("bad frame 1")
        return key * 10

    pf = ttrain.Prefetcher(fn)
    pf.start(0)
    pf.start(1)
    assert pf.pending(0) and pf.pending(1) and not pf.pending(2)
    assert pf.take(0) == 0
    with pytest.raises(RuntimeError, match="prefetch of item 1") as info:
        pf.take(1)
    assert isinstance(info.value.__cause__, ValueError)
    assert not pf.pending(1)


def _preset_flags(path, module, switches=None):
    """The flags a preset script passes to ``python -m <module>``, with its
    shell variables set as the script sets them and the environment
    ``switches`` (e.g. {"BF16": "1"}) set."""
    import re
    import shlex

    switches = switches or {}
    text = open(path).read()
    env = {k: (shlex.split(v) or [""])[0]
           for k, v in re.findall(r"^(\w+)=([^$\n]*)$", text, re.M)}
    env.update(result_dir="R", save_model_dir="R/models", data_dir="SEQ",
               train_name="T", **switches)
    call = text.split(f"python -m {module}", 1)[1].split("|")[0]
    # ${X:+...} is its text where X is set, else empty; ${X:-default} the
    # default
    call = re.sub(r"\$\{(\w+):\+([^}]*)\}",
                  lambda m: m.group(2) if m.group(1) in switches else "",
                  call).replace("\\\n", " ")
    call = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", call)
    call = re.sub(r"\$(\w+)", lambda m: env[m.group(1)], call)
    return shlex.split(call)


@pytest.mark.parametrize("kind", ["kitti", "euroc", "tartanair"])
def test_port_preset_scripts_pass_the_presets_flags(kind):
    """``islam_tpu_torch/scripts/run_<kind>.sh`` passes what
    ``scripts/run_<kind>.sh`` passes to the JAX entry point (its W&B names
    aside), with the ``SCAN_CHUNK`` and ``BF16`` switches unset and set, and
    the port's parser takes every flag."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for switches in ({}, {"BF16": "1", "SCAN_CHUNK": "2"}):
        port = get_args(_preset_flags(
            os.path.join(root, "islam_tpu_torch", "scripts",
                         f"run_{kind}.sh"), "islam_tpu_torch.train",
            switches))
        ref = jax_get_args(_preset_flags(
            os.path.join(root, "scripts", f"run_{kind}.sh"),
            "islam_tpu.train", switches))
        assert port.data_type == kind and port.device == "cuda"
        assert (port.bf16, port.scan_chunk) == (
            (True, 2) if switches else (False, 0))
        for name, value in vars(port).items():
            if name not in ("device", "data_type", "synthetic_frames",
                            "project_name", "train_name"):
                assert getattr(ref, name) == value, name
        # the JAX script's own command line (its W&B names included)
        # parses on the port as on JAX
        ref_flags = _preset_flags(
            os.path.join(root, "scripts", f"run_{kind}.sh"),
            "islam_tpu.train", switches)
        assert "--project-name" in ref_flags and "--train-name" in ref_flags
        port = vars(get_args(ref_flags))
        assert port.pop("device") == "cuda"
        assert port == vars(ref)


def test_port_parser_defaults_equal_jax():
    """Every flag the two parsers share has one default (``--data-type``
    is tartanair on both); the port adds only ``--device``."""
    port, ref = vars(get_args([])), vars(jax_get_args([]))
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert port["data_type"] == "tartanair"


@pytest.mark.parametrize("flags", [["--bf16"], ["--scan-chunk", "4"],
                                   ["--profile-dir", "trace"]])
def test_port_parser_takes_the_jax_only_flags(flags):
    """``--bf16``, ``--scan-chunk`` and ``--profile-dir`` parse to JAX's
    values (they were refused before they were ported)."""
    port, ref = vars(get_args(flags)), vars(jax_get_args(flags))
    assert port.pop("device") == "cuda"
    assert port == ref
    name = flags[0][2:].replace("-", "_")
    assert port[name] == {"bf16": True, "scan_chunk": 4,
                          "profile_dir": "trace"}[name]
