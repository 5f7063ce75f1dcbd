"""Checkpoints: the lenient ``.pkl`` loader against the JAX package's
``import_torch_weights``, and the port's per-epoch saves and resume.

One JAX parameter set (``tvo.init_params`` at 64x128) is drawn; the
``.pkl`` files hold scaled copies of it, so a loaded entry is told from an
unloaded one.  The set of entries each loader fills is read from a
NaN-filled target: whatever is still NaN was not loaded.  The VONet
forward after loading is compared at the tolerance of
``tests/test_torch_models.py`` (rtol 1e-3, atol 1e-4 of the output's
scale: float32 convolution stacks summed in other orders).  Saves are
restored bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.models import tartanvo as jtvo
from islam_tpu.models.vonet import VONet as JVONet
from islam_tpu.utils import checkpoints as jckpt
from islam_tpu_torch import optim
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.utils import checkpoints as ckpt
from islam_tpu_torch.utils.weights import (flax_path_to_torch_key,
                                           state_dict_from_jax)

torch.set_num_threads(1)

H, W, B = 64, 128, 2


@pytest.fixture(scope="module")
def variables():
    return jax.device_get(jtvo.init_params(jax.random.PRNGKey(0), H, W))


def _scaled(variables, factor):
    return jax.tree_util.tree_map(lambda x: np.asarray(x) * factor + 0.01,
                                  variables)


def _pkls(variables):
    """{case: state dict} of the cases the reference's loader meets."""
    full = state_dict_from_jax(_scaled(variables, 1.5))
    pose = {k: v for k, v in state_dict_from_jax(
        _scaled(variables, -0.5)).items() if k.startswith("flowPoseNet.")}
    flow = {k: v for k, v in full.items() if k.startswith("flowNet.")}
    pred = {k.replace(".weight", ".pred.weight").replace(".bias",
                                                         ".pred.bias")
            if (".predict_flow" in k or ".dc_conv7." in k) else k: v
            for k, v in flow.items()}
    return {
        "full": full,
        "flow_only": flow,
        "pose_unprefixed": {k[len("flowPoseNet."):]: v
                            for k, v in pose.items()},
        "pose_module_prefix": {"module." + k: v for k, v in pose.items()},
        "pred_alias": pred,
    }


def _jax_loaded(variables, sd):
    nan = jax.tree_util.tree_map(
        lambda x: np.full(np.shape(x), np.nan, np.float32), variables)
    out = jckpt.import_torch_weights(nan, {k: v.numpy()
                                           for k, v in sd.items()})
    flat = jax.tree_util.tree_flatten_with_path(out)[0]
    keys = set()
    for path, leaf in flat:
        parts = tuple(p.key for p in path)
        if not np.isnan(np.asarray(leaf)).any():
            keys.add(flax_path_to_torch_key(parts))
    return out, keys


def _port_loaded(sd):
    model = VONet(H, W)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.fill_(float("nan"))
    loaded = ckpt.import_torch_weights(model, sd)
    still_nan = {k for k, t in model.state_dict().items()
                 if torch.isnan(t).any()}
    assert still_nan == set(model.state_dict()) - set(loaded)
    return model, set(loaded)


@pytest.mark.parametrize("case", ["full", "flow_only", "pose_unprefixed",
                                  "pose_module_prefix", "pred_alias"])
def test_lenient_loader_loads_what_jax_loads(variables, case):
    sd = _pkls(variables)[case]
    _, jkeys = _jax_loaded(variables, sd)
    model, tkeys = _port_loaded(sd)
    assert tkeys == jkeys
    assert tkeys
    if case == "full":
        assert tkeys == set(model.state_dict())
    for k in tkeys:   # the values are the pkl's, bitwise
        src = ckpt._source(k, model.state_dict()[k].numel(), sd)
        assert torch.equal(model.state_dict()[k], src.reshape(
            model.state_dict()[k].shape)), k


def test_lenient_loader_raises_when_nothing_matches(variables):
    sd = {"foo.weight": torch.ones(3)}
    with pytest.raises(RuntimeError, match="Could not match"):
        jckpt.import_torch_weights(variables, {"foo.weight": np.ones(3)})
    with pytest.raises(RuntimeError, match="Could not match"):
        ckpt.import_torch_weights(VONet(H, W), sd)


def _close(port, ref):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max() + 1e-7)


def test_forward_after_loading_matches_jax(variables, tmp_path):
    """``--vo-model-name`` then ``--pose-model-name`` (unprefixed keys) on
    both sides, through the ``.pkl`` files, then one VONet forward."""
    pkls = _pkls(variables)
    paths = {}
    for case in ("full", "pose_unprefixed"):
        paths[case] = str(tmp_path / f"{case}.pkl")
        torch.save(pkls[case], paths[case])
    jvars = variables
    for case in ("full", "pose_unprefixed"):
        jvars = jckpt.import_torch_weights(
            jvars, jckpt.load_torch_state_dict(paths[case]))
    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    for case in ("full", "pose_unprefixed"):
        ckpt.import_torch_weights(model, ckpt.load_torch_state_dict(
            paths[case]))
    # the pose head is the pose-only file's, the rest the full file's
    sd = model.state_dict()
    for k, v in pkls["pose_unprefixed"].items():
        assert torch.equal(sd["flowPoseNet." + k], v)
    assert torch.equal(sd["flowNet.conv1a.0.weight"],
                       pkls["full"]["flowNet.conv1a.0.weight"])

    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
            for _ in range(4)]
    intr = rng.normal(size=(B, H // 4, W // 4, 2)).astype(np.float32)
    apply = jax.jit(lambda v, *a: JVONet().apply(v, *a,
                                                 mutable=["batch_stats"]))
    (flow, disp, pose), _ = apply(jvars, *(jnp.asarray(a)
                                           for a in (*imgs, intr)))

    def nchw(x):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))

    with torch.no_grad():
        f, d, p = model(*(nchw(a) for a in (*imgs, intr)))
    _close(f, np.moveaxis(np.asarray(flow), -1, 1))
    _close(d, np.moveaxis(np.asarray(disp), -1, 1))
    _close(p, pose)


# ---- saves and resume ----

def _main(tmp_path, *flags, denoiser=True):
    from islam_tpu_torch.imu.denoiser import init_denoiser

    pkl = tmp_path / "denoiser.pkl"
    if denoiser and not pkl.exists():
        torch.save(init_denoiser(1, "cpu").state_dict(), str(pkl))
    return ttrain.main([
        "--data-type", "synthetic", "--image-height", str(H),
        "--image-width", str(W), "--batch-size", str(B),
        "--synthetic-frames", str(2 * B + 1), "--device", "cpu",
        "--print-interval", "0", "--save-model-dir", str(tmp_path / "models"),
        *(["--imu-denoise-model-name", str(pkl)] if denoiser else []),
        *flags])


def _assert_equal_states(a, b, what=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_equal_states(a[k], b[k], f"{what}/{k}")
    else:
        assert a == b, what


def test_save_then_resume_restores_bitwise(tmp_path):
    """Epochs 1 ('vo', Adam) and 2 ('imu') saved; ``--start-epoch 3``
    restores epoch 2's parameters and both optimizer states bitwise."""
    trained = _main(tmp_path, "--train-epoch", "2")
    assert sorted(os.listdir(tmp_path / "models")) == ["1", "2"]
    assert trained.vo_opt_state["count"] == 1
    assert trained.imu_opt_state["count"] == 1
    resumed = _main(tmp_path, "--start-epoch", "3", "--train-epoch", "2")
    _assert_equal_states(resumed.checkpoint_state(),
                         trained.checkpoint_state())
    os.makedirs(tmp_path / "other")
    fresh = _main(tmp_path / "other", "--train-epoch", "0")
    assert not torch.equal(fresh.model.state_dict()[
        "flowPoseNet.voflow_rot.2.weight"], trained.model.state_dict()[
        "flowPoseNet.voflow_rot.2.weight"])


@pytest.fixture(scope="module")
def vo_pkls(tmp_path_factory):
    """A full VONet .pkl (the port's seed-3 model) and a pose-only one
    (its pose head x 2, keys without the ``flowPoseNet.`` prefix)."""
    from islam_tpu_torch.models import tartanvo as ttvo

    tmp = tmp_path_factory.mktemp("pkls")
    vo = ttvo.init_model(H, W, seed=3, device="cpu").state_dict()
    pose = {k[len("flowPoseNet."):]: v * 2 for k, v in vo.items()
            if k.startswith("flowPoseNet.")}
    torch.save(vo, str(tmp / "vo.pkl"))
    torch.save(pose, str(tmp / "pose.pkl"))
    return vo, str(tmp / "vo.pkl"), str(tmp / "pose.pkl")


@pytest.mark.parametrize("kind", ["kitti", "euroc", "tartanair"])
def test_main_saves_and_resumes_on_each_folder_type(tmp_path, kind,
                                                    vo_pkls):
    """The presets' checkpoint flags on a sequence folder of each type
    (one window of B=2): ``--vo-model-name`` and ``--pose-model-name``
    load, the 'vo' epoch 1 is saved, and ``--start-epoch 2`` resumes from
    it (``--train-epoch 1``: no epoch runs after the resume; the epoch
    after one is ``test_save_then_resume_restores_bitwise``'s)."""
    from islam_tpu_torch.data import fixtures

    vo, vo_pkl, pose_pkl = vo_pkls
    kw = {"h": 60, "w": 120} if kind == "kitti" else {}
    root = fixtures.WRITERS[kind](str(tmp_path / "seq"), 4, **kw)
    flags = ["--data-type", kind, "--data-root", root,
             "--vo-model-name", vo_pkl, "--pose-model-name", pose_pkl,
             "--fix-model-parts", "flow", "stereo", "--worker-num", "2",
             "--result-dir", str(tmp_path / "res")]
    first = _main(tmp_path, "--train-epoch", "1", *flags)
    sd = first.model.state_dict()
    assert torch.equal(sd["flowNet.conv1a.0.weight"],
                       vo["flowNet.conv1a.0.weight"])
    assert len(first.window_seconds[1]) == 1
    assert sorted(os.listdir(tmp_path / "models")) == ["1"]
    rows = np.loadtxt(str(tmp_path / "res" / "1" / "pgo_pose.txt"))
    assert rows.shape == (3, 7) and np.isfinite(rows).all()
    second = _main(tmp_path, "--start-epoch", "2", "--train-epoch", "1",
                   *flags)
    # the resume restored epoch 1's save over the freshly loaded .pkls
    _assert_equal_states(second.checkpoint_state(), first.checkpoint_state())


def test_latest_checkpoint_is_the_newest_before_start(tmp_path):
    for k in (1, 2, 4):
        ckpt.save_checkpoint(str(tmp_path), k, {"k": k})
    os.makedirs(tmp_path / "3")   # no checkpoint inside: skipped
    assert ckpt.latest_checkpoint_step(str(tmp_path), 5) == 4
    assert ckpt.latest_checkpoint_step(str(tmp_path), 4) == 2
    assert ckpt.latest_checkpoint_step(str(tmp_path), 2) == 1
    assert ckpt.latest_checkpoint_step(str(tmp_path), 1) is None
    assert ckpt.restore_checkpoint(str(tmp_path), 2) == {"k": 2}
    assert ckpt.latest_checkpoint_step(str(tmp_path / "none"), 9) is None


def test_resume_without_a_save_starts_fresh(tmp_path):
    trainer = _main(tmp_path, "--start-epoch", "3", "--train-epoch", "2")
    assert trainer.resume(str(tmp_path / "models"), 3) is None


def test_resume_needs_the_denoiser_the_save_holds(tmp_path):
    """A save that holds a denoiser, resumed into a trainer built without
    one (no --imu-denoise-model-name), builds the denoiser and its Adam and
    restores both bitwise, as the JAX package does (islam_tpu/train.py:
    677-698, tests/test_misc.py::
    test_resume_restores_denoiser_into_trainer_without_one); the next 'imu'
    epoch then updates the denoiser."""
    saved = _main(tmp_path, "--train-epoch", "0", "--imu-lr", "1e-3")
    gen = torch.Generator().manual_seed(0)
    grads = {k: torch.randn(p.shape, generator=gen)
             for k, p in saved.imu_params.items()}
    updates, saved.imu_opt_state = saved.imu_opt.update(
        grads, saved.imu_opt_state)
    optim.apply_updates(saved.imu_params, updates)
    saved.save_models(str(tmp_path / "models"), 1)

    trainer = _main(tmp_path, "--train-epoch", "0", "--imu-lr", "1e-3",
                    denoiser=False)
    assert trainer.denoiser is None
    assert trainer.resume(str(tmp_path / "models"), 2) == 1
    _assert_equal_states(trainer.checkpoint_state(), saved.checkpoint_state())
    assert trainer.imu_opt_state["count"] == 1
    before = {k: p.detach().clone() for k, p in trainer.imu_params.items()}
    assert trainer.train_target[2] == "imu"
    trainer.run_epoch(2)
    assert trainer.imu_opt_state["count"] == 2
    assert sorted(trainer.last_grads) == sorted(before)
    assert all(not torch.equal(p, before[k])
               for k, p in trainer.imu_params.items())


@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_optimizer_state_round_trip(name):
    params = {"w": torch.randn(3, 2), "b": torch.randn(2)}
    opt = optim.OPTIMIZERS[name](1e-3)
    _, state = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                          opt.init(params))
    saved = optim.state_dict(state)
    restored = optim.load_state_dict(saved, "cpu")
    _assert_equal_states(restored, state)
    if state:
        first = next(iter(state["nu"].values()))
        assert optim.state_dict(state)["nu"]["w"] is not first
