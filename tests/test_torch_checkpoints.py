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
import shutil

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
from tests.test_torch_slice import shared_jax_init  # noqa: F401

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


# ---- a JAX run's saves resumed on the port (utils/jax_state.py) ----
#
# The JAX side saves with orbax (``Trainer.save_models``) and exports with
# the README's lines (``_export``); ``jax_state`` writes the port's save;
# the port's ``resume`` reads it.  One JAX trainer serves the file, with
# the demo's settings (Adam at 1e-4, the ground-truth scale; the program of
# tests/test_torch_demo_imperative.py's 'vo' epoch); its optimizer state is
# one Adam step of seeded gradients, made in numpy, so that every moment is
# nonzero.  The epoch after the resume is compared at
# tests/test_torch_train.py's tolerances (poses 1e-4, PVGO velocities
# 2e-3, the epoch's gradient 1e-3 x max|g|, the Adam-updated pose head
# 2 x lr).  The denoiser's and the other optax states' mappings are
# checked on saves made without training.  A VONet save at 64x128 is 185
# MB (the pose head 59 MB of it), so each test deletes its saves once read,
# and the optax states are those of a part of the pose head.

RT_LR = 1e-4
RT_FLAGS = ["--data-type", "synthetic", "--image-height", str(H),
            "--image-width", str(W), "--batch-size", str(B),
            "--synthetic-frames", str(2 * B + 1), "--print-interval", "0",
            "--vo-optimizer", "adam", "--lr", str(RT_LR),
            "--loss-weight", "(1,0.1,10,0.1)", "--rot-w", "1",
            "--trans-w", "0.1", "--use-gt-scale", "--bilevel", "detached"]


def _export(directory, step, out):
    """The README's export lines, on a host with JAX."""
    from flax import serialization, traverse_util

    state = jax.device_get(jckpt.restore_checkpoint(directory, step))
    flat = traverse_util.flatten_dict(serialization.to_state_dict(state),
                                      sep="/")
    np.savez(out, **{k: np.zeros(0) if v is None else np.asarray(v)
                     for k, v in flat.items()})
    return out


def _seeded(state, seed):
    """An optax state with each array leaf drawn from a seed (counts 1,
    second moments positive), in numpy; masked leaves stay masked."""
    rng = np.random.default_rng(seed)

    def fill(x):
        if np.ndim(x) == 0:
            return np.ones((), np.asarray(x).dtype)
        return np.abs(rng.normal(size=np.shape(x))).astype(np.float32)

    return jax.tree_util.tree_map(fill, state)


def _pose_sd(tree):
    return state_dict_from_jax({"params": {"flowPoseNet": tree}})


def _remove_saves(tmp_path):
    for p in tmp_path.iterdir():
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()


def _port_trainer(flags):
    from islam_tpu_torch.arguments import get_args
    from islam_tpu_torch.data.synthetic import SyntheticTrajDataset

    tds = SyntheticTrajDataset(num_frames=2 * B + 1, height=H, width=W,
                               transform=ttrain.make_transform(H, W))
    return ttrain.Trainer(get_args(flags + ["--device", "cpu"]), tds,
                          device="cpu")


@pytest.fixture(scope="module")
def jax_trainer():
    from islam_tpu import testing as jtesting
    from islam_tpu.arguments import get_args as jax_get_args
    from islam_tpu.train import Trainer as JaxTrainer

    return JaxTrainer(jax_get_args(RT_FLAGS), jtesting.make_dataset(
        num_frames=2 * B + 1, height=H, width=W))


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory, jax_trainer):
    import optax

    from islam_tpu_torch.utils import jax_state

    tmp = tmp_path_factory.mktemp("jax_saves")
    # ---- JAX: epoch 2's save, then its own resume and epoch 3 ----
    jtr = jax_trainer
    jtr.vo_opt_state = _seeded(jtr.vo_opt_state, 1)
    jtr.save_models(str(tmp / "jax"), 2)
    saved = jax.device_get(jtr._ckpt_state())
    log, opt = [], jtr.vo_opt

    def update(grads, state, params=None):
        log.append(jax.device_get(grads))
        return opt.update(grads, state, params)

    jtr.vo_opt = optax.GradientTransformation(opt.init, update)
    jtr.vo_opt_state = opt.init(jtr.vo_variables["params"]["flowPoseNet"])
    assert jtr.resume(str(tmp / "jax"), 3) == 2
    jtraj = jtr.run_epoch(3)
    jtr.vo_opt = opt
    jpose = _pose_sd(jax.device_get(
        jtr.vo_variables["params"]["flowPoseNet"]))

    # ---- the port: export, convert, resume, epoch 3 ----
    npz = _export(str(tmp / "jax"), 2, str(tmp / "state.npz"))
    jax_state.main([npz, str(tmp / "port"), "2"])
    ttr = _port_trainer(RT_FLAGS)
    assert ttr.resume(str(tmp / "port"), 3) == 2
    resumed = optim.state_dict(ttr.checkpoint_state())
    ttraj = ttr.run_epoch(3)
    shutil.rmtree(tmp)
    return {"saved": saved, "resumed": resumed, "jtraj": jtraj,
            "ttraj": ttraj, "jgrads": log, "tgrads": ttr.last_grads,
            "jpose": jpose, "ttr": ttr}


def test_jax_save_resumes_with_its_parameters_and_moments(round_trip):
    """What the port restored is JAX's save: the VONet bitwise (its
    layouts moved), the Adam state with its count, and the moments laid
    out and keyed as the port's pose-head parameters."""
    saved, resumed = round_trip["saved"], round_trip["resumed"]
    _assert_equal_states(resumed["model"],
                         dict(state_dict_from_jax(saved["vo_variables"])))
    adam = saved["vo_opt_state"][0]
    assert resumed["vo_opt_state"]["count"] == int(adam.count) == 1
    params = ttrain.pose_params(round_trip["ttr"].model)
    for m in ("mu", "nu"):
        want = _pose_sd(getattr(adam, m))
        _assert_equal_states(resumed["vo_opt_state"][m], dict(want), m)
        assert {k: v.shape for k, v in resumed["vo_opt_state"][m].items()} \
            == {k: p.shape for k, p in params.items()}


def test_epoch_after_the_jax_resume_matches_jax(round_trip):
    """Epoch 3 ('vo', Adam's second step on the restored moments) after the
    port's resume against JAX's after its own."""
    t, j = round_trip["ttraj"], round_trip["jtraj"]
    for name, atol in (("vo_poses", 1e-4), ("pgo_poses", 1e-4),
                       ("imu_poses", 1e-4), ("pgo_vels", 2e-3)):
        a, b = np.stack(getattr(t, name)), np.stack(getattr(j, name))
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
    (jg,) = round_trip["jgrads"]
    ref = _pose_sd(jg)
    gmax = max(float(v.abs().max()) for v in ref.values())
    assert gmax > 0
    for k, r in ref.items():
        np.testing.assert_allclose(round_trip["tgrads"][k].numpy(),
                                   r.numpy(), atol=1e-3 * gmax, err_msg=k)
    ttr = round_trip["ttr"]
    assert ttr.vo_opt_state["count"] == 2
    for k, r in round_trip["jpose"].items():
        np.testing.assert_allclose(ttr.vo_params[k].detach().numpy(),
                                   r.numpy(), atol=2 * RT_LR, err_msg=k)


def test_params_only_jax_save_resumes_with_fresh_optimizer(
        tmp_path, capsys, variables, jax_trainer, round_trip):
    """A JAX params-only save (``checkpoint_top_keys`` finds no optimizer
    state) resumes on the port with the trainer's fresh Adam state, and
    prints the note JAX's resume prints for the same save."""
    from islam_tpu_torch.utils import jax_state

    jckpt.save_checkpoint(str(tmp_path / "jax"), 1,
                          {"vo_variables": variables})
    capsys.readouterr()
    assert jax_trainer.resume(str(tmp_path / "jax"), 2) == 1
    jnote = capsys.readouterr().out.splitlines()[0]

    jax_state.convert(_export(str(tmp_path / "jax"), 1,
                              str(tmp_path / "p.npz")),
                      str(tmp_path / "port"), 1)
    ttr = _port_trainer(RT_FLAGS)
    fresh = optim.state_dict(ttr.vo_opt_state)
    assert ttr.resume(str(tmp_path / "port"), 2) == 1
    _remove_saves(tmp_path)
    note = capsys.readouterr().out.splitlines()[0]
    assert "has no ['vo_opt_state']" in note
    assert note.replace(str(tmp_path / "port"), "D") == jnote.replace(
        os.path.abspath(str(tmp_path / "jax")), "D")
    _assert_equal_states(ttr.vo_opt_state, fresh)
    assert ttr.vo_opt_state["count"] == 0
    _assert_equal_states(dict(ttr.model.state_dict()),
                         dict(state_dict_from_jax(variables)))


def _drop_masked(tree):
    """A pytree without optax.MaskedNode leaves and the dicts left empty."""
    import optax

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _drop_masked(v)
            if v:
                out[k] = v
        elif not isinstance(v, optax.MaskedNode):
            out[k] = v
    return out


@pytest.mark.parametrize("name,fix", [("adam", ()), ("rmsprop", ()),
                                      ("sgd", ()), ("adam", ("feat",)),
                                      ("rmsprop", ("rot", "trans"))])
def test_optax_states_map_to_the_ports(tmp_path, variables, name, fix):
    """Each optax state of the pose head (``optax.masked`` for
    --fix-model-parts, as JAX's Trainer builds it) -> the port's optimizer
    state of the same flags: the same fields, the moments keyed as the
    port's trainable parameters (the masked leaves left out) with their
    shapes, and JAX's values."""
    import optax

    from islam_tpu_torch.utils import jax_state

    # feat_net's first convolutions and both heads: conv, dense and bias
    # leaves under each --fix-model-parts prefix
    full = variables["params"]["flowPoseNet"]
    pose = {k: v for k, v in full.items() if k != "feat_net"}
    pose["feat_net"] = {k: full["feat_net"][k]
                        for k in ("head0", "layer0_block0")}
    base = {"adam": optax.adam, "rmsprop": optax.rmsprop,
            "sgd": optax.sgd}[name](1e-3)
    prefixes = [{"feat": "feat_net", "rot": "rot_", "trans": "trans_"}[p]
                for p in fix]
    mask = {k: jax.tree_util.tree_map(
        lambda _, k=k: not any(k.startswith(p) for p in prefixes), v)
        for k, v in pose.items()}
    opt = optax.masked(base, mask) if fix else base
    state = _seeded(opt.init(pose), 3)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, {
        "vo_variables": {"params": {"flowPoseNet": pose}},
        "vo_opt_state": state})
    with np.load(_export(str(tmp_path / "jax"), 1,
                         str(tmp_path / "s.npz"))) as flat:
        port = jax_state.trainer_state_from_jax(dict(flat))["vo_opt_state"]

    part = _pose_sd(pose)
    trainable = optim.trainable(
        ((k, p) for k, p in ttrain.pose_params(VONet(H, W)).items()
         if k in part), [ttrain.POSE_FIX[p] for p in fix])
    if fix:  # the mask leaves a part of the part out
        assert 0 < len(trainable) < len(part)
    want = optim.OPTIMIZERS[name](1e-3).init(trainable)
    assert set(port) == set(want)
    inner = state.inner_state if fix else state
    for field in ("mu", "nu"):
        if field in want:
            assert {k: v.shape for k, v in port[field].items()} == {
                k: v.shape for k, v in want[field].items()}
            ref = _pose_sd(_drop_masked(getattr(inner[0], field)))
            _assert_equal_states(port[field], dict(ref), field)
    if "count" in want:
        assert port["count"] == 1


def test_multi_sequence_jax_save_resumes_on_the_port(tmp_path, variables):
    """What JAX's ``MultiSequenceTrainer`` saves (``opt_state``,
    ``seq_states``, the denoiser and its Adam) -> the port's
    ``MultiSequenceTrainer``: parameters, both Adam states, the
    denoiser's moments keyed as its parameters, and each sequence's
    carry restored."""
    import optax
    import torch.distributed as dist

    from islam_tpu.imu import denoiser as jdn
    from islam_tpu_torch import testing
    from islam_tpu_torch.parallel import mesh as tmesh
    from islam_tpu_torch.parallel.trainer import MultiSequenceTrainer
    from islam_tpu_torch.utils import jax_state
    from islam_tpu_torch.utils.weights import denoiser_state_dict_from_jax

    pose = variables["params"]["flowPoseNet"]
    dn = jax.device_get(jdn.init_params(jax.random.PRNGKey(1)))
    opt_state = _seeded(optax.adam(3e-6).init(pose), 4)
    imu_state = _seeded(optax.adam(3e-5).init(dn), 5)
    rng = np.random.default_rng(6)
    seqs = [{k: rng.normal(size=n).astype(np.float32)
             for k, n in (("pos", 3), ("rot", 4), ("vel", 3))}
            for _ in range(2)]
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, {
        "vo_variables": variables, "opt_state": opt_state,
        "seq_states": seqs, "dn_params": dn, "imu_opt_state": imu_state})
    jax_state.convert(_export(str(tmp_path / "jax"), 2,
                              str(tmp_path / "m.npz")),
                      str(tmp_path / "port"), 2)
    shutil.rmtree(tmp_path / "jax")
    os.remove(tmp_path / "m.npz")

    tmesh.initialize_distributed(f"localhost:{tmesh.free_port()}", 1, 0,
                                 device="cpu", timeout=120)
    try:
        tr = MultiSequenceTrainer(
            testing.make_sequences(range(2), 2 * B + 1, H, W), batch_size=B,
            mesh=tmesh.make_mesh(device="cpu"), device="cpu")
        assert tr.denoiser is None
        assert tr.resume(str(tmp_path / "port"), 3) == 2
        state = optim.state_dict(tr.checkpoint_state())
    finally:
        dist.destroy_process_group()
        _remove_saves(tmp_path)
    _assert_equal_states(state["model"], dict(state_dict_from_jax(variables)))
    dn_sd = denoiser_state_dict_from_jax(dn)
    _assert_equal_states(state["denoiser"], dict(dn_sd))
    assert state["vo_opt_state"]["count"] == 1
    assert state["imu_opt_state"]["count"] == 1
    for m in ("mu", "nu"):
        _assert_equal_states(state["vo_opt_state"][m],
                             dict(_pose_sd(getattr(opt_state[0], m))), m)
        moments = state["imu_opt_state"][m]
        assert {k: v.shape for k, v in moments.items()} == {
            k: v.shape for k, v in dn_sd.items()}
        assert torch.equal(moments["pose_decoder.0.weight"], torch.from_numpy(
            np.array(getattr(imu_state[0], m)["decoder"]["0"]["weight"])))
    for got, want in zip(state["seq_states"], seqs):
        for k in ("pos", "rot", "vel"):
            assert torch.equal(got[k], torch.from_numpy(want[k])), k
