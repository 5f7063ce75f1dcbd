"""The TartanVO class and precomputed flow and depth against the JAX
package at 64x128, B=2.

A TartanAir fixture folder with flow and depth ``.npy`` files
(``fixtures.write_tartanair(flow=True, depth=True)``) is read by both
packages' ``TrajFolderDataset(load_flow=True, load_depth=True)``; two
collated pairs go through JAX's ``TartanVO.__call__`` and the port's with a
given scale, with the precomputed flow (and the stereo net's running
stats), and with the ground-truth scale; then ``pred_flow`` and
``join_flow``.  VONet's parameters: JAX's tree, filled from a seed and
carried by ``state_dict_from_jax`` (``tests/test_torch_variants.py``).

Tolerances: the dataset's arrays exact without transforms and 1e-6 after
them; motions, scales and flows at the network tolerance of
tests/test_torch_models.py (rtol 1e-3, atol 1e-4 of the output's scale).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.data import dataset as jdataset
from islam_tpu.data import transforms as jtransforms
from islam_tpu.models import tartanvo as jtvo
from islam_tpu.models.vonet import VONet as JVONet
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.data import dataset as tdataset
from islam_tpu_torch.data import fixtures
from islam_tpu_torch.models import tartanvo as ttvo
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_variants import _close, jax_variables

torch.set_num_threads(1)

H, W, B = 64, 128, 2
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return fixtures.write_tartanair(str(tmp_path_factory.mktemp("ta")), n=5,
                                    h=H, w=W, seed=3, flow=True, depth=True)


def _jax_transform():
    return jtransforms.Compose([
        jtransforms.CropCenter((H, W), fix_ratio=True),
        jtransforms.DownscaleFlow(),
        jtransforms.Normalize(mean=MEAN, std=STD, keep_old=True),
        jtransforms.ToNHWCTensor()])


def test_fixture_flow_and_depth_files(tmp_path):
    """The defaults write no flow or depth; with them set, the other files
    are byte for byte the same, and the flow and depth files carry the
    names and shapes TartanAir's do."""
    plain = fixtures.write_tartanair(str(tmp_path / "a"), n=4)
    full = fixtures.write_tartanair(str(tmp_path / "b"), n=4, flow=True,
                                    depth=True)
    assert sorted(os.listdir(plain)) == ["image_left", "image_right", "imu",
                                         "pose_left.txt"]
    assert sorted(os.listdir(f"{full}/flow")) == [
        f"{i:06d}_{i + 1:06d}_flow.npy" for i in range(3)]
    assert sorted(os.listdir(f"{full}/depth_left")) == [
        f"{i:06d}_left_depth.npy" for i in range(4)]
    for sub in ("image_left", "image_right", "imu"):
        for name in os.listdir(f"{plain}/{sub}"):
            with open(f"{plain}/{sub}/{name}", "rb") as a, open(
                    f"{full}/{sub}/{name}", "rb") as b:
                assert a.read() == b.read(), name
    f = np.load(f"{full}/flow/000001_000002_flow.npy")
    d = np.load(f"{full}/depth_left/000003_left_depth.npy")
    assert f.shape == (60, 120, 2) and f.dtype == np.float32
    assert d.shape == (60, 120) and d.dtype == np.float32
    assert abs(float(f[..., 0].mean()) + 2.0) < 0.01


@pytest.mark.parametrize("preset", [False, True], ids=["raw", "preset"])
def test_dataset_flow_and_depth_match_jax(folder, preset):
    """'flow' from flowfiles[min(i, j)], 'depth0' from depthfiles[i]; the
    preset transforms crop and downscale both (the link (3, 2) reads the
    flow of (2, 3))."""
    links = [[0, 1], [3, 2]]
    kw = dict(links=links, load_flow=True, load_depth=True)
    ref = jdataset.TrajFolderDataset(
        folder, "tartanair", transform=_jax_transform() if preset else None,
        **kw)
    out = tdataset.TrajFolderDataset(
        folder, "tartanair",
        transform=ttrain.make_transform(H, W) if preset else None, **kw)
    for idx, (i, j) in enumerate(links):
        r, o = ref[idx], out[idx]
        rf, of = (np.asarray(x["flow"]) for x in (r, o))
        rd, od = (np.asarray(x["depth0"]) for x in (r, o))
        if preset:
            assert of.shape == (H // 4, W // 4, 2)
            assert od.shape == (H // 4, W // 4, 1)
            np.testing.assert_allclose(of, rf, atol=1e-6)
            np.testing.assert_allclose(od, rd, atol=1e-6)
        else:
            np.testing.assert_array_equal(of[0], np.load(
                out.flowfiles[min(i, j)]))
            np.testing.assert_array_equal(od[0], np.load(out.depthfiles[i]))
            np.testing.assert_array_equal(of, rf)
            np.testing.assert_array_equal(od, rd)
    plain = tdataset.TrajFolderDataset(folder, "tartanair")[0]
    assert "flow" not in plain and "depth0" not in plain


@pytest.fixture(scope="module")
def vo(folder):
    """(JAX TartanVO, the port's on the CPU, a collated B=2 sample with the
    precomputed flow)."""
    imgs = [np.zeros((1, H, W, 3), np.float32)] * 4 + [
        np.zeros((1, H // 4, W // 4, 2), np.float32)]
    v = jax_variables(JVONet(), *imgs, seed=4)
    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(jax.device_get(v)))
    ds = tdataset.TrajFolderDataset(folder, "tartanair",
                                    transform=ttrain.make_transform(H, W),
                                    load_flow=True)
    sample = tdataset.collate([ds[0], ds[1]])
    return (jtvo.TartanVO(variables=v, correct_scale=False),
            ttvo.TartanVO(model, correct_scale=False, device="cpu"), sample)


def _jax_sample(sample):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in sample.items()}


def test_call_with_a_given_scale(vo):
    jvo, tvo, sample = vo
    sample = {k: v for k, v in sample.items() if k != "flow"}
    scale = np.float32([0.5, 2.0])
    ref = jvo(_jax_sample(sample), given_scale=jnp.asarray(scale))
    with torch.no_grad():
        out = tvo(sample, given_scale=scale)
    assert set(out) == {"motion"}
    _close(out["motion"], ref["motion"])
    np.testing.assert_allclose(np.linalg.norm(out["motion"][:, :3], axis=1),
                               scale, rtol=1e-5)


def test_call_with_the_precomputed_flow(vo):
    """The scale from the disparity (running stats: ``is_train=False``)
    and the folder's flow, not the network's."""
    jvo, tvo, sample = vo
    ref = jvo(_jax_sample(sample), is_train=False)
    with torch.no_grad():
        out = tvo(sample, is_train=False)
    flow = np.moveaxis(np.asarray(ref["flow"]), -1, 1)
    np.testing.assert_array_equal(out["flow"].numpy(), flow)
    np.testing.assert_array_equal(
        out["flow"].numpy(), np.moveaxis(sample["flow"], -1, 1))
    for k in ("motion", "scale", "disp", "depth"):
        _close(out[k], np.moveaxis(np.asarray(ref[k]), -1, 1)
               if k == "disp" else ref[k])
    for k in ("mask", "depth_mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_call_with_the_ground_truth_scale(vo):
    jvo, tvo, sample = vo
    jvo.correct_scale = tvo.correct_scale = True
    try:
        ref = jvo(_jax_sample(sample))
        with torch.no_grad():
            out = tvo(sample)
    finally:
        jvo.correct_scale = tvo.correct_scale = False
    _close(out["motion"], ref["motion"])
    np.testing.assert_allclose(
        np.linalg.norm(out["motion"][:, :3], axis=1),
        np.linalg.norm(sample["motion"][:, :3], axis=1), rtol=1e-5)


def test_pred_flow_and_join_flow(vo):
    """``pred_flow`` batched and for one pair; ``join_flow`` of the two
    pairs' flows."""
    jvo, tvo, sample = vo
    img0, img1 = sample["img0"], sample["img1"]
    ref = np.asarray(jax.jit(jvo.pred_flow)(jnp.asarray(img0),
                                            jnp.asarray(img1)))
    out = tvo.pred_flow(img0, img1)
    assert out.shape == (B, H // 4, W // 4, 2)
    _close(out, ref)
    one = tvo.pred_flow(img0[1], img1[1])
    np.testing.assert_allclose(one.numpy(), out[1].numpy(), rtol=1e-5,
                               atol=1e-5 * float(out.abs().max()))
    flows = [np.moveaxis(ref[k], -1, 0) for k in range(B)]
    jref = np.asarray(jvo.join_flow([jnp.asarray(f) for f in flows]))
    np.testing.assert_allclose(tvo.join_flow(flows).numpy(), jref,
                               rtol=1e-5, atol=1e-5)


def test_constructor_builds_the_seeded_model():
    """(height, width, seed) build ``init_model``'s VONet on the device."""
    from islam_tpu_torch.models.voflownet import flat_features

    a = ttvo.TartanVO(height=H, width=W, seed=5, device="cpu")
    assert isinstance(a.model, VONet) and a.correct_scale
    assert a.model.flowPoseNet.voflow_rot[0][0].in_features == (
        flat_features(H // 4, W // 4))
    assert all(p.device.type == "cpu" for p in a.model.parameters())


@pytest.mark.parametrize("parts", [(), ("flow", "stereo"), ["flow"]],
                         ids=str)
def test_fix_parts_is_kept_as_jax_keeps_it(parts):
    """``fix_parts`` is stored as a tuple and read nowhere, as in the JAX
    class (freezing is the trainer's --fix-model-parts); the default is ()."""
    kw = {"fix_parts": parts} if parts else {}
    ref = jtvo.TartanVO(variables={}, correct_scale=False, **kw)
    out = ttvo.TartanVO(torch.nn.Identity(), correct_scale=False,
                        device="cpu", **kw)
    assert out.fix_parts == ref.fix_parts == tuple(parts)
    assert not out.correct_scale and out.use_kitti_coord
