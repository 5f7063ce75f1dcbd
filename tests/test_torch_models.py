"""Port networks vs the JAX networks at 64x128, same weights.

The JAX VONet is initialised once (``tvo.init_params``), carried into the
port with ``state_dict_from_jax``, and each network runs on the same
numpy-made inputs in both.  Tolerances: both sides are float32 convolution
stacks that sum in different orders (XLA:CPU vs oneDNN), so outputs agree to
~1e-5 relative per layer; over the 30-odd layers of each net with random
weights that grows to ~1e-4, hence rtol 1e-3 with an atol of 1e-4 of the
output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.models import tartanvo as jtvo
from islam_tpu.models.vonet import VONet as JVONet
from islam_tpu_torch.models.pwcnet import PWCDCNet
from islam_tpu_torch.models.stereonet import StereoNet7
from islam_tpu_torch.models.voflownet import VOFlowRes
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_slice import shared_jax_init  # noqa: F401

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

H, W, B = 64, 128, 2


@pytest.fixture(scope="module")
def weights():
    variables = jax.device_get(jtvo.init_params(jax.random.PRNGKey(0), H, W))
    model = VONet(H, W)
    model.load_state_dict(state_dict_from_jax(variables))
    return variables, model.eval()


def _images(seed, n=B, c=3, h=H, w=W):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, h, w, c)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _close(port, ref, scale=None):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-4 * scale + 1e-7)


def _apply_sub(variables, fn, *args):
    out, _ = JVONet().apply(variables, *args, method=fn,
                            mutable=["batch_stats"])
    return out


class TestNetworks:
    def test_pwcdcnet_pairs(self, weights):
        variables, model = weights
        x = np.concatenate([_images(1), _images(2)], axis=-1)
        ref = _apply_sub(variables, lambda m, x: m.flowNet(x)[0], x)
        with torch.no_grad():
            out = model.flowNet(_nchw(x))
        assert isinstance(model.flowNet, PWCDCNet)
        for o, r in zip(out, ref):
            _close(o, np.moveaxis(np.asarray(r), -1, 1))

    def test_pwcdcnet_shared_frames(self, weights):
        """B+1 frames, B pairs: the pyramid is shared between adjacent
        pairs, and the result equals the pairwise call."""
        variables, model = weights
        frames = _images(3, n=B + 1)
        ref = _apply_sub(
            variables, lambda m, x: m.flowNet(x, shared_frames=True)[0],
            frames)
        with torch.no_grad():
            out = model.flowNet(_nchw(frames), shared_frames=True)
            pairs = model.flowNet(_nchw(np.concatenate(
                [frames[:-1], frames[1:]], axis=-1)))
        assert out[0].shape == (B, 2, H // 4, W // 4)
        _close(out[0], np.moveaxis(np.asarray(ref[0]), -1, 1))
        np.testing.assert_allclose(out[0].numpy(), pairs[0].numpy(),
                                   rtol=1e-4, atol=1e-5)

    def test_stereonet7_quarter_output(self, weights):
        variables, model = weights
        x = np.concatenate([_images(4), _images(5)], axis=-1)
        ref = _apply_sub(variables, lambda m, x: m.stereoNet(x)[0], x)
        with torch.no_grad():
            out, _ = model.stereoNet(_nchw(x))
        assert isinstance(model.stereoNet, StereoNet7)
        assert out.shape == (B, 1, H // 4, W // 4)
        _close(out, np.moveaxis(np.asarray(ref), -1, 1))

    def test_stereonet7_batchnorm_leaves_running_stats(self, weights):
        """Train-mode BatchNorm normalises with batch statistics and, like
        the JAX forward, discards the running-stat update."""
        _, model = weights
        before = {k: v.clone() for k, v in model.stereoNet.state_dict().items()
                  if "running" in k}
        with torch.no_grad():
            model.stereoNet(_nchw(np.concatenate([_images(6), _images(7)],
                                                 axis=-1)))
        for k, v in model.stereoNet.state_dict().items():
            if "running" in k:
                assert torch.equal(v, before[k]), k

    def test_voflowres(self, weights):
        variables, model = weights
        x = np.random.default_rng(8).normal(
            size=(B, H // 4, W // 4, 4)).astype(np.float32)
        ref = _apply_sub(variables, lambda m, x: m.flowPoseNet(x), x)
        with torch.no_grad():
            out = model.flowPoseNet(_nchw(x))
        assert isinstance(model.flowPoseNet, VOFlowRes)
        _close(out, ref)

    def test_vonet(self, weights):
        variables, model = weights
        img0, img1, n0, n1 = (_images(s) for s in (9, 10, 11, 12))
        intr = np.random.default_rng(13).normal(
            size=(B, H // 4, W // 4, 2)).astype(np.float32)
        flow, disp, pose = _apply_sub(
            variables, lambda m, *a: m(*a),
            *(jnp.asarray(a) for a in (img0, img1, n0, n1, intr)))
        with torch.no_grad():
            f, d, p = model(*(_nchw(a) for a in (img0, img1, n0, n1, intr)))
        _close(f, np.moveaxis(np.asarray(flow), -1, 1))
        _close(d, np.moveaxis(np.asarray(disp), -1, 1))
        _close(p, pose)


@pytest.mark.parametrize("use_kitti_coord", [True, False],
                         ids=["kitti", "tartanair"])
def test_tartanvo_forward_with_gt_scale(weights, use_kitti_coord):
    """``--use-gt-scale``: the translation's scale is the ground-truth
    motion's norm (TartanVO.py:184-190), in KITTI's frame or TartanAir's.
    The motions are scaled unit vectors and rotations of the pose head:
    the tolerance of the networks above, on the motion's scale."""
    from islam_tpu_torch.models import tartanvo as ttvo

    variables, model = weights
    rng = np.random.default_rng(14)
    img0, img1, n0, n1 = (_images(s) for s in (15, 16, 17, 18))
    intr = rng.normal(size=(B, H // 4, W // 4, 2)).astype(np.float32)
    calib = np.tile(np.float32([60, 60, 64, 32]), (B, 1))
    baseline = np.full(B, 0.25, np.float32)
    gt = np.concatenate([rng.normal(size=(B, 3)), np.tile([0, 0, 0, 1.0],
                                                          (B, 1))], axis=1)
    gt = gt.astype(np.float32)
    ref = jtvo.forward(variables, *(jnp.asarray(a) for a in (
        img0, img1, n0, n1, intr, calib, baseline)),
        gt_motion=jnp.asarray(gt), datatype="kitti", correct_scale=True,
        use_kitti_coord=use_kitti_coord)
    with torch.no_grad():
        out = ttvo.forward(model, *(torch.from_numpy(a) for a in (
            img0, img1, n0, n1, intr, calib, baseline)),
            datatype="kitti", use_kitti_coord=use_kitti_coord,
            correct_scale=True, gt_motion=torch.from_numpy(gt))
    assert set(out) == {"motion"}
    motion = out["motion"].numpy()
    np.testing.assert_allclose(np.linalg.norm(motion[:, :3], axis=1),
                               np.linalg.norm(gt[:, :3], axis=1), rtol=1e-5)
    _close(motion, ref["motion"])
