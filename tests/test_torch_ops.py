"""Port warp, geometry and layer primitives vs the JAX package.

Same numpy inputs on both sides, float32.  Tolerances are stated per test;
they cover summation-order differences (a few ulp of each output's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.lie import SE3 as JSE3
from islam_tpu.models import layers as jlayers
from islam_tpu.ops import geometry as jgeo
from islam_tpu.ops import warp as jwarp
from islam_tpu_torch.models import layers as tlayers
from islam_tpu_torch.ops import geometry as tgeo
from islam_tpu_torch.ops import warp as twarp

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-ops")


def _f32(*shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class TestWarp:
    def test_flow_warp(self):
        """Flows up to 6 px on a 12x20 map, so borders are crossed and the
        coverage mask (>= 0.9999) is exercised.  atol 1e-5: bilinear weights
        are computed in two float32 orders."""
        x = _f32(2, 5, 12, 20)
        flo = _f32(2, 2, 12, 20, scale=3.0)
        ref = np.asarray(jwarp.flow_warp(x, flo))
        out = twarp.flow_warp(_t(x), _t(flo)).numpy()
        assert (ref == 0).any() and (out == 0).any()
        np.testing.assert_allclose(out, ref, atol=1e-5)

    @pytest.mark.parametrize("align_corners", [True, False])
    def test_grid_sample_and_coverage(self, align_corners):
        img = _f32(2, 3, 9, 11)
        grid = RNG.uniform(-1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
        ref, rcov = jwarp.grid_sample(img, grid, align_corners=align_corners,
                                      return_coverage=True)
        out, cov = twarp.grid_sample(_t(img), _t(grid),
                                     align_corners=align_corners,
                                     return_coverage=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(cov.numpy(), np.asarray(rcov), atol=1e-5)


class TestGeometry:
    def test_make_intrinsics_layer(self):
        ref = jgeo.make_intrinsics_layer(20, 12, 15.0, 14.0, 9.5, 6.0)
        out = tgeo.make_intrinsics_layer(20, 12, 15.0, 14.0, 9.5, 6.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)

    def test_edge_mask_away_from_threshold(self):
        """A blocky image whose Sobel magnitudes are either 0 or far above
        50, so float rounding cannot flip a pixel: masks must be equal."""
        blocks = RNG.integers(0, 2, (2, 3, 3, 4)).astype(np.float32)
        img = np.kron(blocks, np.ones((1, 1, 12, 12), np.float32))
        ref = np.asarray(jgeo.edge_mask(img))
        out = tgeo.edge_mask(_t(img)).numpy()
        assert ref.any() and not ref.all()
        np.testing.assert_array_equal(out, ref)

    def test_scale_from_disp_flow_batch(self):
        """Per-frame least-squares scale on a synthetic disparity/flow pair.
        rtol 1e-4: ratios of sums over ~200 float32 terms."""
        B, H, W = 3, 12, 20
        disp = RNG.uniform(5.5, 9.0, (B, H, W)).astype(np.float32)
        flow = _f32(B, 2, H, W, scale=2.0)
        mask = RNG.uniform(size=(B, H, W)) > 0.3
        tw = np.concatenate([_f32(B, 3), _f32(B, 3, scale=0.05)], axis=1)
        motion = np.asarray(jax.vmap(lambda x: JSE3(jnp.concatenate(
            [x[:3], jnp.asarray(jgeo.lie.so3_exp(x[3:]))])).data)(tw))
        intr = np.tile([[15.0, 14.0, 9.5, 6.0]], (B, 1)).astype(np.float32)
        base = np.full(B, 0.5, np.float32)
        ref = jgeo.scale_from_disp_flow_batch(
            disp, flow, motion, intr, base, mask=mask, disp_th=5.0)
        out = tgeo.scale_from_disp_flow_batch(
            _t(disp), _t(flow), _t(motion), _t(intr), _t(base),
            mask=_t(mask), disp_th=5.0)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5)
        for o, r in zip(out[2:], ref[2:]):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        one = tgeo.scale_from_disp_flow(
            _t(disp[0]), _t(flow[0]), _t(motion[0]), 15.0, 14.0, 9.5, 6.0,
            0.5, mask=_t(mask[0]), disp_th=5.0)
        np.testing.assert_allclose(one[0].numpy(), out[0][0].numpy(),
                                   rtol=1e-6)


class TestLayers:
    @pytest.mark.parametrize("k,s,p,hw", [(4, 2, 1, (8, 10)), (4, 2, 1, (7, 5)),
                                          (5, 2, 2, (6, 9))])
    def test_convt2d_out_stride(self, k, s, p, hw):
        """The quarter-res head: out_stride=4 must equal the full transposed
        conv sampled at [::4, ::4], and both must equal the JAX layer."""
        x = _f32(2, 6, *hw)
        m = tlayers.init_weights_(tlayers.ConvT2d(6, 3, k, s, p), seed=1)
        q = tlayers.ConvT2d(6, 3, k, s, p, out_stride=4)
        q.load_state_dict(m.state_dict())
        with torch.no_grad():
            full = m(_t(x))
            quarter = q(_t(x))
        np.testing.assert_allclose(quarter.numpy(),
                                   full[..., ::4, ::4].numpy(), atol=1e-5)
        kernel = m.weight.detach().numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
        variables = {"params": {"kernel": jnp.asarray(kernel.copy()),
                                "bias": jnp.asarray(m.bias.detach().numpy())}}
        for os_, out in ((1, full), (4, quarter)):
            ref = jlayers.ConvT2d(3, k, s, p, out_stride=os_).apply(
                variables, np.moveaxis(x, 1, -1))
            np.testing.assert_allclose(out.numpy(),
                                       np.moveaxis(np.asarray(ref), -1, 1),
                                       atol=1e-5)

    @pytest.mark.parametrize("out_hw,align", [((24, 40), False),
                                              ((6, 10), False),
                                              ((3, 5), False),
                                              ((7, 13), True),
                                              ((1, 1), True)])
    def test_resize_bilinear(self, out_hw, align):
        x = _f32(2, 3, 12, 20)
        ref = jlayers.resize_bilinear(np.moveaxis(x, 1, -1), out_hw,
                                      align_corners=align)
        out = tlayers.resize_bilinear(_t(x), out_hw, align_corners=align)
        np.testing.assert_allclose(out.numpy(),
                                   np.moveaxis(np.asarray(ref), -1, 1),
                                   atol=1e-5)

    def test_batchnorm_train_mode(self):
        """Batch statistics, eps 1e-5; rtol 1e-4 for the two variance
        formulas (flax: E[x^2] - E[x]^2; torch: two-pass)."""
        x = _f32(4, 5, 6, 7, scale=3.0) + 1.0
        bn = tlayers.BatchNorm(5)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
            bn.bias.copy_(torch.linspace(-1, 1, 5))
            out = bn(_t(x)).numpy()
        variables = {"params": {"scale": jnp.linspace(0.5, 1.5, 5),
                                "bias": jnp.linspace(-1, 1, 5)},
                     "batch_stats": {"mean": jnp.zeros(5),
                                     "var": jnp.ones(5)}}
        ref, _ = jlayers.BatchNorm(use_running_average=False).apply(
            variables, np.moveaxis(x, 1, -1), mutable=["batch_stats"])
        np.testing.assert_allclose(out, np.moveaxis(np.asarray(ref), -1, 1),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(bn.running_mean, torch.zeros(5))
