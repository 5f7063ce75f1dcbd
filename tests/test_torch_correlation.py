"""Port correlation (plain version, backward, dispatcher) vs the JAX package.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against ``correlation_reference`` there.  Here the plain version is held
against the JAX reference and the Pallas kernel in interpret mode (as
tests/test_pallas_correlation.py runs it), at (2,16,12,20) and at the
partial tile (1,8,7,10).  float32 sums of 16 products differ in order
between the two sides by a few ulp of the output scale: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.ops.correlation import correlation_reference as jax_reference
from islam_tpu.ops.pallas.correlation_kernel import correlation_pallas
from islam_tpu_torch.ops import correlation as corr

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-correlation")
SHAPES = [(2, 16, 12, 20), (1, 8, 7, 10)]


def _pair(shape):
    return (RNG.normal(size=shape).astype(np.float32),
            RNG.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_matches_jax_reference(shape):
    a, b = _pair(shape)
    out = corr.correlation_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert out.shape == (shape[0], 81) + shape[2:]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_reference(a, b)),
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reference_matches_pallas_interpret(shape):
    a, b = _pair(shape)
    out = corr.correlation_reference(torch.from_numpy(a), torch.from_numpy(b))
    ref = correlation_pallas(jnp.asarray(a), jnp.asarray(b), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gradients_match_jax_grad(shape):
    """``correlation_backward`` (CorrelationFn's backward) and autograd of the
    plain version, both against jax.grad of the JAX reference."""
    a, b = _pair(shape)
    g = RNG.normal(size=(shape[0], 81) + shape[2:]).astype(np.float32)
    ja, jb = jax.grad(lambda x, y: jnp.sum(jax_reference(x, y) * g),
                      argnums=(0, 1))(a, b)
    da, db = corr.correlation_backward(torch.from_numpy(a),
                                       torch.from_numpy(b), torch.from_numpy(g))
    np.testing.assert_allclose(da.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jb), atol=1e-5)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    torch.sum(corr.correlation(ta, tb) * torch.from_numpy(g)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), atol=1e-5)


def test_cpu_dispatch_is_the_plain_version_and_never_launches():
    a, b = (torch.from_numpy(x) for x in _pair((2, 8, 7, 10)))
    before = corr.LAUNCHES
    out = corr.correlation(a, b)
    assert corr.LAUNCHES == before
    assert torch.equal(out, corr.correlation_reference(a, b))


def test_batch_slices_of_a_shared_pyramid():
    """The flow net passes c[:-1] and c[1:] of one (B+1) pyramid: contiguous
    views with a storage offset."""
    pyr = torch.from_numpy(RNG.normal(size=(3, 8, 7, 10)).astype(np.float32))
    f1, f2 = pyr[:-1], pyr[1:]
    assert f2.is_contiguous() and f2.storage_offset() > 0
    out = corr.correlation(f1, f2)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_reference(f1.numpy(), f2.numpy())),
        atol=1e-5)


def test_bf16_plain_version_accumulates_in_f32():
    a, b = _pair((1, 8, 7, 10))
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    out = corr.correlation_reference(ta, tb)
    assert out.dtype == torch.bfloat16
    ref = corr.correlation_reference(ta.float(), tb.float())
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.bfloat16().float().numpy())


@pytest.mark.parametrize("bad", ["md", "shape", "device", "dtype", "layout"])
def test_kernel_wrapper_rejects_what_it_does_not_take(bad):
    """The CUDA wrapper checks its inputs before it builds or launches."""
    a = torch.zeros(1, 8, 7, 10)
    b = torch.zeros(1, 8, 7, 10)
    kw = {}
    if bad == "md":
        kw["md"] = 3
    elif bad == "shape":
        b = torch.zeros(1, 8, 7, 11)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "layout":
        a = torch.zeros(1, 8, 10, 7).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        corr.correlation_cuda(a, b, **kw)
    assert corr._lib is None  # nothing was compiled or loaded
