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
from islam_tpu.ops.pallas.correlation_kernel import (_corr_fwd_all,
                                                     correlation_pallas)
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
    for wrapper in (corr.correlation_cuda, corr.correlation_all_cuda):
        with pytest.raises((ValueError, TypeError)):
            wrapper(a, b, **kw)
    assert corr._fns == {}  # nothing was compiled or loaded


@pytest.mark.parametrize("shape", [(2, 8, 7, 10), (1, 16, 14, 20)], ids=str)
def test_correlation_all_matches_the_all_dy_pallas_kernel(shape):
    """The dispatcher of the second kernel's port, on the CPU, against
    ``_corr_fwd_all`` (the all-81-channel Pallas kernel) in interpret mode."""
    a, b = _pair(shape)
    before = corr.LAUNCHES_ALL
    out = corr.correlation_all(torch.from_numpy(a), torch.from_numpy(b))
    assert corr.LAUNCHES_ALL == before
    ref = _corr_fwd_all(jnp.asarray(a), jnp.asarray(b), md=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bench_corr_checks_both_dispatchers_on_the_cpu():
    """The port of scripts/bench_corr.py at two small levels on the CPU:
    the checks run, and nothing is timed off the card."""
    from islam_tpu_torch import bench_corr

    rows = bench_corr.run("cpu", batch=2, levels=[(8, 7, 10), (16, 14, 20)])
    assert [r["level"] for r in rows] == [[8, 7, 10], [16, 14, 20]]
    for r in rows:
        for dname in ("float32", "bfloat16"):
            d = r[dname]
            assert d["max_abs_diff_between"] == 0.0
            assert d["correlation_ms"] is None and d["plain_ms"] is None
            assert d["bound_by"] == "bytes" and d["bound_ms"] > 0
    assert bench_corr.totals(rows)["float32"]["correlation_ms"] is None


def test_bench_corr_draws_f1_and_f2_independently():
    """The bench's inputs are the main path's: no f2 is another image's f1
    (shared storage would put f2 in L2 before the kernel reads it)."""
    from islam_tpu_torch import bench_corr

    gen = torch.Generator().manual_seed(0)
    f1, f2 = bench_corr.feature_pair((3, 4, 5, 6), torch.float32, gen, "cpu")
    assert f1.shape == f2.shape == (3, 4, 5, 6)
    assert f1.untyped_storage().data_ptr() != f2.untyped_storage().data_ptr()
    for b in range(3):
        for c in range(3):
            assert not torch.equal(f1[b], f2[c])


def test_bench_corr_bound_counts_each_byte_once():
    from islam_tpu_torch import bench_corr

    ms, by = bench_corr.bound_ms((8, 32, 112, 160), "float32")
    nbytes = (2 * 8 * 32 * 112 * 160 + 8 * 81 * 112 * 160) * 4
    assert by == "bytes"
    np.testing.assert_allclose(ms, nbytes / 3.35e12 * 1e3, rtol=1e-12)
    ms16, _ = bench_corr.bound_ms((8, 32, 112, 160), "bfloat16")
    np.testing.assert_allclose(ms16, ms / 2, rtol=1e-12)


def test_cuda_sources_are_one_library_each():
    """Each kernel source has its own C entry point, and ``build_all``
    builds them all."""
    assert set(corr.SOURCES) == {"islam_corr_fwd", "islam_corr_fwd_dy"}
    for symbol, src in corr.SOURCES.items():
        assert src.exists() and f'extern "C" int {symbol}(' in src.read_text()
