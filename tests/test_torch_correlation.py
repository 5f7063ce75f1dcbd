"""Port correlation (plain version, backward, dispatcher) vs the JAX package.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against ``correlation_reference`` there.  Here the sm90 kernel's launch
plan is checked (every output element owned by exactly one thread, the grid
and shared memory within the card's limits, the card filled at the main
path's five levels), and the plain version is held against the JAX
reference and the Pallas kernel in interpret mode (as
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


def _counts():
    return (corr.LAUNCHES, corr.LAUNCHES_81, corr.LAUNCHES_ALL,
            corr.LAUNCHES_ALL_DY)


def test_cpu_dispatch_is_the_plain_version_and_never_launches():
    a, b = (torch.from_numpy(x) for x in _pair((2, 8, 7, 10)))
    before = _counts()
    ref = corr.correlation_reference(a, b)
    for dispatch in (corr.correlation, corr.correlation_81,
                     corr.correlation_all, corr.correlation_all_dy):
        assert torch.equal(dispatch(a, b), ref)
    assert _counts() == before


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
    for wrapper in (corr.correlation_cuda, corr.correlation_81_cuda,
                    corr.correlation_all_cuda, corr.correlation_all_dy_cuda):
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
    the checks of all four kernels' dispatchers and of each pair run, and
    nothing is timed off the card."""
    from islam_tpu_torch import bench_corr

    rows = bench_corr.run("cpu", batch=2, levels=[(8, 7, 10), (16, 14, 20)])
    assert [r["level"] for r in rows] == [[8, 7, 10], [16, 14, 20]]
    names = ["correlation", "correlation_81", "correlation_all",
             "correlation_all_dy"]
    pairs = [f"{a}_vs_{b}_max_abs_diff" for i, a in enumerate(names)
             for b in names[i + 1:]]
    for r in rows:
        for dname in ("float32", "bfloat16"):
            d = r[dname]
            assert [d[k] for k in pairs] == [0.0] * 6
            for name in (*names, "plain"):
                assert d[f"{name}_ms"] is None
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
    assert set(corr.SOURCES) == {"islam_corr_fwd_sm90", "islam_corr_fwd",
                                 "islam_corr_fwd_dy",
                                 "islam_corr_fwd_all_sm90"}
    for symbol, src in corr.SOURCES.items():
        assert src.exists() and f'extern "C" int {symbol}(' in src.read_text()


# The sm90 kernel's plans: the five (B, C, H, W) of one 448x640, B=8 VO
# forward, and the edge shapes chip_smoke.py checks on the card.
LEVELS = [(8, 196, 7, 10), (8, 128, 14, 20), (8, 96, 28, 40),
          (8, 64, 56, 80), (8, 32, 112, 160)]
EDGES = [(1, 8, 7, 10), (2, 37, 9, 13), (1, 3, 5, 7), (2, 5, 7, 9)]
# (dtype, data pointer alignment in bytes): aligned tensors, and the batch
# slice [1:] of a (3, 5, 7, 9) pyramid (315 elements in)
VARIANTS = [(torch.float32, 16), (torch.float32, 4), (torch.bfloat16, 16),
            (torch.bfloat16, 2)]


def _owners(B, C, H, W, p):
    """How many threads write each output element, under the kernel's map
    of (block, thread) to (image, dy, row, 4 columns): (B, 81, H, W)."""
    nk = p.tw // 4
    tps = p.ndy * p.ry * nk
    ncol = -(-W // p.tw)
    t = np.arange(tps)  # slice 0 writes; the other slices hand it their sums
    k, r, j = t % nk, (t // nk) % p.ry, t // (nk * p.ry)
    bx, by = np.meshgrid(np.arange(p.grid[0]), np.arange(p.grid[1]),
                         indexing="ij")
    x0 = (bx.ravel() % ncol) * p.tw
    y0 = (bx.ravel() // ncol) * p.ry
    dy0 = by.ravel() * p.ndy
    counts = np.zeros((B, 81, H, W), np.int64)
    for b in range(p.grid[2]):
        y = (y0[:, None] + r)[:, :, None, None]
        x = (x0[:, None] + 4 * k)[:, :, None, None] + np.arange(4)
        o = ((dy0[:, None] + j) * 9)[:, :, None, None] + np.arange(9)[:, None]
        y, x, o = np.broadcast_arrays(y, x, o)
        keep = (y < H) & (x < W)
        flat = (o[keep] * H + y[keep]) * W + x[keep]
        counts[b] = np.bincount(flat, minlength=81 * H * W).reshape(81, H, W)
    return counts


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS + EDGES, ids=str)
def test_plan_sm90_covers_every_output_once(shape, variant):
    p = corr._plan_sm90(*shape, *variant)
    B, C, H, W = shape
    assert np.array_equal(_owners(B, C, H, W, p),
                          np.ones((B, 81, H, W), np.int64))
    # a thread's 12 f2 values (x-4 .. x+7) lie inside its staged row
    margin = 16 // corr._ITEMSIZE[variant[0]]
    assert margin - 4 + p.tw - 4 + 12 <= p.tw + 2 * margin
    assert p.cc % p.ns == 0 and p.block == p.ns * p.ndy * p.ry * p.tw // 4


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS + EDGES + [(65535, 3, 5, 7)],
                         ids=str)
def test_plan_sm90_fits_the_card(shape, variant):
    p = corr._plan_sm90(*shape, *variant)
    assert p.grid[2] == shape[0] <= 65535
    assert p.smem <= 232448 and p.block <= 288
    assert p.grid[1] * p.ndy == 9


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS, ids=str)
def test_plan_sm90_fills_the_card_at_the_five_levels(shape, variant):
    """At least one block per SM of the H100 (132), all resident at once
    where the blocks split channels, and at least 80 % of the lanes own a
    column (W = 10, 20, 40 included)."""
    p = corr._plan_sm90(*shape, *variant)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert blocks >= 132
    assert p.ns == 1 or blocks <= 132 * corr._resident(p.block, p.smem)
    W = shape[3]
    assert W / (-(-W // p.tw) * p.tw) >= 0.8


@pytest.mark.parametrize("dtype,align,W,vec", [
    (torch.float32, 16, 160, 16), (torch.float32, 16, 10, 8),
    (torch.float32, 4, 10, 4), (torch.float32, 4, 160, 4),
    (torch.bfloat16, 16, 160, 16), (torch.bfloat16, 16, 20, 8),
    (torch.bfloat16, 16, 10, 4), (torch.bfloat16, 2, 160, 2),
    (torch.bfloat16, 16, 13, 2)])
def test_plan_sm90_copy_width_follows_row_and_base_alignment(dtype, align,
                                                             W, vec):
    """16-byte copies only where rows and base are 16-byte aligned, else
    8- or 4-byte copies, else (bf16) 2-byte loads."""
    assert corr._plan_sm90(2, 8, 6, W, dtype, align).vec == vec


def test_alignment_of_a_batch_slice():
    pyr = torch.zeros(3, 5, 7, 9)
    assert corr._alignment(pyr[:-1]) == 16
    assert corr._alignment(pyr[:-1], pyr[1:]) == 4  # 1260 bytes in
    assert corr._alignment(pyr.bfloat16()[1:]) == 2  # 630 bytes in


# The all-shift tensor-core kernel (csrc/correlation_all_sm90.cu): its plans
# at the same shapes, and an emulation of its tile arithmetic.

def _all_owners(B, H, W, p, item):
    """How many warp items store each output pixel (all 81 channels of it),
    under the kernel's map of (block, tile, warp) to (image, row) of a
    16-column tile: persistent block bx takes tiles bx, bx + grid, ..; tiles run
    image by image, rows, then columns.  Slice 0's items stand for their
    slices, which hand them their sums: (B, H, W)."""
    sh = corr._all_shift(p.vec, item)
    ncol, nrow = -(-(W + sh) // 16), -(-H // p.ry)
    counts = np.zeros((B, H, W), np.int64)
    for bx in range(p.grid[0]):
        for t in range(bx, B * ncol * nrow, p.grid[0]):
            b, rest = divmod(t, ncol * nrow)
            x0, y0 = (rest % ncol) * 16 - sh, (rest // ncol) * p.ry
            x = x0 + np.arange(16)
            for y in range(y0, min(y0 + p.ry, H)):
                counts[b, y, x[(x >= 0) & (x < W)]] += 1
    return counts


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS + EDGES, ids=str)
def test_plan_all_sm90_covers_every_output_once(shape, variant):
    p = corr._plan_all_sm90(*shape, *variant)
    B, C, H, W = shape
    item = corr._ITEMSIZE[variant[0]]
    assert np.array_equal(_all_owners(B, H, W, p, item), np.ones((B, H, W)))
    assert p.block == 32 * p.ry * p.ns and p.kc == 16 * p.ns
    # every channel lies in one chunk and one slice; the padding is at most
    # an eighth of the 16-channel steps
    steps = -(-C // 16)
    assert -(-C // p.kc) * p.kc >= C
    assert -(-steps // p.ns) * p.ns - steps <= steps / 8


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS + EDGES + [(65535, 3, 5, 7)],
                         ids=str)
def test_plan_all_sm90_fits_the_card(shape, variant):
    """Shared memory, threads and registers (255 a thread, the launch
    bounds' cap, on a 65,536-register SM), the grid, and TMA's box limits
    (at most 256 elements a dimension)."""
    p = corr._plan_all_sm90(*shape, *variant)
    assert p.grid[1] == p.grid[2] == 1
    assert p.smem <= 232448 and p.block <= 256
    assert p.block * corr._ALL_REGISTERS <= 65536
    assert (p.ry + 8) | 1 <= 256 and p.kc <= 256


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("shape", LEVELS, ids=str)
def test_plan_all_sm90_fills_the_card_at_the_five_levels(shape, variant):
    """Two warps an SM of the H100 (132) at least, in a persistent grid of
    at most as many blocks as the card holds at once (208 registers a
    thread as allocated, the shared bytes, 2048 threads an SM); a block
    for every SM, or a block for every tile where the level has fewer."""
    p = corr._plan_all_sm90(*shape, *variant)
    B, C, H, W = shape
    sh = corr._all_shift(p.vec, corr._ITEMSIZE[variant[0]])
    tiles = B * -(-(W + sh) // 16) * -(-H // p.ry)
    resident = min(65536 // (208 * p.block), 233472 // (p.smem + 1024),
                   2048 // p.block)
    assert p.grid[0] * p.block // 32 >= 2 * 132
    assert p.grid[0] <= min(tiles, 132 * max(1, resident))
    assert p.grid[0] >= 132 or p.grid[0] == tiles


@pytest.mark.parametrize("dtype,align,W,vec", [
    (torch.float32, 16, 160, 16), (torch.float32, 16, 10, 8),
    (torch.float32, 4, 160, 4), (torch.float32, 4, 7, 4),
    (torch.bfloat16, 16, 160, 16), (torch.bfloat16, 16, 20, 8),
    (torch.bfloat16, 16, 10, 4), (torch.bfloat16, 2, 160, 2),
    (torch.bfloat16, 16, 13, 2)])
def test_plan_all_sm90_staging_follows_row_and_base_alignment(dtype, align,
                                                              W, vec):
    """TMA (16) where rows and base are 16-byte aligned; otherwise the
    widest copy that divides both, of at most 4 elements (the f2 window
    starts 4 columns left of a 16-column tile)."""
    assert corr._plan_all_sm90(2, 8, 6, W, dtype, align).vec == vec


@pytest.mark.parametrize("item", [4, 2])
def test_all_sm90_tma_boxes_start_on_16_bytes(item):
    """Under TMA, each tile's f2 window (4 columns left of the tile) starts
    on 16 bytes, and in f32 the f1 tile too (a bf16 box 8 bytes in faults
    on the H100); rows are 16-byte multiples there."""
    sh = corr._all_shift(corr._ALL_TMA, item)
    x0 = 16 * np.arange(20) - sh
    assert ((x0 - 4) * item % 16 == 0).all()
    assert item == 2 or (x0 * item % 16 == 0).all()
    assert corr._all_shift(8, item) == 0


def _tf32(x):
    """cvt.rna.tf32.f32 on the int32 view: round to the nearest 10-bit
    mantissa, ties away from zero (the magnitude bits carry)."""
    u = x.contiguous().numpy().view(np.uint32)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(r.view(np.float32))


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3.0], dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32(x).numpy(), [one + ulp, -(one + ulp), one, one + ulp, 3.0])
    # 3xTF32: hi + lo keeps about 21 bits of each operand
    v = torch.from_numpy(RNG.normal(size=1000).astype(np.float32))
    hi = _tf32(v)
    lo = _tf32(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21


def _fragment_band():
    """The band as the kernel extracts it from the mma accumulators: lane
    (gid, tig), fragment nf and register i hold m = gid + 8(i >> 1), n =
    8 nf + 2 tig + (i & 1); the kernel keeps dx = n - m in [0, 8].  Returns
    [(m, n, dx)] over all lanes and registers."""
    out = []
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for nf in range(3):
            for i in range(4):
                m, n = gid + 8 * (i >> 1), 8 * nf + 2 * tig + (i & 1)
                if 0 <= n - m <= 8:
                    out.append((m, n, n - m))
    return out


def test_fragment_band_holds_every_shift_of_every_column_once():
    band = _fragment_band()
    assert sorted((m, dx) for m, _, dx in band) == [
        (m, dx) for m in range(16) for dx in range(9)]


def _emulate_all_sm90(f1, f2, p):
    """The kernel's arithmetic on the CPU: per 16-column subtile, row and
    dy, the 16 x 24 product of f1 (m = x) and f2's row y+dy (n = x',
    columns x0-4 ..), summed per channel slice in f32 (bf16 operands; f32
    as 3xTF32: hi.lo + lo.hi + hi.hi), the slices added in order, the band
    extracted as the fragments hold it, scaled by 1/C and converted."""
    B, C, H, W = f1.shape
    Wp = -(-W // 16) * 16
    Cp = -(-C // p.kc) * p.kc
    a = torch.zeros(B, Cp, H, Wp)
    a[:, :C, :, :W] = f1.float()
    b = torch.zeros(B, Cp, H + 8, Wp + 8)
    b[:, :C, 4:4 + H, 4:4 + W] = f2.float()
    ch = torch.arange(Cp)
    slices = [ch[(ch % p.kc) // 16 == q] for q in range(p.ns)]
    band = _fragment_band()
    m_i = torch.tensor([m for m, _, _ in band])
    n_i = torch.tensor([n for _, n, _ in band])
    dx_i = torch.tensor([dx for _, _, dx in band])
    out = torch.zeros(B, 81, H, Wp)
    for dy in range(9):
        for x0 in range(0, Wp, 16):
            A = a[:, :, :, x0:x0 + 16]
            Bm = b[:, :, dy:dy + H, x0:x0 + 24]
            total = None
            for idx in slices:
                As, Bs = A[:, idx], Bm[:, idx]
                if f1.dtype == torch.float32:
                    ah, bh = _tf32(As), _tf32(Bs)
                    al, bl = _tf32(As - ah), _tf32(Bs - bh)
                    part = sum(torch.einsum("bcym,bcyn->bymn", u, v)
                               for u, v in ((ah, bl), (al, bh), (ah, bh)))
                else:
                    part = torch.einsum("bcym,bcyn->bymn", As, Bs)
                total = part if total is None else total + part
            # (band, B, H): the two index tensors' dimension comes first
            out[:, dy * 9 + dx_i, :, x0 + m_i] = (
                total[:, :, m_i, n_i].permute(2, 0, 1))
    return (out[..., :W] * (1.0 / C)).to(f1.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", [(1, c, 3, 20) for _, c, _, _ in LEVELS]
                         + EDGES[:3], ids=str)
def test_all_sm90_arithmetic_matches_the_plain_version(shape, dtype):
    """The emulated tile arithmetic within bench_corr.TOL x max|plain| of
    ``correlation_reference``, at the five levels' C (small H, W) and the
    odd shapes chip_smoke.py checks."""
    from islam_tpu_torch import bench_corr

    a, b = (torch.from_numpy(x).to(dtype) for x in _pair(shape))
    p = corr._plan_all_sm90(*shape, dtype)
    got = _emulate_all_sm90(a, b, p)
    ref = corr.correlation_reference(a, b).float()
    tol = bench_corr.TOL[str(dtype).split(".")[1]] * float(ref.abs().max())
    assert got.dtype == dtype
    assert float((got.float() - ref).abs().max()) <= tol
