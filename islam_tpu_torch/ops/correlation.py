"""Local cost-volume correlation (PWC-Net), with four hand-written CUDA kernels.

Counterpart of ``islam_tpu/ops/correlation.py`` and of the Pallas kernels in
``islam_tpu/ops/pallas/correlation_kernel.py``.  The function, for
(B, C, H, W) inputs:

    out[b, (dy+md)*(2md+1) + (dx+md), y, x]
        = (1/C) * sum_c f1[b, c, y, x] * pad_md(f2)[b, c, y+dy, x+dx]

with ``f2`` zero-padded by ``md`` on both spatial axes, the sum taken in f32
and the output in ``f1.dtype``.

- ``correlation_reference``: the plain PyTorch version (81 shifted products).
  CPU tensors use it, and ``chip_smoke.py`` holds every kernel against it.
- ``correlation_cuda``: launches ``csrc/correlation_sm90.cu``, the main
  path's kernel, designed for Hopper (a port of ``_corr_dy_kernel``: a grid
  over image, row strip, column tile and dy group; 4 x 9 sums a thread;
  cp.async staging).  ``_plan_sm90`` chooses its tiles, grid, block and
  shared bytes.  ``LAUNCHES`` counts its launches.
- ``correlation_81_cuda``: launches ``csrc/correlation.cu`` (PR 1's port of
  ``_corr_dy_kernel``; all 81 sums of a pixel in one thread).
  ``LAUNCHES_81`` counts its launches.  Only ``bench_corr`` and
  ``chip_smoke.py`` call it, as the baseline of the redesign.
- ``correlation_all_cuda``: launches ``csrc/correlation_all_sm90.cu``, the
  port of ``_corr_all_kernel`` designed for Hopper (all 81 shifts per block,
  so f1 is read once; channel sums as banded products on the tensor cores,
  bf16 mma or 3xTF32; TMA or cp.async staging).  ``_plan_all_sm90`` chooses
  its tiles, channel slices, grid, block and shared bytes.  ``LAUNCHES_ALL``
  counts its launches.  ``CorrelationFn`` launches it for bfloat16 inputs.
- ``correlation_all_dy_cuda``: launches ``csrc/correlation_dy.cu`` (PR 2's
  port of ``_corr_all_kernel``; one row shift per block, 9 sums a thread),
  the baseline of the redesign.  ``LAUNCHES_ALL_DY`` counts its launches.
  Only ``bench_corr`` and ``chip_smoke.py`` call it.
- All four take md = 4 and f32 or bf16.  Each library is compiled with
  ``nvcc`` for sm_90a at first use into ``islam_tpu_torch/_build/`` and
  loaded with ``ctypes``; importing this module compiles and loads nothing.
- ``CorrelationFn``: the autograd Function whose forward is the main path's
  kernel (``correlation_cuda`` in float32, ``correlation_all_cuda`` in
  bfloat16, the ``--bf16`` path) and whose backward is the shifted-product
  formula in plain torch ops (the TPU side has no backward kernel either).
- ``correlation``, ``correlation_81``, ``correlation_all`` and
  ``correlation_all_dy``: the dispatchers.  They follow the tensors'
  device: CPU goes to the plain version, CUDA to the kernel, and anything
  the kernel does not take raises.  There is no fallback.  The last three
  are forward-only, as ``_corr_fwd_all`` is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import functools
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

MD_DEFAULT = 4

# Kernel launches since import (or since the caller last set them to 0):
# ``correlation_cuda``'s (the main path's), ``correlation_81_cuda``'s,
# ``correlation_all_cuda``'s and ``correlation_all_dy_cuda``'s.
LAUNCHES = 0
LAUNCHES_81 = 0
LAUNCHES_ALL = 0
LAUNCHES_ALL_DY = 0

_PKG = Path(__file__).resolve().parents[1]
# C entry point -> source; one shared library per source
SOURCES = {"islam_corr_fwd_sm90": _PKG / "csrc" / "correlation_sm90.cu",
           "islam_corr_fwd": _PKG / "csrc" / "correlation.cu",
           "islam_corr_fwd_dy": _PKG / "csrc" / "correlation_dy.cu",
           "islam_corr_fwd_all_sm90": _PKG / "csrc" / "correlation_all_sm90.cu"}
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_fns = {}  # C entry point -> loaded ctypes function


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          md: int = MD_DEFAULT) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, (2md+1)^2, H, W), accumulated in f32."""
    B, C, H, W = f1.shape
    a = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    inv_c = 1.0 / C
    outs = []
    for dy in range(2 * md + 1):
        for dx in range(2 * md + 1):
            shifted = f2p[:, :, dy:dy + H, dx:dx + W]
            outs.append(torch.sum(a * shifted, dim=1) * inv_c)
    return torch.stack(outs, dim=1).to(f1.dtype)


def correlation_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                         md: int = MD_DEFAULT):
    """Gradients of ``correlation`` w.r.t. f1 and f2 for the cotangent ``g``
    (the formula of ``_corr_bwd_xla`` in the JAX package): df1 is the sum of
    g-weighted shifts of f2, df2 the shifted scatter of g-weighted f1."""
    B, C, H, W = f1.shape
    n = 2 * md + 1
    inv_c = 1.0 / C
    f2p = F.pad(f2, (md, md, md, md))
    df1 = torch.zeros_like(f1)
    df2p = torch.zeros_like(f2p)
    for dy in range(n):
        for dx in range(n):
            gs = g[:, dy * n + dx, None] * inv_c
            df1 = df1 + gs * f2p[:, :, dy:dy + H, dx:dx + W]
            df2p[:, :, dy:dy + H, dx:dx + W] += gs * f1
    return df1, df2p[:, :, md:md + H, md:md + W]


def build_library(source: Path) -> Path:
    """Compile ``source`` (once per source content) and return the shared
    library's path.  ptxas's report (registers, shared memory, spills) is
    kept beside it as ``<library>.ptxas.txt``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    Path(f"{lib}.ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


def build_all() -> dict:
    """Build every kernel library at once, one ``nvcc`` per source, all
    started together.  Returns {C entry point: library path}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = pool.map(build_library, SOURCES.values())
        return dict(zip(SOURCES, libs))


def load_kernel(symbol: str):
    """Build (if needed) and load the library of C entry point ``symbol``;
    returns the ctypes function."""
    if symbol not in _fns:
        fn = getattr(ctypes.CDLL(str(build_library(SOURCES[symbol]))), symbol)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # f1, f2, out, B, C, H, W, 1/C, dtype [, the plan], stream
        plan = [i32] * {"islam_corr_fwd_sm90": 11,
                        "islam_corr_fwd_all_sm90": 9}.get(symbol, 0)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float,
                       i32, *plan, ptr]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


# csrc/correlation_sm90.cu's constants
_SM90_STAGES = 3          # ring buffers of channel chunks
_SM90_STAGE_BYTES = 49152  # the most one ring buffer may hold
_SM90_MAX_SLICES = 32
_SM90_MAX_THREADS = 288
_SM90_REGISTERS = 72      # a thread's registers at most (launch bounds)
# (ry, ndy) in the order _plan_sm90 tries them: most shared data first
_SM90_TILES = [(4, 9), (2, 9), (4, 3), (2, 3), (1, 9), (1, 3), (4, 1),
               (2, 1), (1, 1)]
_XS = 4                   # output columns per thread
# The H100 SXM's SMs and what one SM holds
_SMS = 132
_SM_REGISTERS = 65536
_SM_SHARED = 233472       # bytes; each block also reserves 1 KB
_SM_THREADS = 2048


class Sm90Plan(NamedTuple):
    """A launch of ``islam_corr_fwd_sm90``.  ``vec`` (copy bytes: 16, 8, 4,
    or 2 for bf16) with the dtype picks the template variant; ``tw`` x ``ry``
    is a block's output tile, ``ndy`` its row shifts, ``ns`` its channel
    slices, ``cc`` the channels of one ring buffer."""
    vec: int
    tw: int
    ry: int
    ndy: int
    ns: int
    cc: int
    grid: tuple
    block: int
    smem: int


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _resident(block: int, smem: int) -> int:
    """Blocks of ``block`` threads and ``smem`` dynamic shared bytes that
    one SM holds at once."""
    warps = -(-block // 32)
    return max(1, min(_SM_REGISTERS // (_SM90_REGISTERS * 32 * warps),
                      _SM_SHARED // (smem + 1024), _SM_THREADS // block))


@functools.lru_cache(maxsize=256)
def _plan_sm90(B: int, C: int, H: int, W: int, dtype: torch.dtype,
               align: int = 16) -> Sm90Plan:
    """Tiles, grid, block and dynamic shared bytes of the sm90 kernel for
    (B, C, H, W) inputs whose data pointers are ``align``-byte aligned.

    Columns: at most 32 a tile, W split into equal tiles rounded up to the
    copy granule, so few lanes idle at W = 10, 20, 40.  Rows and dy: the
    tile that shares the most staged data (ry x ndy, all nine dy first)
    among those whose grid has a block for every SM.  Channel slices fill a
    block up to 288 threads, with at least 6 channels a slice.  A ring
    buffer holds up to 8 channels a slice within 48 KB, and fewer where
    that lets every block of a sliced grid be resident at once.  (Chosen
    from a sweep of these parameters at the five levels of a 448x640, B=8
    VO forward on the H100.)"""
    item = _ITEMSIZE[dtype]
    vec = next(v for v in (16, 8, 4, 2)
               if v >= item and align % v == 0 and W * item % v == 0)
    unit = 16 // item if vec == 16 else _XS
    ncol = -(-W // 32)
    tw = _round_up(-(-W // ncol), unit)
    ncol = -(-W // tw)
    nk = tw // _XS
    ry, ndy = next(((ry, ndy) for ry, ndy in _SM90_TILES
                    if B * -(-H // min(ry, H)) * ncol * (9 // ndy)
                    >= _SMS), (1, 1))
    ry = min(ry, H)
    tps = ndy * ry * nk
    ns = max(1, min(_SM90_MAX_SLICES, _SM90_MAX_THREADS // tps, C // 6))
    sw = tw + 2 * (16 // item)
    per_channel = (ry * tw + (ry + ndy - 1) * sw) * item
    per_slice = max(1, min(8, _SM90_STAGE_BYTES // (per_channel * ns)))
    cps = 1 << (per_slice.bit_length() - 1)
    while True:
        plan = _sm90_launch(B, H, W, item, vec, tw, ry, ndy, ns,
                            min(ns * cps, _round_up(C, ns)))
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        if (ns == 1 or cps == 1
                or blocks <= _SMS * _resident(plan.block, plan.smem)):
            return plan
        cps //= 2


def _sm90_launch(B, H, W, item, vec, tw, ry, ndy, ns, cc) -> Sm90Plan:
    """The plan of these tiles: grid, block and shared bytes (a ring of
    ``_SM90_STAGES`` buffers, or all slices' sums if larger)."""
    sw = tw + 2 * (16 // item)
    tps = ndy * ry * tw // _XS
    f1_elems = _round_up(cc * ry * tw, 8)
    stage = _round_up(f1_elems + cc * (ry + ndy - 1) * sw, 8) * item
    reduce = ns * tps * 9 * _XS * 4 if ns > 1 else 0
    return Sm90Plan(vec=vec, tw=tw, ry=ry, ndy=ndy, ns=ns, cc=cc,
                    grid=(-(-W // tw) * -(-H // ry), 9 // ndy, B),
                    block=ns * tps, smem=max(_SM90_STAGES * stage, reduce))


# csrc/correlation_all_sm90.cu's constants
_ALL_MT = 16              # output columns of a warp item (mma M)
_ALL_KS = 16              # channels of one slice in one chunk
_ALL_BP = 20              # floats between two channels of a band tile
_ALL_STAGES = 2           # ring of chunk buffers
_ALL_MAX_THREADS = 256
_ALL_REGISTERS = 255      # a thread's registers at most (launch bounds)
_ALL_REG_ALLOC = 208      # a thread's registers as allocated (ptxas: 178-202)
_ALL_TMA = 16             # the vec that stages by TMA
_SMEM_MAX = 232448        # dynamic shared bytes a block may use
_OUT = 81                 # output channels at md = 4


class AllSm90Plan(NamedTuple):
    """A launch of ``islam_corr_fwd_all_sm90``.  ``vec``: 16 stages by TMA
    (bf16: f2 only, tiles from x = -12), 8, 4 or 2 (bf16) by copies of that
    many bytes; ``ry`` x 16 is a
    tile (one warp a row), ``ns`` a block's channel slices, ``kc`` = 16
    ``ns`` the channels of one chunk; ``grid`` persistent blocks walk the
    tiles."""
    vec: int
    ry: int
    ns: int
    kc: int
    grid: tuple
    block: int
    smem: int


@functools.lru_cache(maxsize=256)
def _plan_all_sm90(B: int, C: int, H: int, W: int, dtype: torch.dtype,
                   align: int = 16) -> AllSm90Plan:
    """Tiles, channel slices, grid, block and dynamic shared bytes of the
    all-shift kernel for (B, C, H, W) inputs whose data pointers are
    ``align``-byte aligned.

    Staging: TMA where the pointers and the rows are 16-byte aligned (in
    bf16 for f2 only, with tiles from x = -12), else the widest copy (8,
    4, then 2 bytes) that divides both and keeps a granule within 4
    elements.  Columns: tiles of 16.  Levels
    with more than 112 channels split them: strips of 2 rows where that
    gives 96 tiles, else 1, and the most channel slices (up to 8 warps a
    block) whose chunks pad the channels by at most an eighth and whose
    ring fits.  The others keep all channels in each warp: strips of 8
    rows where the level has at most 132 such tiles, else 4 (more rows
    share each staged f2 row).  (Chosen from a sweep of ry, ns and tiles
    of 16 or 32 columns at the five levels of a 448x640, B=8 VO forward on
    the H100; 32 columns never won.)"""
    item = _ITEMSIZE[dtype]
    if align % 16 == 0 and W * item % 16 == 0:
        vec = _ALL_TMA
    else:
        vec = next(v for v in (8, 4, 2)
                   if v >= item and v // item <= 4 and align % v == 0
                   and W * item % v == 0)
    ncol = -(-(W + _all_shift(vec, item)) // _ALL_MT)
    ksteps = -(-C // _ALL_KS)

    def tiles(ry):
        return B * -(-H // ry) * ncol

    if ksteps > 7:
        ry = min(H, 2 if tiles(2) >= 96 else 1)
        want = _ALL_MAX_THREADS // 32 // ry
    else:
        ry = min(H, 8 if tiles(8) <= _SMS else 4)
        want = 1
    for ns in range(min(want, ksteps), 0, -1):
        plan = _all_sm90_launch(B, C, H, W, item, vec, ry, ns)
        if (-(-ksteps // ns) * ns - ksteps <= ksteps / 8
                and plan.smem <= _SMEM_MAX or ns == 1):
            return plan


def _all_shift(vec: int, item: int) -> int:
    """Columns left of 0 where the all-shift kernel's tiles start: 12 for
    bf16 under TMA, so that each f2 window starts on 32 bytes."""
    return 12 if vec == _ALL_TMA and item == 2 else 0


def _all_sm90_launch(B, C, H, W, item, vec, ry, ns) -> AllSm90Plan:
    """The plan of these tiles: a persistent grid of as many blocks as the
    card holds at once (at most one a tile), the block, and the shared
    bytes (a ring of up to ``_ALL_STAGES`` chunk buffers, then the warps'
    band tiles, which reuse the ring where each block has one tile)."""
    kc = _ALL_KS * ns
    stage = (_round_up(kc * ry * _ALL_MT * item, 128)
             + _round_up(kc * ((ry + 8) | 1) * (_ALL_MT + 8) * item, 128))
    band = ns * ry * _OUT * _ALL_BP * 4
    block = 32 * ry * ns
    tiles = B * -(-(W + _all_shift(vec, item)) // _ALL_MT) * -(-H // ry)
    resident = max(1, min(_SM_REGISTERS // (_ALL_REG_ALLOC * block),
                          _SM_SHARED // (_ALL_STAGES * stage + band + 1024),
                          _SM_THREADS // block))
    grid = min(tiles, _SMS * resident)
    ring = min(_ALL_STAGES, -(-tiles // grid) * -(-C // kc)) * stage
    return AllSm90Plan(vec=vec, ry=ry, ns=ns, kc=kc,
                       grid=(grid, 1, 1), block=block,
                       smem=ring + band if tiles > grid else max(ring, band))


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    ptr = 0
    for t in tensors:
        ptr |= t.data_ptr()
    return min(16, ptr & -ptr) if ptr else 16


def _output(f1: torch.Tensor, f2: torch.Tensor, md: int) -> torch.Tensor:
    """Check the inputs the kernels take, and allocate their output."""
    if md != MD_DEFAULT:
        raise ValueError(f"the correlation kernels are built for md=4, got {md}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two (B, C, H, W) tensors of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(f"need float32 or bfloat16 inputs of one dtype, got "
                        f"{f1.dtype} and {f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the correlation kernels need contiguous inputs")
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError(f"need both inputs on one CUDA device, got "
                         f"{f1.device} and {f2.device}")
    B, C, H, W = f1.shape
    return torch.empty((B, (2 * md + 1) ** 2, H, W), dtype=f1.dtype,
                       device=f1.device)


def _launch(symbol: str, f1: torch.Tensor, f2: torch.Tensor,
            out: torch.Tensor, plan: tuple = ()) -> None:
    """Launch ``symbol`` on the current stream of ``f1``'s device, with the
    sm90 kernel's ``plan`` flattened into ints."""
    B, C, H, W = f1.shape
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    rc = load_kernel(symbol)(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
        1.0 / C, _DTYPES[f1.dtype], *plan, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     md: int = MD_DEFAULT) -> torch.Tensor:
    """The main path's kernel (``csrc/correlation_sm90.cu``)."""
    global LAUNCHES
    out = _output(f1, f2, md)
    if out.numel():
        p = _plan_sm90(*f1.shape, f1.dtype, _alignment(f1, f2))
        _launch("islam_corr_fwd_sm90", f1, f2, out,
                (p.vec, p.tw, p.ry, p.ndy, p.ns, p.cc, *p.grid, p.block,
                 p.smem))
        LAUNCHES += 1
    return out


def correlation_81_cuda(f1: torch.Tensor, f2: torch.Tensor,
                        md: int = MD_DEFAULT) -> torch.Tensor:
    """The 81-sums-a-thread kernel (``csrc/correlation.cu``)."""
    global LAUNCHES_81
    out = _output(f1, f2, md)
    if out.numel():
        _launch("islam_corr_fwd", f1, f2, out)
        LAUNCHES_81 += 1
    return out


def correlation_all_cuda(f1: torch.Tensor, f2: torch.Tensor,
                         md: int = MD_DEFAULT) -> torch.Tensor:
    """The all-shift tensor-core kernel (``csrc/correlation_all_sm90.cu``)."""
    global LAUNCHES_ALL
    out = _output(f1, f2, md)
    if out.numel():
        p = _plan_all_sm90(*f1.shape, f1.dtype, _alignment(f1, f2))
        _launch("islam_corr_fwd_all_sm90", f1, f2, out,
                (p.vec, p.ry, p.ns, p.kc, *p.grid, p.block, p.smem))
        LAUNCHES_ALL += 1
    return out


def correlation_all_dy_cuda(f1: torch.Tensor, f2: torch.Tensor,
                            md: int = MD_DEFAULT) -> torch.Tensor:
    """The one-dy-per-block kernel (``csrc/correlation_dy.cu``)."""
    global LAUNCHES_ALL_DY
    out = _output(f1, f2, md)
    if out.numel():
        _launch("islam_corr_fwd_dy", f1, f2, out)
        LAUNCHES_ALL_DY += 1
    return out


class CorrelationFn(torch.autograd.Function):
    """Forward: a CUDA kernel by dtype.  Backward: ``correlation_backward``.

    float32 goes to ``correlation_cuda`` and bfloat16 to
    ``correlation_all_cuda``: both compute this function, and in bfloat16
    the all-shift kernel's tensor-core sums beat the main kernel's at all
    five levels of a 448x640, B=8 VO forward (PERF.md §6)."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
        if f1.dtype == torch.bfloat16:
            return correlation_all_cuda(f1, f2, md)
        return correlation_cuda(f1, f2, md)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1, df2 = correlation_backward(f1, f2, g, ctx.md)
        return df1, df2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                md: int = MD_DEFAULT) -> torch.Tensor:
    """Dispatch on the tensors' device: CPU -> plain version, CUDA -> kernel."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_reference(f1, f2, md)
    if f1.is_cuda:
        return CorrelationFn.apply(f1, f2, md)
    raise ValueError(f"no correlation for devices {f1.device}, {f2.device}")


def _forward_only(kernel, f1: torch.Tensor, f2: torch.Tensor,
                  md: int) -> torch.Tensor:
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_reference(f1, f2, md)
    if f1.is_cuda:
        return kernel(f1, f2, md)
    raise ValueError(f"no correlation for devices {f1.device}, {f2.device}")


def correlation_81(f1: torch.Tensor, f2: torch.Tensor,
                   md: int = MD_DEFAULT) -> torch.Tensor:
    """Forward only.  Dispatch on the tensors' device: CPU -> plain version,
    CUDA -> the 81-sums-a-thread kernel."""
    return _forward_only(correlation_81_cuda, f1, f2, md)


def correlation_all(f1: torch.Tensor, f2: torch.Tensor,
                    md: int = MD_DEFAULT) -> torch.Tensor:
    """Forward only.  Dispatch on the tensors' device: CPU -> plain version,
    CUDA -> the all-shift tensor-core kernel."""
    return _forward_only(correlation_all_cuda, f1, f2, md)


def correlation_all_dy(f1: torch.Tensor, f2: torch.Tensor,
                       md: int = MD_DEFAULT) -> torch.Tensor:
    """Forward only.  Dispatch on the tensors' device: CPU -> plain version,
    CUDA -> the one-dy-per-block kernel."""
    return _forward_only(correlation_all_dy_cuda, f1, f2, md)
