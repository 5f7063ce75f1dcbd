"""Local cost-volume correlation (PWC-Net), with two hand-written CUDA kernels.

Counterpart of ``islam_tpu/ops/correlation.py`` and of the Pallas kernels in
``islam_tpu/ops/pallas/correlation_kernel.py``.  The function, for
(B, C, H, W) inputs:

    out[b, (dy+md)*(2md+1) + (dx+md), y, x]
        = (1/C) * sum_c f1[b, c, y, x] * pad_md(f2)[b, c, y+dy, x+dx]

with ``f2`` zero-padded by ``md`` on both spatial axes, the sum taken in f32
and the output in ``f1.dtype``.

- ``correlation_reference``: the plain PyTorch version (81 shifted products).
  CPU tensors use it, and ``chip_smoke.py`` holds both kernels against it.
- ``correlation_cuda``: launches ``csrc/correlation.cu`` (the port of
  ``_corr_dy_kernel``; all 81 sums of a pixel in one thread), the main
  path's kernel.  ``LAUNCHES`` counts its launches.
- ``correlation_all_cuda``: launches ``csrc/correlation_dy.cu`` (the port of
  ``_corr_all_kernel``; one row shift per block, 9 sums a thread).
  ``LAUNCHES_ALL`` counts its launches.  Only ``bench_corr`` calls it.
- Both take md = 4 and f32 or bf16.  Each library is compiled with ``nvcc``
  for sm_90a at first use into ``islam_tpu_torch/_build/`` and loaded with
  ``ctypes``; importing this module compiles and loads nothing.
- ``CorrelationFn``: the autograd Function whose forward is the main path's
  kernel and whose backward is the shifted-product formula in plain torch
  ops (the TPU side has no backward kernel either).
- ``correlation`` and ``correlation_all``: the dispatchers.  They follow the
  tensors' device: CPU goes to the plain version, CUDA to the kernel, and
  anything the kernel does not take raises.  There is no fallback.
  ``correlation_all`` is forward-only, as ``_corr_fwd_all`` is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

MD_DEFAULT = 4

# Kernel launches since import (or since the caller last set them to 0):
# ``correlation_cuda``'s and ``correlation_all_cuda``'s.
LAUNCHES = 0
LAUNCHES_ALL = 0

_PKG = Path(__file__).resolve().parents[1]
# C entry point -> source; one shared library per source
SOURCES = {"islam_corr_fwd": _PKG / "csrc" / "correlation.cu",
           "islam_corr_fwd_dy": _PKG / "csrc" / "correlation_dy.cu"}
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


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
            out: torch.Tensor) -> None:
    """Launch ``symbol`` on the current stream of ``f1``'s device."""
    B, C, H, W = f1.shape
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    rc = load_kernel(symbol)(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
        1.0 / C, _DTYPES[f1.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     md: int = MD_DEFAULT) -> torch.Tensor:
    """The main path's kernel (``csrc/correlation.cu``)."""
    global LAUNCHES
    out = _output(f1, f2, md)
    if out.numel():
        _launch("islam_corr_fwd", f1, f2, out)
        LAUNCHES += 1
    return out


def correlation_all_cuda(f1: torch.Tensor, f2: torch.Tensor,
                         md: int = MD_DEFAULT) -> torch.Tensor:
    """The one-dy-per-block kernel (``csrc/correlation_dy.cu``)."""
    global LAUNCHES_ALL
    out = _output(f1, f2, md)
    if out.numel():
        _launch("islam_corr_fwd_dy", f1, f2, out)
        LAUNCHES_ALL += 1
    return out


class CorrelationFn(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: ``correlation_backward``."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
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


def correlation_all(f1: torch.Tensor, f2: torch.Tensor,
                    md: int = MD_DEFAULT) -> torch.Tensor:
    """Forward only.  Dispatch on the tensors' device: CPU -> plain version,
    CUDA -> the one-dy-per-block kernel."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_reference(f1, f2, md)
    if f1.is_cuda:
        return correlation_all_cuda(f1, f2, md)
    raise ValueError(f"no correlation for devices {f1.device}, {f2.device}")
