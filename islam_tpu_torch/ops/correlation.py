"""Local cost-volume correlation (PWC-Net), with a hand-written CUDA kernel.

Counterpart of ``islam_tpu/ops/correlation.py`` and of the Pallas kernel in
``islam_tpu/ops/pallas/correlation_kernel.py``.  The function, for
(B, C, H, W) inputs:

    out[b, (dy+md)*(2md+1) + (dx+md), y, x]
        = (1/C) * sum_c f1[b, c, y, x] * pad_md(f2)[b, c, y+dy, x+dx]

with ``f2`` zero-padded by ``md`` on both spatial axes, the sum taken in f32
and the output in ``f1.dtype``.

- ``correlation_reference``: the plain PyTorch version (81 shifted products).
  CPU tensors use it, and ``chip_smoke.py`` holds the kernel against it.
- ``correlation_cuda``: launches ``csrc/correlation.cu`` (md = 4, f32 or
  bf16).  The library is compiled with ``nvcc`` for sm_90a at first use into
  ``islam_tpu_torch/_build/`` and loaded with ``ctypes``; importing this
  module compiles and loads nothing.  ``LAUNCHES`` counts its launches.
- ``CorrelationFn``: the autograd Function whose forward is the kernel and
  whose backward is the shifted-product formula in plain torch ops (the TPU
  side has no backward kernel either).
- ``correlation``: the dispatcher.  It follows the tensors' device: CPU goes
  to the plain version, CUDA to the kernel, and anything the kernel does not
  take raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

MD_DEFAULT = 4

# Kernel launches since import (or since the caller last set it to 0).
LAUNCHES = 0

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "correlation.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


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


def build_library() -> Path:
    """Compile ``csrc/correlation.cu`` (once per source content) and return
    the shared library's path.  ptxas's report (registers, shared memory,
    spills) is kept beside it as ``<library>.ptxas.txt``."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libcorrelation_{digest}.so"
    if lib.exists():
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    Path(f"{lib}.ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


def load_library():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.islam_corr_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     md: int = MD_DEFAULT) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of ``f1``'s device."""
    global LAUNCHES
    if md != MD_DEFAULT:
        raise ValueError(f"the correlation kernel is built for md=4, got {md}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two (B, C, H, W) tensors of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(f"need float32 or bfloat16 inputs of one dtype, got "
                        f"{f1.dtype} and {f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the correlation kernel needs contiguous inputs")
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError(f"need both inputs on one CUDA device, got "
                         f"{f1.device} and {f2.device}")
    B, C, H, W = f1.shape
    out = torch.empty((B, (2 * md + 1) ** 2, H, W), dtype=f1.dtype,
                      device=f1.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    rc = load_library().islam_corr_fwd(
        f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
        1.0 / C, _DTYPES[f1.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
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
