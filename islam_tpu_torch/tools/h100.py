"""The NVIDIA H100's peak rates, in one place, and what a measurement
prints beside them.

Source: NVIDIA's H100 SXM5 datasheet, dense rates (no sparsity) at the
700 W power limit.  A card set below that limit runs slower under load, so
every tool prints ``nvidia-smi``'s name and power limit (``card_line``)
beside its numbers.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
# Dense peaks by the type the work runs in.  TF32 is the float32 tensor-core
# rate, and applies only where cuDNN or cuBLAS may use it (``tf32_flags``).
PEAK_FLOP_PER_S = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}


def peak_flop_per_s(dtype: torch.dtype, tf32: bool = False) -> float:
    """The dense peak for work in ``dtype``: float32 at the TF32 rate only
    with ``tf32``."""
    if dtype == torch.bfloat16:
        return PEAK_FLOP_PER_S["bfloat16"]
    if dtype == torch.float32:
        return PEAK_FLOP_PER_S["tf32" if tf32 else "float32"]
    raise ValueError(f"no H100 peak for {dtype}")


def tf32_flags() -> dict:
    """Whether cuDNN and cuBLAS may run float32 work in TF32."""
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of the first card; raises if ``nvidia-smi`` fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_card(tool: str) -> None:
    """Raise unless a CUDA device is there: a timing tool never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; it times the card only")
