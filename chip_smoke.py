#!/usr/bin/env python3
"""Smoke run of the islam_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line, in order:

1. device      - the card (torch and nvidia-smi), TF32 turned off for cuDNN
                 and matmul so every number below is a float32 number.
2. build       - nvcc builds the correlation kernel from the checkout.
3. kernels     - the kernel against its plain PyTorch version at the five
                 shapes one 448x640, B=8 VO forward gives it (plus the 7x10
                 partial tile at B=1), in f32 and bf16; times at the five
                 shapes (CUDA events, L2 flushed, median of 21) beside the
                 bound and the plain version's time.
4. slice_small - the eval-only path at 64x128, B=2, 2 windows, once on cuda
                 and once on cpu with one state dict: outputs must agree and
                 the kernel must launch 5 times per window on cuda only.
5. slice_full  - the real entry point, ``islam_tpu_torch.train.main
                 --eval-only`` at 448x640, B=8, 25 frames (3 windows): finite
                 trajectories, 15 kernel launches, window time, peak memory.

Then a ``{"kernels": [...]}`` summary line, the nvidia-smi name/power-limit
line, and ``{"ok": true, "device": {...}}`` as the last line.  Any failure
raises, and the exit code is not 0; so is it without a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from islam_tpu_torch import train
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.ops import correlation as corr

# (B, C, H, W) of the five correlation calls of one 448x640, B=8 VO forward
SLICE_SHAPES = [(8, 196, 7, 10), (8, 128, 14, 20), (8, 96, 28, 40),
                (8, 64, 56, 80), (8, 32, 112, 160)]
CHECK_SHAPES = SLICE_SHAPES + [(1, 8, 7, 10)]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
PRESET = ["--loss-weight", "(1,0.1,10,0.1)", "--rot-w", "1",
          "--trans-w", "0.1"]
# cuda vs cpu on the small slice: both sides are float32 (TF32 off), but
# cuDNN and oneDNN pick different convolution algorithms and sum in other
# orders (~1e-6 relative per layer); over ~80 layers of random weights and
# the LM solve that reaches ~1e-5 on unit-scale poses, so 1e-3 leaves room
# without hiding a wrong kernel (whose errors are O(0.1)).  PVGO velocities
# are pinned only to ~1e-3 in float32 (their factors weigh 0.1 at dt 0.1 s,
# so an LM trial along them is accepted or rejected on a cost tie; see
# tests/test_torch_slice.py): 2e-3.
SMALL_ATOL = {"vo_motions": 1e-3, "pgo_poses": 1e-3, "pgo_vels": 2e-3}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def pyramid_pair(shape, dtype, gen):
    """f1, f2 as the shared pyramid gives them: batch slices of B+1 frames."""
    B, C, H, W = shape
    pyr = torch.randn((B + 1, C, H, W), generator=gen, device="cuda")
    pyr = pyr.to(dtype)
    return pyr[:-1], pyr[1:]


def bound_ms(shape, itemsize):
    B, C, H, W = shape
    nbytes = (2 * B * C * H * W + B * 81 * H * W) * itemsize
    flops = 2 * 81 * B * C * H * W
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_ms(fn, flush, reps=21, warmup=3):
    """Median device time of ``fn`` with the L2 cache flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32}})
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = corr.build_library()
    corr.load_library()
    seconds = time.perf_counter() - t0
    with open(f"{lib}.ptxas.txt") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "library": os.path.relpath(lib), "ptxas": ptxas})


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for shape in CHECK_SHAPES:
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            f1, f2 = pyramid_pair(shape, dtype, gen)
            out = corr.correlation_cuda(f1, f2)
            torch.cuda.synchronize()
            ref = corr.correlation_reference(f1, f2)
            if out.dtype != dtype or out.shape != ref.shape:
                raise AssertionError((shape, out.dtype, tuple(out.shape)))
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            checks.append({"shape": shape, "dtype": str(dtype)[6:],
                           "max_abs_err": err, "max_abs_ref": scale,
                           "tol": rel * scale})
            if not err <= rel * scale:
                raise AssertionError(f"correlation kernel disagrees: {checks[-1]}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    timing = []
    for shape in SLICE_SHAPES:
        f1, f2 = pyramid_pair(shape, torch.float32, gen)
        b_ms, b_by = bound_ms(shape, 4)
        timing.append({
            "shape": shape,
            "ms": time_ms(lambda: corr.correlation_cuda(f1, f2), flush),
            "plain_ms": time_ms(lambda: corr.correlation_reference(f1, f2),
                                flush),
            "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": "kernels", "status": {"correlation_fwd": "ok"},
          "checks": checks, "timing_f32": timing, "library_ms": None,
          "library_note": "no single PyTorch call computes the "
                          "81-displacement local correlation"})
    return checks, timing


def _run_small(device, state_dict=None):
    args = get_args(["--eval-only", "--image-height", "64", "--image-width",
                     "128", "--batch-size", "2", "--synthetic-frames", "5",
                     "--device", device, "--print-interval", "0", *PRESET])
    ds = SyntheticTrajDataset(num_frames=5, height=64, width=128,
                              transform=train.make_transform(64, 128))
    trainer = train.Trainer(args, ds, device=device, state_dict=state_dict)
    before = corr.LAUNCHES
    traj = trainer.run_epoch(0)
    torch.cuda.synchronize()
    return trainer, traj, corr.LAUNCHES - before


def phase_slice_small():
    gpu, gtraj, glaunch = _run_small("cuda")
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    _, ctraj, claunch = _run_small("cpu", sd)
    diffs = {}
    for name in ("vo_motions", "pgo_poses", "pgo_vels"):
        a = np.stack(getattr(gtraj, name))
        b = np.stack(getattr(ctraj, name))
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError((name, a.shape, b.shape))
        diffs[name] = float(np.abs(a - b).max())
    emit({"phase": "slice_small", "windows": 2, "launches_cuda": glaunch,
          "launches_cpu": claunch, "max_abs_diff": diffs,
          "atol": SMALL_ATOL})
    if glaunch != 10 or claunch != 0:
        raise AssertionError(f"launches cuda={glaunch} cpu={claunch}, "
                             "want 10 and 0")
    bad = {k: v for k, v in diffs.items() if not v <= SMALL_ATOL[k]}
    if bad:
        raise AssertionError(f"cuda and cpu disagree: {bad}")


def phase_slice_full(smi):
    """The main path: counts are set to 0 just before and read just after."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        corr.LAUNCHES = 0
        trainer = train.main([
            "--eval-only", "--data-type", "synthetic", "--image-height",
            "448", "--image-width", "640", "--batch-size", "8",
            "--synthetic-frames", "25", "--device", "cuda",
            "--result-dir", tmp, *PRESET])
        launches = corr.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        rows = {}
        for name in ("vo_pose", "pgo_pose", "imu_pose"):
            r = np.loadtxt(os.path.join(tmp, "0", f"{name}.txt"))
            if r.shape != (25, 7) or not np.isfinite(r).all():
                raise AssertionError((name, r.shape))
            rows[name] = r.shape[0]
    secs, prep = trainer.window_seconds, trainer.prep_seconds
    emit({"phase": "slice_full", "windows": len(secs), "launches": launches,
          "pose_rows": rows, "first_window_ms": secs[0] * 1e3,
          "window_ms_median_after_first": statistics.median(secs[1:]) * 1e3,
          "window_ms": [s * 1e3 for s in secs],
          "host_prep_ms": [s * 1e3 for s in prep],
          "peak_mem_bytes": peak, "card": smi})
    if launches != 15:
        raise AssertionError(f"{launches} kernel launches on the main path, "
                             "want 15 (5 per window)")
    return launches


def main():
    smi = phase_device()
    phase_build()
    checks, timing = phase_kernels()
    phase_slice_small()
    launches = phase_slice_full(smi)
    emit({"kernels": [{
        "name": "correlation_fwd", "route": "cuda",
        "source": "islam_tpu_torch/csrc/correlation.cu",
        "replaces": "islam_tpu/ops/pallas/correlation_kernel.py:38",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["dtype"] == "float32"),
        # one VO forward: the five slice shapes, one launch each
        "ms": sum(t["ms"] for t in timing),
        "plain_ms": sum(t["plain_ms"] for t in timing),
        "bound_ms": sum(t["bound_ms"] for t in timing),
        "bound_by": ("bytes" if all(t["bound_by"] == "bytes" for t in timing)
                     else "operations"),
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
