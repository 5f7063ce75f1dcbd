"""Where the time and the memory of a window go, on the card.

    python -m islam_tpu_torch.profile_window [--epoch 0|1|2] [--trace DIR]
        [--bilevel detached|implicit|unrolled] [--reproj-points N]
        [--frozen-bn-eval] [--bf16] [--scan-chunk K]

Builds the Trainer as ``train.main`` does at the preset's full width
(448x640, B=8, 25 synthetic frames: 3 windows; preset flags, seed-0
weights and, for the training epochs, a seed-1 denoiser).  ``--epoch`` picks
the schedule's epoch: 0 is the eval-only pass (the default), 1 a 'vo' epoch,
2 an 'imu' epoch (which replays epoch 1's motions).  It runs epochs 1..N
(or 0) once to warm up, then epoch N once more under ``torch.profiler``,
and prints one JSON object: per-window wall time, host sample-preparation
time and backward time, the profiled epoch's correlation kernel launches
(5 per window where the VO forward runs: epochs 0 and 1), device kernel
time per window and its top kernels, the device's idle share of the
window, and the peak memory of each network of the VO forward on one
window's batch.  ``--bilevel``, ``--reproj-points``, ``--frozen-bn-eval``,
``--bf16`` and ``--scan-chunk`` go to the Trainer as ``train.main`` takes
them (flow and stereo are frozen, as in the presets); with ``--bf16`` the
correlation launches are the all-shift kernel's, and the network peaks are
measured in bfloat16.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from islam_tpu_torch import train
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.denoiser import init_denoiser
from islam_tpu_torch.ops import correlation as corr

HEIGHT, WIDTH, BATCH, FRAMES = 448, 640, 8, 25
TOP = 15  # kernels listed


def _peak_bytes(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def warm_up(trainer, epoch):
    """Runs epochs 1..``epoch`` (or epoch 0) once: cuDNN plans, the kernel
    build, the caches and, for an 'imu' epoch, epoch 1's motions.  The
    Trainer replays cached motions in every epoch but a 'vo' one, so for
    epoch 0 they are dropped again: the profiled eval epoch runs the VO
    forward, as ``--eval-only`` does."""
    for e in range(1, epoch + 1) if epoch else [0]:
        trainer.run_epoch(e)
    if not epoch:
        trainer.prev_vo_motions = None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epoch", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--trace", default="",
                   help="also write a chrome trace into this directory")
    p.add_argument("--bilevel", default="detached",
                   choices=["detached", "implicit", "unrolled"])
    p.add_argument("--reproj-points", type=int, default=0)
    p.add_argument("--frozen-bn-eval", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--scan-chunk", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_window: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    flags = [
        "--data-type", "synthetic", "--image-height", str(HEIGHT), "--image-width", str(WIDTH),
        "--batch-size", str(BATCH), "--synthetic-frames", str(FRAMES),
        "--print-interval", "0", "--device", "cuda",
        "--loss-weight", "(1,0.1,10,0.1)", "--rot-w", "1", "--trans-w", "0.1",
        "--fix-model-parts", "flow", "stereo", "--bilevel", a.bilevel,
        "--reproj-points", str(a.reproj_points),
        "--scan-chunk", str(a.scan_chunk)]
    if a.frozen_bn_eval:
        flags += ["--frozen-bn-eval"]
    if a.bf16:
        flags += ["--bf16"]
    with tempfile.TemporaryDirectory() as tmp:
        if a.epoch:
            pkl = os.path.join(tmp, "denoiser.pkl")
            torch.save(init_denoiser(1, "cpu").state_dict(), pkl)
            flags += ["--imu-denoise-model-name", pkl]
        else:
            flags += ["--eval-only"]
        ds = SyntheticTrajDataset(
            num_frames=FRAMES, height=HEIGHT, width=WIDTH,
            transform=train.make_transform(HEIGHT, WIDTH))
        trainer = train.Trainer(get_args(flags), ds, device="cuda")
    warm_up(trainer, a.epoch)
    launches = corr.LAUNCHES + corr.LAUNCHES_ALL
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        trainer.run_epoch(a.epoch)
    launches = corr.LAUNCHES + corr.LAUNCHES_ALL - launches
    if a.trace:
        prof.export_chrome_trace(
            f"{a.trace}/epoch{a.epoch}_window_trace.json")
    windows = trainer.window_seconds[a.epoch]
    prep = trainer.prep_seconds[a.epoch]
    backward = trainer.backward_seconds[a.epoch]
    n = len(windows)

    kernels = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key][0] += e.self_device_time_total / 1e3  # us -> ms
            kernels[e.key][1] += e.count
    device_ms = sum(v[0] for v in kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]

    # Peak memory of each network on one window's batch.
    batch = train.device_batch(
        collate([ds[i] for i in range(BATCH)]), 0, "cuda")
    nchw = {k: v.permute(0, 3, 1, 2).contiguous() for k, v in batch.items()
            if k in ("img0", "img1", "img0_norm", "img0_r_norm", "frames",
                     "intrinsic")}
    m = trainer.model
    dtype = torch.bfloat16 if a.bf16 else torch.float32
    m = m.to(dtype)
    nchw = {k: v.to(dtype) for k, v in nchw.items()}
    flow = torch.zeros((BATCH, 2, HEIGHT // 4, WIDTH // 4), dtype=dtype,
                       device="cuda")
    peaks = {
        "flowNet": _peak_bytes(lambda: m.flowNet(nchw["frames"],
                                                 shared_frames=True)),
        "stereoNet": _peak_bytes(lambda: m.stereoNet(torch.cat(
            [nchw["img0_norm"], nchw["img0_r_norm"]], dim=1))),
        "flowPoseNet": _peak_bytes(lambda: m.flowPoseNet(torch.cat(
            [flow, nchw["intrinsic"]], dim=1))),
    }

    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "epoch": a.epoch, "target": trainer.train_target[a.epoch],
        "shape": [BATCH, HEIGHT, WIDTH], "windows": n,
        "bilevel": a.bilevel, "reproj_points": a.reproj_points,
        "frozen_bn_eval": trainer.frozen_bn_eval, "bf16": a.bf16,
        "scan_chunk": a.scan_chunk,
        "correlation_launches": launches,
        "reproj_pixels": trainer.reproj_pixels[a.epoch],
        "chunk_ms": [c * 1e3 for c in trainer.chunk_seconds[a.epoch]],
        "window_ms": [w * 1e3 for w in windows],
        "window_ms_median": statistics.median(windows) * 1e3,
        "host_prep_ms": [w * 1e3 for w in prep],
        "backward_ms": [w * 1e3 for w in backward],
        "device_kernel_ms_per_window": device_ms,
        "device_idle_share": 1.0 - device_ms / (statistics.mean(windows) * 1e3),
        "top_kernels_ms_per_window": [
            {"name": k[:120], "ms": v[0] / n, "calls": v[1] / n}
            for k, v in top],
        "peak_bytes_per_network": peaks,
    }), flush=True)


if __name__ == "__main__":
    main()
