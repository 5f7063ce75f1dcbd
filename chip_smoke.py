#!/usr/bin/env python3
"""Smoke run of the islam_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line, in order:

1. device      - the card (torch and nvidia-smi), TF32 turned off for cuDNN
                 and matmul so every number below is a float32 number.
2. build       - nvcc builds the four correlation kernels from the
                 checkout, one nvcc per source, started together, and prints
                 each kernel's registers and spills (ptxas); a spill fails.
3. kernels     - the four kernels against their plain PyTorch version (and
                 each other) at the five shapes one 448x640, B=8 VO forward
                 gives them, the 7x10 partial tile at B=1, an odd shape, C
                 below one chunk, and the batch slices of a shared pyramid
                 at storage offsets that are not 16-byte aligned, in f32 and
                 bf16; and two launches of the main path's kernel, and of
                 the all-shift tensor-core kernel, on the same inputs must
                 agree bitwise.
4. bench_corr  - the port of scripts/bench_corr.py: the four kernels and
                 the plain version timed at the five levels in f32 and bf16
                 (CUDA events, L2 flushed, median of 21), beside the bound;
                 each kernel must launch there.
5. slice_small - the eval-only path at 64x128, B=2, 2 windows, once on cuda
                 and once on cpu with one state dict: outputs must agree and
                 the kernel must launch 5 times per window on cuda only.
6. train_small - 'vo' then 'imu' epochs (SGD for the pose head) at 64x128,
                 B=2, 2 windows, on cuda and on cpu from one state dict and
                 one seed-1 denoiser .pkl: gradients, updated parameters and
                 trajectories must agree; launches 10/0 on cuda, 0 on cpu.
7. slice_full  - ``islam_tpu_torch.train.main --eval-only`` at 448x640, B=8,
                 25 frames (3 windows): finite trajectories, 15 launches
                 of the main path's kernel and none of the other three,
                 window time, peak memory.
8. train_full  - ``islam_tpu_torch.train.main`` at the same preset with
                 ``--train-epoch 2``: a 'vo' and an 'imu' epoch of 3 windows;
                 finite snapshots of both, 15/0 launches (none of the other
                 three kernels), the pose head moved by epoch 1 only and the
                 denoiser by epoch 2 only; window, host-prep and backward
                 times and peak memory.
9. kitti_full  - the presets' path on recorded sequences: a KITTI raw
                 drive written with ``image_io.write_png`` (26 frames at
                 1226x370, the 2011_09_30 calibration, OXTS at 100 Hz), a
                 full VONet .pkl (seed 0) and a pose-only .pkl (seed 2,
                 keys without the ``flowPoseNet.`` prefix).  Run 1:
                 ``main --data-type kitti`` with both .pkls, the denoiser,
                 ``--save-model-dir``, ``--worker-num 2``, ``--fix-model-parts
                 flow stereo`` and ``--train-epoch 2`` at 448x640, B=8:
                 the loaded parameters equal the .pkls bitwise, 15/0
                 launches, finite snapshots, models/1 and models/2.  Run 2:
                 ``--start-epoch 3 --train-epoch 3`` restores models/2
                 bitwise, then runs a 'vo' epoch.  ``evaluate.main`` gives
                 finite ATE and RPE for every epoch and kind.  Then eval
                 runs without and with the prefetch thread, in turns.  It
                 prints window ms, the main thread's wait, the preparation
                 split (decode, transforms, copy), decode ms per image and
                 peak memory.  Last, an eval run whose ground-truth
                 positions must start at 0 (the first OXTS packet is the
                 origin) and whose first window's IMU trajectory must stay
                 within 1 cm of them; it prints the worst distance.
10. bilevel_small - ``--bilevel implicit`` and ``unrolled`` with
                 ``--reproj-points 1 --frozen-bn-eval --fix-model-parts flow
                 stereo`` at 64x128, B=2: a 'vo' and an 'imu' epoch on cuda
                 and on cpu from one state dict (constant flow and disparity
                 heads, so the reprojection mask has pixels; random BatchNorm
                 running stats): losses, gradients, updated parameters and
                 trajectories must agree, launches 10/0 on cuda; and the
                 implicit 'vo' gradient must differ from the detached one.
11. bilevel_full - on kitti_full's drive at 448x640, B=8, with the same
                 flags and kitti_full's VONet .pkl with the constant heads
                 and running stats of bilevel_small: a 'vo' epoch in
                 detached mode, ``--train-epoch 2`` in implicit mode, a 'vo'
                 epoch in unrolled mode.  Per window:
                 window and backward ms and the reprojection factor's
                 masked pixels; peak memory and launches per run.  15
                 launches per 'vo' epoch and 0 in 'imu', the pose head moved
                 by 'vo' epochs only and the denoiser by 'imu' only, finite
                 snapshots, and a nonempty reprojection mask in at least one
                 window.
12. bf16_small - ``--bf16`` at 64x128, B=2: the eval path and a 'vo' epoch
                 on cuda and on cpu from one state dict: trajectories and
                 gradients must agree within the bfloat16 bounds below; on
                 cuda every correlation is the all-shift kernel's (5 per VO
                 forward) and the main kernel launches 0 times.
13. bf16_full  - ``main --eval-only --bf16`` and ``main --train-epoch 2
                 --bf16`` at 448x640, B=8 (slice_full's and train_full's
                 runs in bfloat16): window ms, peak bytes and launches
                 beside the float32 runs, and the bfloat16-vs-float32 gap of
                 the eval motions at the same weights (reported).
14. scan_full  - on kitti_full's drive (3 windows) at 448x640, B=8: a 'vo'
                 and an 'imu' epoch with ``--scan-chunk 2`` (one chunk, one
                 tail window) against the same epochs window by window in
                 the same call (motions, the pose head after the update,
                 the denoiser, pgo_pose.txt); the same for one implicit
                 'vo' epoch; one 'vo' epoch with ``--scan-chunk 2 --bf16``.
                 Every ``train_scan`` call runs under
                 ``torch.cuda.set_sync_debug_mode("error")``, so a host
                 sync inside a chunk fails the phase.  Chunk ms.
15. profile_dir - ``main --profile-dir`` (eval, 64x128) writes a Chrome
                 trace of the second window that holds kernels of the card.
16. variants_small - the front-end variants at 64x128, B=2, on cuda and on
                 cpu with one state dict each: ``PWCDCNet(uncertainty=True)``
                 (flows and uncertainties), the VO forward with the default
                 and the concat-free decoder (and the two against each
                 other), ``TartanVO.__call__`` with a given scale and with
                 a TartanAir fixture's precomputed flow, ``pred_flow`` and
                 ``join_flow``, both PSMNets (maxdisp 16, running stats of
                 one batch) and
                 ``VOFlowRes`` stereo 2.1 and 2.2.  Every output within
                 1e-3 of its scale; 5 main-kernel launches per PWC forward
                 on cuda, 0 on cpu.
17. variants_full - the same at 448x640, B=8, seed-0 weights, each item's
                 CUDA-event ms (median of 5 after a warm-up), peak bytes
                 (reset before it) and launches per call: the uncertainty
                 PWC; the VO forward, default and concat-free, in float32
                 and bf16 (concat-free held to the default); a 480x640
                 TartanAir folder with flow and depth .npy read by
                 ``TrajFolderDataset(load_flow=True, load_depth=True)``,
                 ``TartanVO.__call__`` with its flow and with a given scale,
                 ``pred_flow`` over 3 steps, ``join_flow`` and ``visflow``;
                 both PSMNets at maxdisp 192 (the stacked one in eval and
                 training mode); ``VOFlowRes`` 2.1 and 2.2 on
                 (8, 6, 112, 160).  Every output finite.
18. parallel_small - ``parallel.MultiSequenceTrainer`` at 64x128, B=2, on
                 2 synthetic sequences (seeds 0 and 1, sequence 1 on its own
                 calibration), one process on cuda (NCCL, one rank) and on
                 cpu (gloo, one rank) from one state dict and the seed-1
                 denoiser: a 'vo' then an 'imu' epoch; losses, gradients,
                 updated parameters and each sequence's snapshots agree
                 within train_small's bounds; main-kernel launches 20/0 on
                 cuda (5 per VO forward per sequence), 0 on cpu.
19. parallel_full - the same two sequences at 25 frames, 448x640, B=8,
                 seed-0 VO weights, NCCL with one rank, cuDNN's
                 deterministic algorithms: epochs 0, 1 ('vo') and 2
                 ('imu'), then a fresh trainer's ``scan_chunk=2`` epoch 1
                 (one chunk, one tail window) against the per-window one, a
                 save after epoch 2 resumed bitwise, and each sequence's
                 epoch-1 pgo_pose against the single-sequence ``Trainer``
                 on it alone (1e-3); a fresh per-window epoch 1 after the
                 scan, whose motions must equal the scan's bitwise.  Window
                 and backward ms per epoch (both sequences, device synced),
                 each window's collective ms and bytes, peak bytes, launches
                 30/30/0 (150 in the phase).
20. parallel_procs - ``python -m islam_tpu_torch.validate_multihost
                 --device cuda --bf16`` at 448x640, B=8: two processes on
                 the one card over gloo, 2 sequences each: one 'vo' step
                 and one Adam step, then ``MultiSequenceTrainer`` epochs 1
                 ('vo') and 2 ('imu'), a window each, a save on rank 0 and
                 a bitwise resume on both; the ranks' gradient checksums,
                 window losses and updated parameters bitwise equal, losses
                 and gradients finite, 10 all-shift launches a rank in the
                 step and 10/0 in the epochs.  Wall time, collective ms and
                 bytes, launches per rank.
21. pvgo_replica - random PVGO problems from seeds (``testing.pvgo_problem``,
                 the CPU tests' generators; one saturated as atan(3 r), whose
                 steps reject trials): ``lm_solve_trace`` in float64
                 and the graphed detached solve (``lm_solve_graphed``) in
                 float64 and float32 on cuda against the port's numpy
                 replica of PyPose's LM (``pvgo/pypose_replica.py``), at
                 tests/test_torch_pypose_replica.py's tolerances: step
                 counts and patience exact, cost rtol 1e-5, radius rtol
                 1e-9, translations and velocities 5e-6, |<q, q_ref>|
                 within 1e-9 of 1; float32 solutions of the unsaturated
                 problems 2e-3.  The worst differences.
22. imperative_full - ``demo_imperative.run_study`` (the imperative study)
                 at 448x640, B=8, 33 frames (4 windows), Adam at 1e-4,
                 from one seed-0 init: float32 detached and bf16 detached 4
                 epochs each, bf16 implicit and unrolled 2 epochs each.
                 Every record, each epoch's wall and window seconds, peak
                 bytes and each run's launches: 20 a 'vo' epoch of the
                 main kernel in float32 and of the all-shift kernel in
                 bf16, 0 of the other, 0 in 'imu' epochs (replay).  Every
                 record finite, PVGO's ATE below raw VO's in every epoch;
                 the learning signal and the bf16-vs-f32 gaps printed.
23. keypoints_full - ``ops.dense_ba.detect_keypoints`` (the port's SIFT,
                 ``ops/sift.py``) on B=8 frames of ``testing.make_dataset``
                 at 448x640, N=100, with and without a mask, on cuda and on
                 cpu: the two devices' raw detections agree at F1 >= 0.99
                 (distinct floored positions, a match within 1 px), every
                 masked point of the cuda run lies in the mask, and a
                 ``SparseReprojectionLoss`` on the card from those points
                 writes 8 ``debug`` overlays that decode to (448 x 4,
                 2 x 640 x 4, 3).  Keypoints a frame, the detector's ms
                 (CUDA events, median of 5 after a warm call; the scale
                 space alone; one call's device ms, kernel launches and top
                 kernels under torch.profiler) and debug's ms.
24. tools_full - the measurement tools (``islam_tpu_torch/tools/``).  The
                 FLOP count of one 'vo' ``train_step`` at 64x128, B=2 on
                 cuda equals the cpu count part by part, in f32 and bf16,
                 and of an 'imu' one in f32 (cuDNN's GRU and its backward,
                 and the graphed LM, counted by formula and op by op); at 448x640, B=8 on the card its JAX-rule count
                 is bench.py's 4.3359 TFLOPs within 1e-3, in bf16 and f32,
                 with ``model_tflops`` beside it.  The roofline
                 (``conv_roofline``) of the f32 and bf16 eval windows and
                 the f32 'vo' window: it must cover >= 50 % of each
                 window's device time, no f32 cuDNN kernel may say tf32,
                 the correlation must launch 5 times a VO forward, and
                 both correlation kernels must be rows; each window's MFU
                 over wall and over device time.  The copies (``copies``)
                 of the f32 eval window: the cost-volume concat among the
                 top rows by bytes, and gone with ``concat_free``.

Then a ``{"kernels": [...]}`` summary line, the nvidia-smi name/power-limit
line, and ``{"ok": true, "device": {...}}`` as the last line.  Any failure
raises, and the exit code is not 0; so is it without a CUDA device.
"""

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from islam_tpu_torch import (bench_corr, demo_imperative, evaluate, optim,
                             testing, train)
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.data import fixtures, image_io
from islam_tpu_torch.data.dataset import TrajFolderDataset, collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.denoiser import init_denoiser
from islam_tpu_torch.models import tartanvo as tvo
from islam_tpu_torch.models.layers import BatchNorm, init_weights_
from islam_tpu_torch.models import psmnet
from islam_tpu_torch.models.pwcnet import PWCDCNet
from islam_tpu_torch.models.voflownet import VOFlowRes
from islam_tpu_torch.ops import correlation as corr
from islam_tpu_torch.ops import dense_ba, sift
from islam_tpu_torch.parallel import mesh as pmesh
from islam_tpu_torch.parallel.trainer import MultiSequenceTrainer
from islam_tpu_torch.pvgo.lm import lm_solve_graphed, lm_solve_trace
from islam_tpu_torch.pvgo.pypose_replica import pypose_lm_replica
from islam_tpu_torch.tools import conv_roofline
from islam_tpu_torch.tools import copies as copy_tool
from islam_tpu_torch.tools import flops as flop_tool
from islam_tpu_torch.tools import window as tool_window
from islam_tpu_torch.utils import checkpoints as ckpt
from islam_tpu_torch.utils import visualization

# (B, C, H, W) of the five correlation calls of one 448x640, B=8 VO forward
SLICE_SHAPES = [(8, c, h, w) for c, h, w in bench_corr.LEVELS]
CHECK_SHAPES = SLICE_SHAPES + [(1, 8, 7, 10), (2, 37, 9, 13), (1, 3, 5, 7)]
# (B+1, C, H, W) pyramid whose [:-1] and [1:] are checked, as the flow net
# passes them: [1:] starts 315 elements in, 4- (f32) or 2-byte (bf16)
# aligned, so the kernel takes its 4-byte and 2-byte copies.
PYRAMID = (3, 5, 7, 9)
PRESET = ["--loss-weight", "(1,0.1,10,0.1)", "--rot-w", "1",
          "--trans-w", "0.1"]
FULL = ["--data-type", "synthetic", "--image-height", "448", "--image-width",
        "640", "--batch-size", "8", "--synthetic-frames", "25",
        "--device", "cuda", *PRESET]
SMALL = ["--data-type", "synthetic", "--image-height", "64", "--image-width",
         "128", "--batch-size", "2", "--synthetic-frames", "5",
         "--print-interval", "0", *PRESET]
# cuda vs cpu on the small slice: both sides are float32 (TF32 off), but
# cuDNN and oneDNN pick different convolution algorithms and sum in other
# orders (~1e-6 relative per layer); over ~80 layers of random weights and
# the LM solve that reaches ~1e-5 on unit-scale poses, so 1e-3 leaves room
# without hiding a wrong kernel (whose errors are O(0.1)).  PVGO velocities
# are pinned only to ~1e-3 in float32 (their factors weigh 0.1 at dt 0.1 s,
# so an LM trial along them is accepted or rejected on a cost tie; see
# tests/test_torch_slice.py): 2e-3.
SMALL_ATOL = {"vo_motions": 1e-3, "pgo_poses": 1e-3, "pgo_vels": 2e-3}
# train_small, cuda vs cpu.  Gradients: the same float32 sums in other
# orders, and cuDNN's GRU against the CPU's; the CPU tests against JAX hold
# them at 1e-3 x max|g| of the epoch, and so does this.  The SGD-updated
# pose head is p - lr g: lr x that atol, plus 2 ulp of the weights.  The
# denoiser's Adam step is ~lr x sign(g), and a gradient near 0 may flip its
# sign between the two devices: 2 x imu_lr.
GRAD_RTOL = 1e-3
SMALL_LR, IMU_LR = 1e-4, 3e-5
# The bi-level phases: the fifth factor at loss_weight[4] = 0.5, eval-mode
# BatchNorm in the frozen stereo net.  Their gradients pass through the PVGO
# solution, whose float32 velocities carry the cost tie above: the CPU tests
# hold them to JAX's at 2e-3 x max|g|, and so does bilevel_small.
BILEVEL = ["--reproj-points", "1", "--frozen-bn-eval", "--fix-model-parts",
           "flow", "stereo", "--loss-weight", "(1,0.1,10,0.1,0.5)"]
BILEVEL_GRAD_RTOL = 2e-3
# Window losses are sums of squared residuals of ~2e-2 ('vo') or less
# ('imu'), so the ~1e-5 by which cuda and cpu poses differ moves them by
# ~1e-3 relative: rtol 2e-2, and 2e-2 of the epoch's largest loss.  A wrong
# factor or coupling moves them by O(1) (the implicit and unrolled losses
# of one window differ 2x).
LOSS_RTOL = 2e-2
# bf16_small, cuda vs cpu in bfloat16: two bfloat16 stacks (cuDNN's and the
# CPU's convolutions) round at other places.  On the CPU, the bfloat16 run
# differs from the float32 one by 2.1e-4 in the VO motions, 2.4e-6 in the
# PVGO poses and 6.4 % of max|g| in the 'vo' gradient (cosine 0.996); two
# independent roundings are about 1.4x one, so: motions 5e-3, PVGO poses and
# velocities as in float32, gradients 0.2 x max|g| and a cosine of 0.95.
BF16_ATOL = {"vo_motions": 5e-3, "pgo_poses": 1e-3, "pgo_vels": 2e-3}
BF16_GRAD_RTOL, BF16_GRAD_COS = 0.2, 0.95
# keypoints_full: the detector on cuda against itself on cpu; the same
# float32 steps, summed in other orders (cuDNN's convolutions, atomic
# histogram sums), so a DoG value on a near-tie may flip an extremum
KEYPOINTS_F1 = 0.99
# scan_full: the scanned epoch against the per-window one, at
# tests/test_train_e2e.py's tolerances (motions 1e-5, pose head 1e-6,
# pgo_pose.txt 1e-4), with cuDNN's deterministic algorithms: by default it
# may pick others from run to run, and two per-window runs of the same
# epoch then differ by 5.1e-5 in the motions (on an H100).  The pose
# head trains with SGD here: Adam's first step is lr x sign(g), so a
# gradient entry near 0 that rounds to the other sign moves by 2 lr on any
# path.  The denoiser's Adam step: 2 x imu_lr, as train_small.
SCAN_ATOL = {"motions": 1e-5, "pose": 1e-6, "pgo_pose": 1e-4,
             "denoiser": 2 * 3e-5}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


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


def ptxas_report(text):
    """ptxas -v output -> [{kernel, registers, spill_bytes, static_smem}],
    one per compiled kernel (template instance), in build order."""
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'")[0]
        m = re.search(r"kernelI(f|13__nv_bfloat16)(?:Li(\d+)E)?E+vPK", name)
        if m:
            name = "<" + ("float" if m.group(1) == "f" else "bf16") + (
                f", {m.group(2)}>" if m.group(2) else ">")
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out.append({
            "kernel": name,
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", block)),
            "static_smem": int(smem.group(1)) if smem else 0})
    return out


def phase_build():
    t0 = time.perf_counter()
    libs = corr.build_all()
    for symbol in libs:
        corr.load_kernel(symbol)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for symbol, lib in libs.items():
        with open(f"{lib}.ptxas.txt") as f:
            ptxas[os.path.basename(corr.SOURCES[symbol])] = ptxas_report(
                f.read())
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})
    spills = {src: [k for k in ks if k["spill_bytes"]]
              for src, ks in ptxas.items()}
    if any(spills.values()) or not all(ptxas.values()):
        raise AssertionError(f"ptxas reports spills or no kernel: {ptxas}")


def _check_inputs(gen):
    for shape in CHECK_SHAPES:
        for dname, dtype in bench_corr.DTYPES.items():
            yield shape, dname, bench_corr.feature_pair(shape, dtype, gen,
                                                        "cuda")
    for dname, dtype in bench_corr.DTYPES.items():
        pyr = torch.randn(PYRAMID, generator=gen, device="cuda").to(dtype)
        yield f"{PYRAMID}[:-1], [1:]", dname, (pyr[:-1], pyr[1:])


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = bench_corr.kernels(torch.device("cuda"))
    checks, unequal = [], []
    for shape, dname, (f1, f2) in _check_inputs(gen):
        offset = f2.storage_offset() * f2.element_size()
        checks.append({"shape": shape, "dtype": dname,
                       "f2_offset_bytes": offset,
                       **bench_corr.check(f1, f2, fns, dname)})
        for fn in (corr.correlation_cuda, corr.correlation_all_cuda):
            if not torch.equal(fn(f1, f2), fn(f1, f2)):
                unequal.append((fn.__name__, shape, dname))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "status": {n: "ok" for n in fns},
          "bitwise_reproducible": {
              n: not any(u[0] == n for u in unequal)
              for n in ("correlation_cuda", "correlation_all_cuda")},
          "checks": checks})
    if unequal:
        raise AssertionError(f"two launches on the same inputs differ: "
                             f"{unequal}")
    return checks


def phase_bench_corr():
    """The bench path: counts are set to 0 just before and read just
    after."""
    _reset_counts()
    rows = bench_corr.run("cuda")
    launches = {"correlation": corr.LAUNCHES,
                "correlation_81": corr.LAUNCHES_81,
                "correlation_all": corr.LAUNCHES_ALL,
                "correlation_all_dy": corr.LAUNCHES_ALL_DY}
    emit({"phase": "bench_corr", "levels": rows,
          "total_per_forward": bench_corr.totals(rows),
          "launches": launches,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the "
                          "81-displacement local correlation"})
    idle = [n for n, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"bench_corr never launched {idle}")
    return rows, launches


def _reset_counts():
    corr.LAUNCHES = corr.LAUNCHES_81 = 0
    corr.LAUNCHES_ALL = corr.LAUNCHES_ALL_DY = 0


def _other_kernels_idle(phase, bf16=False):
    """The kernels a path must not launch: in float32 all but the main
    kernel, in bfloat16 all but the all-shift kernel."""
    others = {"correlation_81": corr.LAUNCHES_81,
              "correlation_all_dy": corr.LAUNCHES_ALL_DY}
    if bf16:
        others["correlation"] = corr.LAUNCHES
    else:
        others["correlation_all"] = corr.LAUNCHES_ALL
    if any(others.values()):
        raise AssertionError(f"{phase} launched {others}, want 0 of each")


def _run_small(device, state_dict=None):
    args = get_args(["--eval-only", "--device", device, *SMALL])
    ds = SyntheticTrajDataset(num_frames=5, height=64, width=128,
                              transform=train.make_transform(64, 128))
    trainer = train.Trainer(args, ds, device=device, state_dict=state_dict)
    before = corr.LAUNCHES
    traj = trainer.run_epoch(0)
    torch.cuda.synchronize()
    return trainer, traj, corr.LAUNCHES - before


def _traj_diffs(a, b, names=SMALL_ATOL):
    diffs = {}
    for name in names:
        x, y = np.stack(getattr(a, name)), np.stack(getattr(b, name))
        if x.shape != y.shape or not np.isfinite(x).all():
            raise AssertionError((name, x.shape, y.shape))
        diffs[name] = float(np.abs(x - y).max())
    return diffs


def phase_slice_small():
    gpu, gtraj, glaunch = _run_small("cuda")
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    _, ctraj, claunch = _run_small("cpu", sd)
    diffs = _traj_diffs(gtraj, ctraj)
    emit({"phase": "slice_small", "windows": 2, "launches_cuda": glaunch,
          "launches_cpu": claunch, "max_abs_diff": diffs,
          "atol": SMALL_ATOL})
    if glaunch != 10 or claunch != 0:
        raise AssertionError(f"launches cuda={glaunch} cpu={claunch}, "
                             "want 10 and 0")
    bad = {k: v for k, v in diffs.items() if not v <= SMALL_ATOL[k]}
    if bad:
        raise AssertionError(f"cuda and cpu disagree: {bad}")


def _train_small(trainer):
    """Epochs 1 ('vo') and 2 ('imu'): per epoch the launches, the summed
    gradients and the trajectories; then the trained parameters."""
    out = {"launches": [], "grads": [], "trajs": [], "losses": [],
           "reproj_pixels": []}
    for epoch in (1, 2):
        before = corr.LAUNCHES
        out["trajs"].append(trainer.run_epoch(epoch))
        torch.cuda.synchronize()
        out["launches"].append(corr.LAUNCHES - before)
        out["grads"].append({k: g.cpu() for k, g in
                             trainer.last_grads.items()})
        out["losses"].append(trainer.window_losses[epoch])
        out["reproj_pixels"].append(trainer.reproj_pixels[epoch])
    out["pose"] = {k: p.detach().cpu() for k, p in trainer.vo_params.items()}
    out["denoiser"] = {k: p.detach().cpu()
                       for k, p in trainer.imu_params.items()}
    return out


def _compare_small(g, c, grad_rtol):
    """A cuda run ``g`` against a cpu run ``c`` of ``_train_small``: per
    epoch the summed gradients (atol ``grad_rtol`` x max|g|), the window
    losses and the trajectories; then the SGD-updated pose head and the
    Adam-updated denoiser.  Returns (report, what disagrees)."""
    report = {"launches_cuda": g["launches"], "launches_cpu": c["launches"],
              "losses_cuda": g["losses"], "losses_cpu": c["losses"],
              "grads": [], "traj": []}
    bad = []
    for e, (gg, cg) in enumerate(zip(g["grads"], c["grads"])):
        gmax = max(float(v.abs().max()) for v in cg.values())
        diff = max(float((gg[k] - cg[k]).abs().max()) for k in cg)
        report["grads"].append({"epoch": e + 1, "max_abs_g": gmax,
                                "max_abs_diff": diff,
                                "atol": grad_rtol * gmax})
        if sorted(gg) != sorted(cg) or not diff <= grad_rtol * gmax:
            bad.append(f"epoch {e + 1} gradients")
        if not np.allclose(g["losses"][e], c["losses"][e], rtol=LOSS_RTOL,
                           atol=LOSS_RTOL * max(c["losses"][e])):
            bad.append(f"epoch {e + 1} losses")
        diffs = _traj_diffs(g["trajs"][e], c["trajs"][e])
        report["traj"].append(diffs)
        bad += [f"epoch {e + 1} {k}" for k, v in diffs.items()
                if not v <= SMALL_ATOL[k]]
    gmax = report["grads"][0]["max_abs_g"]
    wmax = max(float(v.abs().max()) for v in c["pose"].values())
    atol = {"pose": SMALL_LR * grad_rtol * gmax
            + 2 * float(np.spacing(np.float32(wmax))),
            "denoiser": 2 * IMU_LR}
    report["atol_updated"] = atol
    for name in ("pose", "denoiser"):
        diff = max(float((g[name][k] - c[name][k]).abs().max())
                   for k in c[name])
        report[f"{name}_max_abs_diff"] = diff
        if not diff <= atol[name]:
            bad.append(f"updated {name}")
    if g["launches"] != [10, 0] or c["launches"] != [0, 0]:
        bad.append(f"launches cuda={g['launches']} cpu={c['launches']}, "
                   "want [10, 0] and [0, 0]")
    return report, bad


def _small_trainer(pkl, device, state_dict, *flags):
    args = get_args(["--train-epoch", "2", "--vo-optimizer", "sgd",
                     "--lr", str(SMALL_LR), "--imu-lr", str(IMU_LR),
                     "--imu-denoise-model-name", pkl, "--device", device,
                     *SMALL, *flags])
    ds = SyntheticTrajDataset(num_frames=5, height=64, width=128,
                              transform=train.make_transform(64, 128))
    return train.Trainer(args, ds, device=device, state_dict=state_dict)


def phase_train_small(pkl):
    gpu = _small_trainer(pkl, "cuda", None)
    sd = {k: v.cpu().clone() for k, v in gpu.model.state_dict().items()}
    g = _train_small(gpu)
    c = _train_small(_small_trainer(pkl, "cpu", sd))
    report, bad = _compare_small(g, c, GRAD_RTOL)
    emit({"phase": "train_small", "windows_per_epoch": 2, **report})
    if bad:
        raise AssertionError(f"train_small: cuda and cpu disagree: {bad}")


def _snapshot_rows(tmp, epoch):
    rows = {}
    for name in ("vo_pose", "pgo_pose", "imu_pose"):
        r = np.loadtxt(os.path.join(tmp, str(epoch), f"{name}.txt"))
        if r.shape != (25, 7) or not np.isfinite(r).all():
            raise AssertionError((epoch, name, r.shape))
        rows[name] = r.shape[0]
    return rows


def phase_slice_full(smi):
    """The eval-only path: counts are set to 0 just before and read just
    after."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        trainer = train.main(["--eval-only", "--result-dir", tmp, *FULL])
        launches = corr.LAUNCHES
        _other_kernels_idle("slice_full")
        peak = torch.cuda.max_memory_allocated()
        rows = _snapshot_rows(tmp, 0)
    secs, prep = trainer.window_seconds[0], trainer.prep_seconds[0]
    emit({"phase": "slice_full", "windows": len(secs), "launches": launches,
          "pose_rows": rows, "first_window_ms": secs[0] * 1e3,
          "window_ms_median_after_first": statistics.median(secs[1:]) * 1e3,
          "window_ms": [s * 1e3 for s in secs],
          "host_prep_ms": [s * 1e3 for s in prep],
          "peak_mem_bytes": peak, "card": smi})
    if launches != 15:
        raise AssertionError(f"{launches} kernel launches on the main path, "
                             "want 15 (5 per window)")
    return launches, {"window_ms_median_after_first":
                      statistics.median(secs[1:]) * 1e3,
                      "peak_mem_bytes": peak, "launches": launches,
                      "motions": trainer.prev_vo_motions.cpu()}


class _EpochRecord(train.Trainer):
    """The Trainer ``main`` builds, recording per epoch the kernel launches
    and which trained parameters moved; also its parameters as loaded (the
    .pkls) and its whole state at the start of each epoch (after a
    resume)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.record = {}
        self.loaded = optim.state_dict(self.model.state_dict())
        self.at_start = {}

    def run_epoch(self, epoch, *args, **kw):
        self.at_start[epoch] = optim.state_dict(self.checkpoint_state())
        pose = {k: p.detach().clone() for k, p in self.vo_params.items()}
        dn = {k: p.detach().clone() for k, p in self.imu_params.items()}
        before, before_all = corr.LAUNCHES, corr.LAUNCHES_ALL
        traj = super().run_epoch(epoch, *args, **kw)
        torch.cuda.synchronize()
        self.record[epoch] = {
            "target": self.train_target[epoch],
            "launches": corr.LAUNCHES - before,
            "launches_all": corr.LAUNCHES_ALL - before_all,
            "pose_leaves_moved": sum(not torch.equal(p, pose[k])
                                     for k, p in self.vo_params.items()),
            "denoiser_leaves_moved": sum(not torch.equal(p, dn[k])
                                         for k, p in self.imu_params.items())}
        return traj


def phase_train_full(smi, pkl):
    """The training path: counts are set to 0 just before and read just
    after; ``_EpochRecord`` splits them by epoch."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        base, train.Trainer = train.Trainer, _EpochRecord
        try:
            trainer = train.main(["--train-epoch", "2",
                                  "--imu-denoise-model-name", pkl,
                                  "--result-dir", tmp, *FULL])
        finally:
            train.Trainer = base
        launches = corr.LAUNCHES
        _other_kernels_idle("train_full")
        peak = torch.cuda.max_memory_allocated()
        rows = {e: _snapshot_rows(tmp, e) for e in (1, 2)}
    epochs = {}
    for e, rec in trainer.record.items():
        secs = trainer.window_seconds[e]
        bwd = trainer.backward_seconds[e]
        epochs[e] = {
            **rec, "window_ms": [s * 1e3 for s in secs],
            "window_ms_median_after_first": statistics.median(secs[1:]) * 1e3,
            "host_prep_ms": [s * 1e3 for s in trainer.prep_seconds[e]],
            "backward_ms": [s * 1e3 for s in bwd],
            "backward_share_after_first": (
                sum(bwd[1:]) / sum(secs[1:]) if bwd else 0.0),
            "pose_rows": rows[e]}
    emit({"phase": "train_full", "launches": launches, "epochs": epochs,
          "n_pose_leaves": len(trainer.vo_params),
          "n_denoiser_leaves": len(trainer.imu_params),
          "peak_mem_bytes": peak, "card": smi})
    e1, e2 = epochs[1], epochs[2]
    if (e1["launches"], e2["launches"]) != (15, 0) or launches != 15:
        raise AssertionError(f"launches {e1['launches']}/{e2['launches']}, "
                             "want 15/0")
    _moved_in_their_epochs(trainer)
    return launches, {
        e: {k: epochs[e][k] for k in ("window_ms_median_after_first",
                                      "launches")} for e in epochs} | {
        "peak_mem_bytes": peak}


def _moved_in_their_epochs(trainer):
    e1, e2 = trainer.record[1], trainer.record[2]
    if not (e1["pose_leaves_moved"] > 0 and e2["pose_leaves_moved"] == 0
            and e1["denoiser_leaves_moved"] == 0
            and e2["denoiser_leaves_moved"] > 0):
        raise AssertionError(f"parameters moved in the wrong epochs: "
                             f"{trainer.record}")


KITTI_FRAMES = 26   # end_frame -1: 25 frames, 24 links, 3 windows of 8
# the first window's IMU positions against the drive's ground truth: the
# fixture's IMU is consistent with its OXTS poses, and 64x128 CPU runs stay
# within ~1.2 mm; with absolute Mercator positions in float32 they did not
# move in northing at all
KITTI_IMU_ATOL = 1e-2


def _split_ms(trainer, epoch):
    """Per window: the main thread's wait and the preparation split."""
    return {"wait_ms": [s * 1e3 for s in trainer.prep_seconds[epoch]],
            **{f"{k}_ms": [s[k] * 1e3 for s in
                           trainer.prep_split_seconds[epoch]]
               for k in ("decode", "transforms", "copy")}}


def _kitti_pkls(tmp):
    """A full VONet .pkl (seed 0, the reference's keys) and a pose-only one
    (seed 2, keys without the ``flowPoseNet.`` prefix)."""
    full = train.tvo.init_model(448, 640, seed=0, device="cpu").state_dict()
    pose = {k[len("flowPoseNet."):]: v for k, v in train.tvo.init_model(
        448, 640, seed=2, device="cpu").state_dict().items()
        if k.startswith("flowPoseNet.")}
    paths = (os.path.join(tmp, "stereo_flow_pose.pkl"),
             os.path.join(tmp, "pose.pkl"))
    torch.save(full, paths[0])
    torch.save(pose, paths[1])
    return full, pose, paths


def kitti_drive(tmp):
    """The KITTI raw drive and the two .pkls that kitti_full and
    bilevel_full run on."""
    t0 = time.perf_counter()
    root = fixtures.write_kitti(os.path.join(tmp, "raw"), KITTI_FRAMES)
    seconds = time.perf_counter() - t0
    full, pose, (vo_pkl, pose_pkl) = _kitti_pkls(tmp)
    return {"root": root, "fixture_s": seconds, "full": full, "pose": pose,
            "vo_pkl": vo_pkl, "pose_pkl": pose_pkl}


def phase_kitti_full(smi, pkl, drive):
    """The presets' path on a recorded-sequence layout: counts are set to 0
    just before each run of ``main`` and read just after."""
    report = {"phase": "kitti_full", "card": smi,
              "fixture_s": drive["fixture_s"]}
    bad = []
    root, full, pose = drive["root"], drive["full"], drive["pose"]
    vo_pkl, pose_pkl = drive["vo_pkl"], drive["pose_pkl"]
    with tempfile.TemporaryDirectory() as tmp:
        images = sorted(os.path.join(root, cam, "data", f)
                        for cam in ("image_02", "image_03")
                        for f in os.listdir(os.path.join(root, cam, "data")))
        t0 = time.perf_counter()
        shapes = {image_io.read_image(p).shape for p in images}
        report["decode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / (
            len(images))
        report["png_bytes_per_image"] = sum(
            os.path.getsize(p) for p in images) / len(images)
        if shapes != {(370, 1226, 3)}:
            raise AssertionError(f"decoded shapes {shapes}")
        models = os.path.join(tmp, "models")
        result = os.path.join(tmp, "result")
        flags = ["--data-type", "kitti", "--data-root", root,
                 "--vo-model-name", vo_pkl, "--pose-model-name", pose_pkl,
                 "--imu-denoise-model-name", pkl, "--save-model-dir", models,
                 "--result-dir", result, "--worker-num", "2",
                 "--fix-model-parts", "flow", "stereo", "--batch-size", "8",
                 "--image-height", "448", "--image-width", "640",
                 "--device", "cuda", *PRESET]
        base, train.Trainer = train.Trainer, _EpochRecord
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            run1 = train.main(["--train-epoch", "2", *flags])
            launches1 = corr.LAUNCHES
            _other_kernels_idle("kitti_full run 1")
            saved = sorted(os.listdir(models))
            _reset_counts()
            run2 = train.main(["--start-epoch", "3", "--train-epoch", "3",
                               *flags])
            launches2 = corr.LAUNCHES
            _other_kernels_idle("kitti_full run 2")
            peak = torch.cuda.max_memory_allocated()
        finally:
            train.Trainer = base
        rows = {e: _snapshot_rows(result, e) for e in (1, 2, 3)}
        restored = ckpt.restore_checkpoint(models, 2)

        # the .pkls, bitwise: the pose head from the pose-only file
        want = dict(full)
        want.update({"flowPoseNet." + k: v for k, v in pose.items()})
        report["pkl_unequal"] = testing.unequal_paths(run1.loaded, want)
        report["pose_head_from_pose_pkl"] = all(
            torch.equal(run1.loaded["flowPoseNet." + k], v)
            for k, v in pose.items()) and any(
            not torch.equal(v, full["flowPoseNet." + k])
            for k, v in pose.items())
        # run 2 starts from models/2, which is where run 1 ended
        report["resume_unequal"] = (
            testing.unequal_paths(run2.at_start[3], restored)
            + testing.unequal_paths(optim.state_dict(
                run1.checkpoint_state()), restored))
        report["models"] = saved
        epochs = {}
        for run, es in ((run1, (1, 2)), (run2, (3,))):
            for e in es:
                secs = run.window_seconds[e]
                epochs[e] = {**run.record[e],
                             "window_ms": [s * 1e3 for s in secs],
                             **_split_ms(run, e), "pose_rows": rows[e]}
        report.update(epochs=epochs, launches=[launches1, launches2],
                      peak_mem_bytes=peak)
        records = evaluate.main([result])
        report["evaluate"] = records
        report["prefetch"] = _prefetch_turns(root, vo_pkl, pose_pkl)
        report["origin"] = _kitti_origin(root, os.path.join(tmp, "origin"))
    emit(report)

    if report["pkl_unequal"] or not report["pose_head_from_pose_pkl"]:
        bad.append(f"loaded parameters differ from the .pkls at "
                   f"{report['pkl_unequal'][:5]}")
    if report["resume_unequal"]:
        bad.append(f"resume is not bitwise at {report['resume_unequal'][:5]}")
    if saved != ["1", "2"]:
        bad.append(f"models/ holds {saved}, want 1 and 2")
    got = [epochs[e]["launches"] for e in (1, 2, 3)]
    if got != [15, 0, 15] or [launches1, launches2] != [15, 15]:
        bad.append(f"launches per epoch {got}, runs {launches1}/"
                   f"{launches2}; want 15/0/15")
    if run2.record[3]["target"] != "vo":
        bad.append("epoch 3 is not a 'vo' epoch")
    kinds = {(r["epoch"], r["kind"]) for r in records
             if all(np.isfinite([r["ate"], r["rpe_trans"], r["rpe_rot"]]))}
    if kinds != {(e, k) for e in (1, 2, 3) for k in evaluate.KINDS}:
        bad.append(f"finite ATE/RPE only for {sorted(kinds)}")
    origin = report["origin"]
    if origin["gt_start"] != [0.0, 0.0, 0.0]:
        bad.append(f"ground truth starts at {origin['gt_start']}, not 0")
    if not origin["imu_worst_m"] <= KITTI_IMU_ATOL:
        bad.append(f"first window's IMU positions {origin['imu_worst_m']} m "
                   f"from the ground truth (> {KITTI_IMU_ATOL})")
    if bad:
        raise AssertionError("; ".join(bad))
    return (launches1 + launches2 + report["prefetch"]["launches"]
            + origin["launches"])


def _kitti_origin(root, result):
    """An eval run of the drive: the ground truth's first position and the
    worst distance of the first window's IMU positions from it."""
    _reset_counts()
    train.main(["--eval-only", "--data-type", "kitti", "--data-root", root,
                "--worker-num", "0", "--batch-size", "8", "--device", "cuda",
                "--print-interval", "0", "--result-dir", result, *PRESET])
    launches = corr.LAUNCHES
    _other_kernels_idle("kitti_full origin")
    gt = np.loadtxt(os.path.join(result, "gt_pose.txt"))
    imu = np.loadtxt(os.path.join(result, "0", "imu_pose.txt"))
    dist_m = np.linalg.norm(imu[:9, :3] - gt[:9, :3], axis=1)
    return {"gt_start": gt[0, :3].tolist(),
            "imu_worst_m": float(dist_m.max()), "launches": launches}


def _prefetch_turns(root, vo_pkl, pose_pkl):
    """Eval-only runs of the same drive without (--worker-num 0) and with
    (2) the prefetch thread, in turns: 0, 2, 2, 0."""
    out = {"0": [], "2": []}
    launches = 0
    for workers in ("0", "2", "2", "0"):
        _reset_counts()
        trainer = train.main([
            "--eval-only", "--data-type", "kitti", "--data-root", root,
            "--vo-model-name", vo_pkl, "--pose-model-name", pose_pkl,
            "--worker-num", workers, "--batch-size", "8", "--device", "cuda",
            "--print-interval", "0", *PRESET])
        launches += corr.LAUNCHES
        _other_kernels_idle("kitti_full prefetch turns")
        out[workers].append({"window_ms": [
            s * 1e3 for s in trainer.window_seconds[0]],
            **_split_ms(trainer, 0)})
    return {"worker_num": out, "launches": launches}


def _constant_heads(sd):
    """A copy of the VONet state dict ``sd`` with constant flow and
    disparity heads (a 1-px flow and a 10-px disparity, as
    tests/test_torch_slice.py sets them: random weights give a disparity of
    about -1e8 px on the KITTI drive and on synthetic data, so the scale
    and reprojection masks would be empty) and BatchNorm running stats drawn
    from seed 1."""
    sd = {k: v.clone() for k, v in sd.items()}
    for k in ("flowNet.predict_flow2.weight", "flowNet.dc_conv7.weight",
              "flowNet.dc_conv7.bias", "stereoNet.conv_c13.weight"):
        sd[k].zero_()
    sd["flowNet.predict_flow2.bias"].copy_(torch.tensor([0.2, 0.1]))
    sd["stereoNet.conv_c13.bias"].fill_(0.8)
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(0.1 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    return sd


def phase_bilevel_small(pkl):
    """The couplings through the solve, cuda against cpu: counts are set to
    0 just before and read just after."""
    sd = _constant_heads(train.tvo.init_model(64, 128, seed=0,
                                              device="cpu").state_dict())
    _reset_counts()
    report = {"phase": "bilevel_small", "windows_per_epoch": 2, "modes": {}}
    bad = []
    runs = {}
    for mode in ("implicit", "unrolled"):
        flags = ("--bilevel", mode, *BILEVEL)
        g = runs[mode] = _train_small(_small_trainer(pkl, "cuda", sd, *flags))
        c = _train_small(_small_trainer(pkl, "cpu", sd, *flags))
        rep, why = _compare_small(g, c, BILEVEL_GRAD_RTOL)
        bad += [f"{mode} {w}" for w in why]
        rep["reproj_pixels_cuda"] = g["reproj_pixels"]
        rep["reproj_pixels_cpu"] = c["reproj_pixels"]
        if not (min(g["reproj_pixels"][0]) > 0
                and min(c["reproj_pixels"][0]) > 0
                and g["reproj_pixels"][1] == [0, 0]):
            bad.append(f"{mode} reprojection pixels {g['reproj_pixels']} "
                       f"{c['reproj_pixels']}")
        report["modes"][mode] = rep
    # the implicit 'vo' gradient is not the detached one
    det = _small_trainer(pkl, "cuda", sd, "--bilevel", "detached", *BILEVEL)
    det.run_epoch(1)
    torch.cuda.synchronize()
    g_imp = runs["implicit"]["grads"][0]
    g_det = {k: v.cpu() for k, v in det.last_grads.items()}
    gmax = max(float(v.abs().max()) for v in g_det.values())
    diff = max(float((g_imp[k] - g_det[k]).abs().max()) for k in g_det)
    report["implicit_vs_detached"] = {"max_abs_g": gmax,
                                      "max_abs_diff": diff}
    if not diff > 1e-3 * gmax:
        bad.append("the implicit 'vo' gradient equals the detached one")
    launches = corr.LAUNCHES
    _other_kernels_idle("bilevel_small")
    report["launches"] = launches
    emit(report)
    if launches != 30:
        bad.append(f"{launches} launches, want 30 (10 per 'vo' epoch)")
    if bad:
        raise AssertionError(f"bilevel_small: {bad}")
    return launches


def phase_bilevel_full(smi, pkl, drive):
    """The couplings through the solve at full width on kitti_full's drive:
    counts are set to 0 just before each run of ``main`` and read just
    after; ``_EpochRecord`` splits them by epoch."""
    vo_pkl = os.path.join(os.path.dirname(drive["vo_pkl"]),
                          "constant_heads.pkl")
    torch.save(_constant_heads(drive["full"]), vo_pkl)
    flags = ["--data-type", "kitti", "--data-root", drive["root"],
             "--vo-model-name", vo_pkl,
             "--imu-denoise-model-name", pkl, "--worker-num", "2",
             "--batch-size", "8", "--image-height", "448",
             "--image-width", "640", "--device", "cuda", "--print-interval",
             "0", *PRESET, *BILEVEL]
    report = {"phase": "bilevel_full", "card": smi, "runs": {}}
    bad = []
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        for mode, epochs in (("detached", 1), ("implicit", 2),
                             ("unrolled", 1)):
            result = os.path.join(tmp, mode)
            base, train.Trainer = train.Trainer, _EpochRecord
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                run = train.main(["--bilevel", mode, "--train-epoch",
                                  str(epochs), "--result-dir", result,
                                  *flags])
                launches = corr.LAUNCHES
                _other_kernels_idle(f"bilevel_full {mode}")
                peak = torch.cuda.max_memory_allocated()
            finally:
                train.Trainer = base
            total += launches
            rec = {}
            for e in range(1, epochs + 1):
                secs, bwd = run.window_seconds[e], run.backward_seconds[e]
                rec[e] = {**run.record[e],
                          "window_ms": [x * 1e3 for x in secs],
                          "backward_ms": [x * 1e3 for x in bwd],
                          "wait_ms": [x * 1e3 for x in run.prep_seconds[e]],
                          "reproj_pixels": run.reproj_pixels[e],
                          "losses": run.window_losses[e],
                          "pose_rows": _snapshot_rows(result, e)}
            report["runs"][mode] = {"launches": launches,
                                    "peak_mem_bytes": peak,
                                    "frozen_bn_eval": run.frozen_bn_eval,
                                    "epochs": rec}
            if not run.frozen_bn_eval:
                bad.append(f"{mode}: --frozen-bn-eval did not take effect")
            for e, r in rec.items():
                vo = r["target"] == "vo"
                if r["launches"] != (15 if vo else 0):
                    bad.append(f"{mode} epoch {e}: {r['launches']} launches")
                if vo != (r["pose_leaves_moved"] > 0) or vo == (
                        r["denoiser_leaves_moved"] > 0):
                    bad.append(f"{mode} epoch {e}: parameters moved in the "
                               f"wrong epoch: {r}")
                if not vo and any(r["reproj_pixels"]):
                    bad.append(f"{mode} epoch {e}: the factor ran in 'imu'")
                if not all(np.isfinite(r["losses"])):
                    bad.append(f"{mode} epoch {e}: nonfinite losses")
            if launches != 15:
                bad.append(f"{mode}: {launches} launches, want 15")
    report["launches"] = total
    emit(report)
    if not any(p for r in report["runs"].values()
               for e in r["epochs"].values() for p in e["reproj_pixels"]):
        bad.append("the reprojection mask was empty in every window")
    if bad:
        raise AssertionError("bilevel_full: " + "; ".join(bad))
    return total


def _bf16_small(pkl, device, state_dict):
    """``--bf16`` at 64x128: epoch 0 (eval) and epoch 1 ('vo'); per epoch
    the trajectories and (all-shift, main) kernel launches, then the 'vo'
    gradients."""
    trainer = _small_trainer(pkl, device, state_dict, "--bf16")
    out = {"trajs": [], "launches": []}
    for epoch in (0, 1):
        before = (corr.LAUNCHES_ALL, corr.LAUNCHES)
        out["trajs"].append(trainer.run_epoch(epoch))
        if device == "cuda":
            torch.cuda.synchronize()
        out["launches"].append([corr.LAUNCHES_ALL - before[0],
                                corr.LAUNCHES - before[1]])
    out["grads"] = {k: g.cpu() for k, g in trainer.last_grads.items()}
    return trainer, out


def phase_bf16_small(pkl):
    """``--bf16``, cuda against cpu: counts are set to 0 just before and
    read just after."""
    _reset_counts()
    gpu, g = _bf16_small(pkl, "cuda", None)
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    _, c = _bf16_small(pkl, "cpu", sd)
    launches = corr.LAUNCHES_ALL
    report = {"phase": "bf16_small", "windows_per_epoch": 2,
              "launches_cuda": g["launches"], "launches_cpu": c["launches"],
              "traj": [_traj_diffs(a, b, BF16_ATOL)
                       for a, b in zip(g["trajs"], c["trajs"])],
              "atol": BF16_ATOL}
    gg, cg = g["grads"], c["grads"]
    gmax = max(float(v.abs().max()) for v in cg.values())
    dot = sum(float((gg[k] * cg[k]).sum()) for k in cg)
    norms = [sum(float((x[k] ** 2).sum()) for k in cg) ** 0.5
             for x in (gg, cg)]
    report["grads"] = {
        "max_abs_g": gmax,
        "max_abs_diff": max(float((gg[k] - cg[k]).abs().max()) for k in cg),
        "atol": BF16_GRAD_RTOL * gmax,
        "cosine": dot / (norms[0] * norms[1]), "min_cosine": BF16_GRAD_COS}
    emit(report)
    bad = [f"epoch {e} {k}" for e, d in enumerate(report["traj"])
           for k, v in d.items() if not v <= BF16_ATOL[k]]
    if not (report["grads"]["max_abs_diff"] <= report["grads"]["atol"]
            and report["grads"]["cosine"] >= BF16_GRAD_COS):
        bad.append(f"gradients {report['grads']}")
    # 2 windows an epoch, one VO forward each, 5 correlations a forward
    if g["launches"] != [[10, 0], [10, 0]] or c["launches"] != [[0, 0],
                                                                [0, 0]]:
        bad.append(f"launches (all-shift, main) cuda={g['launches']} "
                   f"cpu={c['launches']}, want [10, 0] per epoch on cuda")
    if bad:
        raise AssertionError(f"bf16_small: {bad}")
    _other_kernels_idle("bf16_small", bf16=True)
    return launches


def phase_bf16_full(smi, pkl, f32_eval, f32_train):
    """slice_full's and train_full's runs with ``--bf16``: counts are set
    to 0 just before each run of ``main`` and read just after."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        ev = train.main(["--eval-only", "--bf16", "--result-dir", tmp, *FULL])
        eval_launches = corr.LAUNCHES_ALL
        _other_kernels_idle("bf16_full eval", bf16=True)
        eval_peak = torch.cuda.max_memory_allocated()
        _snapshot_rows(tmp, 0)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        base, train.Trainer = train.Trainer, _EpochRecord
        try:
            tr = train.main(["--train-epoch", "2", "--bf16",
                             "--imu-denoise-model-name", pkl,
                             "--result-dir", tmp, *FULL])
        finally:
            train.Trainer = base
        train_launches = corr.LAUNCHES_ALL
        _other_kernels_idle("bf16_full train", bf16=True)
        train_peak = torch.cuda.max_memory_allocated()
        for e in (1, 2):
            _snapshot_rows(tmp, e)
    # reported, not bounded: with random weights the flow net's outputs
    # are large, and 0.4 % bfloat16 rounding of them moves the pose head's
    # input (bf16_small bounds bf16 cuda against cpu, the CPU tests the port
    # against JAX in bf16)
    gap = float((ev.prev_vo_motions.cpu() - f32_eval["motions"]).abs().max())
    scale = float((f32_eval["motions"] - torch.tensor(
        [0, 0, 0, 0, 0, 0, 1.0])).abs().max())
    secs = ev.window_seconds[0]
    report = {
        "phase": "bf16_full", "card": smi,
        "eval": {"window_ms": [x * 1e3 for x in secs],
                 "window_ms_median_after_first":
                     statistics.median(secs[1:]) * 1e3,
                 "launches_all_shift": eval_launches,
                 "peak_mem_bytes": eval_peak,
                 "float32": {k: v for k, v in f32_eval.items()
                             if k != "motions"}},
        "train": {"peak_mem_bytes": train_peak,
                  "launches_all_shift": train_launches,
                  "float32": f32_train},
        "motion_gap_bf16_vs_f32": gap,
        "f32_motion_max_abs_from_identity": scale}
    for e in (1, 2):
        w = tr.window_seconds[e]
        report["train"][e] = {
            **tr.record[e], "window_ms": [x * 1e3 for x in w],
            "window_ms_median_after_first": statistics.median(w[1:]) * 1e3,
            "backward_ms": [x * 1e3 for x in tr.backward_seconds[e]]}
    emit(report)
    got = [tr.record[e]["launches_all"] for e in (1, 2)]
    if eval_launches != 15 or got != [15, 0] or train_launches != 15:
        raise AssertionError(f"bf16_full: all-shift launches eval "
                             f"{eval_launches}, train {got}; want 15, 15/0")
    _moved_in_their_epochs(tr)
    if not np.isfinite(gap):
        raise AssertionError(f"bf16_full: nonfinite motions ({gap})")
    return eval_launches + train_launches


def _load_rows(result, epoch, name="pgo_pose"):
    return np.loadtxt(os.path.join(result, str(epoch), f"{name}.txt"))


def phase_scan_full(smi, pkl, drive):
    """``--scan-chunk 2`` against window-by-window epochs on kitti_full's
    drive, every ``train_scan`` call under the sync check: counts are set to
    0 just before each run of ``main`` and read just after."""
    flags = ["--data-type", "kitti", "--data-root", drive["root"],
             "--vo-model-name", drive["vo_pkl"],
             "--imu-denoise-model-name", pkl, "--worker-num", "0",
             "--fix-model-parts", "flow", "stereo", "--batch-size", "8",
             "--image-height", "448", "--image-width", "640",
             "--device", "cuda", "--print-interval", "0",
             "--vo-optimizer", "sgd", *PRESET]
    checked = []
    scan = train.train_scan

    def train_scan_no_sync(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = scan(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.append(len(args[1]))
        return out

    report = {"phase": "scan_full", "card": smi, "runs": {},
              "cudnn_deterministic": True}
    bad = []
    totals = {"correlation": 0, "correlation_all": 0}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, *extra):
            result = os.path.join(tmp, name)
            base, train.Trainer = train.Trainer, _EpochRecord
            train.train_scan = train_scan_no_sync
            try:
                _reset_counts()
                tr = train.main([*extra, "--result-dir", result, *flags])
                launches = {"correlation": corr.LAUNCHES,
                            "correlation_all": corr.LAUNCHES_ALL}
                _other_kernels_idle(f"scan_full {name}",
                                    bf16="--bf16" in extra)
            finally:
                train.Trainer = base
                train.train_scan = scan
            for k, n in launches.items():
                totals[k] += n
            report["runs"][name] = {
                "launches": launches,
                "epochs": {e: {**tr.record[e],
                               "chunk_ms": [x * 1e3 for x in
                                            tr.chunk_seconds[e]],
                               "window_ms": [x * 1e3 for x in
                                             tr.window_seconds[e]]}
                           for e in tr.record}}
            return tr, result

        def compare(name, a, b, epochs):
            (ta, ra), (tb, rb) = a, b
            d = {"motions": float((ta.prev_vo_motions
                                   - tb.prev_vo_motions).abs().max()),
                 "pgo_pose": max(float(np.abs(_load_rows(ra, e)
                                              - _load_rows(rb, e)).max())
                                 for e in epochs)}
            after = [x.checkpoint_state() for x in (ta, tb)]
            if 2 in epochs:
                # the pose head after epoch 1, the denoiser after epoch 2
                pose = [x.at_start[2]["model"] for x in (ta, tb)]
                d["denoiser"] = max(float((after[0]["denoiser"][k]
                                           - after[1]["denoiser"][k])
                                          .abs().max())
                                    for k in after[0]["denoiser"])
            else:
                pose = [x["model"] for x in after]
            d["pose"] = max(float((pose[0][k].cpu() - pose[1][k].cpu())
                                  .abs().max())
                            for k in pose[0] if k.startswith("flowPoseNet."))
            report["runs"][name]["max_abs_diff_vs_per_window"] = d
            bad.extend(f"{name} {k} {v}" for k, v in d.items()
                       if not v <= SCAN_ATOL[k])
            n_chunks = [len(tb.chunk_seconds[e]) for e in epochs]
            if n_chunks != [1] * len(epochs) or not ta.chunk_seconds[1] == []:
                bad.append(f"{name}: chunks per epoch {n_chunks}")

        per_window = run("per_window", "--train-epoch", "2")
        scanned = run("scan2", "--train-epoch", "2", "--scan-chunk", "2")
        compare("scan2", per_window, scanned, (1, 2))
        imp = run("implicit_per_window", "--train-epoch", "1",
                  "--bilevel", "implicit")
        imp_scan = run("implicit_scan2", "--train-epoch", "1", "--bilevel",
                       "implicit", "--scan-chunk", "2")
        compare("implicit_scan2", imp, imp_scan, (1,))
        bf, bf_result = run("bf16_scan2", "--train-epoch", "1", "--bf16",
                            "--scan-chunk", "2")
        _snapshot_rows(bf_result, 1)
        if bf.record[1]["launches_all"] != 15 or len(bf.chunk_seconds[1]) != 1:
            bad.append(f"bf16_scan2: {bf.record[1]}")
    torch.backends.cudnn.deterministic = deterministic
    report["train_scan_calls_checked"] = len(checked)
    report["launches"] = totals
    emit(report)
    for name, r in report["runs"].items():
        for e, rec in r["epochs"].items():
            want = 15 if rec["target"] == "vo" else 0
            if rec["launches"] + rec["launches_all"] != want:
                bad.append(f"{name} epoch {e}: launches {rec}")
    if checked != [2, 2, 2, 2]:
        bad.append(f"train_scan ran {checked} windows under the sync "
                   "check, want 4 chunks of 2")
    if bad:
        raise AssertionError("scan_full: " + "; ".join(bad))
    return totals


def phase_profile_dir():
    """``main --profile-dir``: counts are set to 0 just before and read
    just after."""
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        train.main(["--eval-only", "--profile-dir", tmp, "--device", "cuda",
                    *SMALL])
        launches = corr.LAUNCHES
        _other_kernels_idle("profile_dir")
        files = sorted(os.listdir(tmp))
        path = os.path.join(tmp, files[0]) if files else None
        size = os.path.getsize(path) if path else 0
        events = json.load(open(path))["traceEvents"] if size else []
    kernels = sum(e.get("cat") == "kernel" for e in events)
    emit({"phase": "profile_dir", "files": files, "bytes": size,
          "events": len(events), "card_kernel_events": kernels,
          "launches": launches})
    if files != ["epoch0_window1_trace.json"] or not kernels:
        raise AssertionError(f"profile_dir: {files}, {size} bytes, "
                             f"{kernels} kernel events")
    return launches


# ---- the front-end variants (variants_small, variants_full) ----

# cuda vs cpu at 64x128 (variants_small): float32 on both (TF32 off), the
# same sums in other orders, ~1e-6 relative a layer; over the 30-100
# layers of these nets that is ~1e-5 of an output's scale, so each output
# is held to 1e-3 of its largest value on the cpu.  A wrong kernel or layer
# is off by O(0.1) of it.
VARIANT_RTOL = 1e-3
# variants_full runs each PSMNet forward 1 + PSM_REPS times (~1 s each)
PSM_REPS = 5
VARIANT_SEEDS = {"pwc_unc": 10, "vo": 0, "psm_stack": 11, "psm_basic": 12,
                 "vo21": 13, "vo22": 14}


def _nhwc_inputs(sample, device):
    return {k: torch.as_tensor(sample[k], device=device)
            for k in ("img0", "img1", "img0_norm", "img0_r_norm", "intrinsic",
                      "intrinsic_calib", "extrinsic", "motion", "flow")
            if k in sample}


def _vo_forward(model, t, **kw):
    return tvo.forward(model, t["img0"], t["img1"], t["img0_norm"],
                       t["img0_r_norm"], t["intrinsic"], t["intrinsic_calib"],
                       torch.linalg.norm(t["extrinsic"][:, :3], dim=1),
                       datatype="tartanair", **kw)


def _variant_models(h, w):
    """Every variant's network with seeded weights, on the cpu; the PSMNets
    at maxdisp 16 below 448x640, else 192."""
    s, maxdisp = VARIANT_SEEDS, 16 if h < 448 else 192
    return {
        "pwc_unc": init_weights_(PWCDCNet(uncertainty=True), s["pwc_unc"]),
        "vo": tvo.init_model(h, w, s["vo"], "cpu"),
        "psm_stack": psmnet.init_model(
            False, s["psm_stack"], "cpu", maxdisp=maxdisp, train_bn=False),
        "psm_basic": psmnet.init_model(
            True, s["psm_basic"], "cpu", maxdisp=maxdisp, train_bn=False),
        "vo21": init_weights_(VOFlowRes(h // 4, w // 4, stereo=2.1),
                              s["vo21"]),
        "vo22": init_weights_(VOFlowRes(h // 4, w // 4, stereo=2.2),
                              s["vo22"])}


@torch.no_grad()
def _calibrate_bn(model, *inputs):
    """Running stats of every BatchNorm from one batch, so that the eval
    mode of a seeded PSMNet normalises as a trained net's does.  With the
    init's (0, 1) stats its cost logits grow large, the soft-argmin turns
    into an argmax over near-ties, and cuDNN's and oneDNN's summation
    orders break those apart differently (0.50 of a range of 16 in the
    first run of variants_small)."""
    def hook(m, inp, out):
        x = inp[0]
        dims = [0, *range(2, x.dim())]
        m.running_mean.copy_(x.mean(dims))
        m.running_var.copy_(x.var(dims, unbiased=False))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm)]
    train_bn, model.train_bn = model.train_bn, True
    try:
        model(*inputs)
    finally:
        model.train_bn = train_bn
        for h in hooks:
            h.remove()


def _variant_inputs(gen, b, h, w, device):
    x = torch.rand((b, 6, h, w), generator=gen).to(device)
    flows = torch.randn((b, 6, h // 4, w // 4), generator=gen).to(device)
    ext = torch.randn((b, 6), generator=gen).to(device)
    return x, flows, ext


@torch.no_grad()
def _variants_small_run(models, sample, device):
    """Each variant once at 64x128, B=2 on ``device``: outputs by name, and
    the main kernel's launches by item."""
    models = {k: m.to(device) for k, m in models.items()}
    gen = torch.Generator().manual_seed(5)
    x, flows, ext = _variant_inputs(gen, 2, 64, 128, device)
    t = _nhwc_inputs(sample, device)
    out, launches = {}, {}

    def item(name, fn):
        before = corr.LAUNCHES
        out.update({f"{name}/{k}": v for k, v in fn().items()})
        if device == "cuda":
            torch.cuda.synchronize()
        launches[name] = corr.LAUNCHES - before

    def pwc_unc():
        fl, un = models["pwc_unc"](x)
        return {**{f"flow{i + 2}": f for i, f in enumerate(fl)},
                **{f"unc{i + 2}": u for i, u in enumerate(un)}}

    def vo(concat_free):
        return lambda: {k: v for k, v in _vo_forward(
            models["vo"], t, concat_free=concat_free).items()
            if k in ("motion", "flow", "disp", "scale")}

    vo_cls = tvo.TartanVO(models["vo"], correct_scale=False, device=device)
    no_flow = {k: v for k, v in sample.items() if k != "flow"}

    def pred_join():
        f = vo_cls.pred_flow(sample["img0"], sample["img1"])
        return {"pred_flow": f,
                "join_flow": vo_cls.join_flow([g.permute(2, 0, 1)
                                               for g in f])}

    item("pwc_unc", pwc_unc)
    item("vo_default", vo(False))
    item("vo_concat_free", vo(True))
    item("tartanvo_given_scale", lambda: {"motion": vo_cls(
        no_flow, given_scale=np.float32([0.5, 2.0]))["motion"]})
    item("tartanvo_precalc_flow", lambda: {
        k: v for k, v in vo_cls(sample).items()
        if k in ("motion", "scale", "flow")})
    item("pred_flow_join_flow", pred_join)
    item("psm_stack", lambda: {"disp": models["psm_stack"](x)[0]})
    item("psm_basic", lambda: {"disp": models["psm_basic"](x[:, :3],
                                                           x[:, 3:])})
    item("vo21", lambda: {"pose": models["vo21"](flows, ext)})
    item("vo22", lambda: {"pose": models["vo22"](flows, ext)})
    return out, launches


def phase_variants_small(tmp):
    """The variants on cuda against cpu, one state dict: counts are set to
    0 just before the cuda run and read just after."""
    root = fixtures.write_tartanair(os.path.join(tmp, "ta_small"), n=5,
                                    h=64, w=128, seed=3, flow=True)
    ds = TrajFolderDataset(root, "tartanair", load_flow=True,
                           transform=train.make_transform(64, 128))
    sample = collate([ds[0], ds[1]])
    models = _variant_models(64, 128)
    x = _variant_inputs(torch.Generator().manual_seed(5), 2, 64, 128,
                        "cpu")[0]
    _calibrate_bn(models["psm_stack"], x)
    _calibrate_bn(models["psm_basic"], x[:, :3], x[:, 3:])
    cpu_models = {k: copy.deepcopy(m) for k, m in models.items()}
    _reset_counts()
    g, glaunch = _variants_small_run(models, sample, "cuda")
    _other_kernels_idle("variants_small")
    total = corr.LAUNCHES
    c, claunch = _variants_small_run(cpu_models, sample, "cpu")
    diffs, bad = {}, []
    for k, ref in c.items():
        a, b = g[k].float().cpu(), ref.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            bad.append(f"{k}: {tuple(a.shape)} {tuple(b.shape)} finite "
                       f"{bool(torch.isfinite(a).all())}")
            continue
        d = float((a - b).abs().max())
        atol = VARIANT_RTOL * float(b.abs().max()) + 1e-6
        diffs[k] = {"max_abs_diff": d, "atol": atol}
        if not d <= atol:
            bad.append(f"{k}: {d} > {atol}")
    # concat-free against the default, each device
    for name, run in (("cuda", g), ("cpu", c)):
        for k in ("motion", "flow"):
            a, b = (run[f"vo_{v}/{k}"].float().cpu()
                    for v in ("concat_free", "default"))
            d = float((a - b).abs().max())
            atol = VARIANT_RTOL * float(b.abs().max()) + 1e-6
            diffs[f"concat_free_vs_default_{name}/{k}"] = {
                "max_abs_diff": d, "atol": atol}
            if not d <= atol:
                bad.append(f"concat-free vs default on {name} {k}: {d}")
    want = {"pwc_unc": 5, "vo_default": 5, "vo_concat_free": 5,
            "tartanvo_given_scale": 5, "tartanvo_precalc_flow": 5,
            "pred_flow_join_flow": 5}
    want = {k: want.get(k, 0) for k in glaunch}
    emit({"phase": "variants_small", "batch": 2, "hw": [64, 128],
          "launches_cuda": glaunch, "launches_cpu": claunch,
          "max_abs_diff": diffs, "rtol_of_scale": VARIANT_RTOL})
    if glaunch != want or any(claunch.values()):
        bad.append(f"launches cuda {glaunch} (want {want}), cpu {claunch}")
    if bad:
        raise AssertionError("variants_small: " + "; ".join(bad))
    return total


def _timed(fn, reps=5):
    """fn() once to warm up, then ``reps`` times between CUDA events: (the
    last output, the median ms, every ms)."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, statistics.median(times), times


def _finite(name, out):
    ts = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else [out])
    for t in ts:
        if torch.is_tensor(t) and t.is_floating_point() and not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"variants_full {name}: nonfinite output")


def _measure(report, name, fn, reps=5, forwards=1):
    """One item: peak bytes (reset before it), CUDA-event ms (median of
    ``reps`` after a warm-up), launches of each kernel per call; every
    output finite.  Returns the output."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = (corr.LAUNCHES, corr.LAUNCHES_ALL)
    out, ms, times = _timed(fn, reps)
    torch.cuda.synchronize()
    calls = reps + 1
    launches = [corr.LAUNCHES - before[0], corr.LAUNCHES_ALL - before[1]]
    report[name] = {"ms": ms, "ms_all": times,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "launches_main_per_call": launches[0] / calls,
                    "launches_all_shift_per_call": launches[1] / calls}
    _finite(name, out)
    return out


@torch.no_grad()
def phase_variants_full(smi, tmp):
    """The variants at 448x640, B=8, seed-0 weights: counts are set to 0
    just before and read just after."""
    report = {"phase": "variants_full", "card": smi, "batch": 8,
              "hw": [448, 640], "items": {}}
    items, bad = report["items"], []
    t0 = time.perf_counter()
    # the dataset drops the last frame (end_frame=-1): 10 frames, 8 pairs
    root = fixtures.write_tartanair(os.path.join(tmp, "ta_full"), n=10,
                                    h=480, w=640, seed=0, flow=True,
                                    depth=True)
    ds = TrajFolderDataset(root, "tartanair", load_flow=True,
                           load_depth=True,
                           transform=train.make_transform(448, 640))
    sample = collate([ds[i] for i in range(8)])
    report["folder_write_and_read_s"] = time.perf_counter() - t0
    if sample["flow"].shape != (8, 112, 160, 2) or sample["depth0"].shape != (
            8, 112, 160, 1):
        raise AssertionError(f"variants_full: flow {sample['flow'].shape}, "
                             f"depth0 {sample['depth0'].shape}")
    gen = torch.Generator().manual_seed(6)
    models = _variant_models(448, 640)
    models = {k: m.cuda() for k, m in models.items()}
    t = _nhwc_inputs(sample, "cuda")
    _reset_counts()

    x6 = torch.cat([t["img0"], t["img1"]], dim=-1).permute(0, 3, 1, 2)
    _measure(items, "pwc_uncertainty", lambda: models["pwc_unc"](
        x6.contiguous()))

    vo = {}
    for bf16 in (False, True):
        for cf in (False, True):
            name = f"vo_{'bf16' if bf16 else 'f32'}_" + (
                "concat_free" if cf else "default")
            vo[name] = _measure(items, name, lambda: _vo_forward(
                models["vo"], t, concat_free=cf, bf16=bf16))
    # concat-free against the default: the flow, and the rotation, which
    # the pose head computes from it (the translation's stereo scale
    # thresholds the flow into a mask).  float32: within 1e-3 of the
    # output's scale.  bf16: each part's convolution rounds on its own, so
    # the two decoders round at other places: their relative L2 difference
    # is held to 3x the bf16 default's own relative L2 error against the
    # float32 default (measured at 64x128 on the CPU: 1.1x for the flow,
    # 2.0x for the rotation).
    for prec in ("f32", "bf16"):
        for k in ("flow", "rotation"):
            a, b, f32 = (vo[f"vo_{p}"]["motion"][:, 3:] if k == "rotation"
                         else vo[f"vo_{p}"][k] for p in (
                             f"{prec}_concat_free", f"{prec}_default",
                             "f32_default"))
            r = {"max_abs_diff": float((a - b).abs().max()),
                 "atol": VARIANT_RTOL * float(b.abs().max()) + 1e-6}
            if prec == "bf16":
                r = {**r, "rel_l2": float((a - b).norm() / b.norm()),
                     "default_rel_l2_vs_f32": float((b - f32).norm()
                                                    / f32.norm())}
                ok = r["rel_l2"] <= 3 * r["default_rel_l2_vs_f32"]
            else:
                ok = r["max_abs_diff"] <= r["atol"]
            report.setdefault("concat_free_vs_default", {})[
                f"{prec}/{k}"] = r
            if not ok:
                bad.append(f"concat-free vs default {prec} {k}: {r}")

    vo_cls = tvo.TartanVO(models["vo"], correct_scale=False, device="cuda")
    res = _measure(items, "tartanvo_precalc_flow", lambda: vo_cls(sample))
    if not torch.equal(res["flow"], t["flow"].permute(0, 3, 1, 2)):
        bad.append("the precomputed flow was not the one used")
    scale = torch.linspace(0.5, 2.0, 8)
    res = _measure(items, "tartanvo_given_scale", lambda: vo_cls(
        {k: v for k, v in sample.items() if k != "flow"}, given_scale=scale))
    got = torch.linalg.norm(res["motion"][:, :3], dim=1).cpu()
    if not torch.allclose(got, scale, rtol=1e-5):
        bad.append(f"given scale {got.tolist()}")
    steps = [_measure(items, f"pred_flow_step{i}",
                      lambda i=i: vo_cls.pred_flow(sample["img0"][i],
                                                   sample["img1"][i]))
             for i in range(3)]
    joined = _measure(items, "join_flow_3", lambda: vo_cls.join_flow(
        [f.permute(2, 0, 1) for f in steps]))
    img = _measure(items, "visflow", lambda: torch.from_numpy(
        visualization.visflow(joined.permute(1, 2, 0))))
    if tuple(img.shape) != (112, 160, 3):
        bad.append(f"visflow {tuple(img.shape)}")

    for name, fn in (
            ("psm_stack_eval", lambda m, x: m(x)[0]),
            ("psm_stack_training_mode", lambda m, x: m(x)[0]),
            ("psm_basic", lambda m, x: m(x[:, :3].contiguous(),
                                         x[:, 3:].contiguous()))):
        m = models["psm_basic" if name == "psm_basic" else "psm_stack"]
        if name != "psm_stack_training_mode":
            _calibrate_bn(m, *((x6[:, :3], x6[:, 3:]) if name == "psm_basic"
                               else (x6,)))
        m.train_bn = m.training_mode = name == "psm_stack_training_mode"
        b = 8
        try:
            out = _measure(items, name, lambda: fn(m, x6), reps=PSM_REPS)
        except torch.cuda.OutOfMemoryError as e:
            # reported with its peak, then run at B=4
            items[f"{name}_b8_out_of_memory"] = {
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "error": str(e).splitlines()[0]}
            b = 4
            out = _measure(items, f"{name}_b4", lambda: fn(m, x6[:4]),
                           reps=PSM_REPS)
        shapes = [tuple(o.shape) for o in (out if isinstance(out, tuple)
                                             else (out,))]
        if shapes != [(b, 1, 448, 640)] * (
                3 if name == "psm_stack_training_mode" else 1):
            bad.append(f"{name}: {shapes}")
    x, flows, ext = _variant_inputs(gen, 8, 448, 640, "cuda")
    del x
    for name in ("vo21", "vo22"):
        _measure(items, name, lambda: models[name](flows, ext))
    launches = corr.LAUNCHES
    bf16_launches = corr.LAUNCHES_ALL
    report["launches"] = {"correlation": launches,
                          "correlation_all": bf16_launches}
    emit(report)
    # 5 a PWC forward: main kernel in float32, all-shift kernel in bf16
    for name, r in items.items():
        pwc = name.startswith(("pwc", "vo_", "tartanvo", "pred_flow"))
        want = (0, 5) if "bf16" in name else (5, 0)
        got = (r["launches_main_per_call"], r["launches_all_shift_per_call"])
        if got != (want if pwc else (0, 0)):
            bad.append(f"{name}: launches per call {got}")
    if bad:
        raise AssertionError("variants_full: " + "; ".join(bad))
    return launches, bf16_launches


# ---- the multi-sequence trainer (islam_tpu_torch/parallel/) ----

# The trainer's Adam rates.  An Adam step is ~lr x sign(g), so where a
# gradient entry near 0 has the other sign on the other path the parameter
# moves by 2 lr (and 2 ulp of the weights for the rounding of w + step):
# the bound of every Adam-updated parameter below, as train_small's for
# the denoiser.
PAR_LR, PAR_IMU_LR = 3e-6, 3e-5
# parallel_full's scanned epoch against the per-window one.  Not bitwise,
# even with cuDNN's deterministic algorithms: the scan adds each sequence's
# K window gradients before the sequences (another order of the same six
# terms), and the convolution algorithms may change between the two runs.
# On the H100 they did, during the scanned epoch: fresh trainers after it
# reproduce each other bitwise but differ from identical runs before it by
# up to 1.97e-5 in the motions, in every window (on an H100 80GB HBM3; a
# cached algorithm replaced in the process, not traced; the phase asserts
# that a fresh per-window epoch after the scan gives the scan's motions
# bitwise, and reports it against the first).  So the bounds
# are those of two runs whose convolutions may differ: motions 1e-4 (2x
# the 5.1e-5 of two per-window runs without deterministic cuDNN, above),
# pgo_pose 1e-3 (tests/test_parallel.py:247), gradients GRAD_RTOL of
# max|g|, losses 1e-4 relative, the Adam-updated pose head 2 lr and 2 ulp.
PAR_SCAN_ATOL = {"motions": 1e-4, "pgo_pose": 1e-3}
PAR_SCAN_LOSS_RTOL = 1e-4
# one sequence in the multi-sequence trainer against the single-sequence
# Trainer on it alone (tests/test_parallel.py:247)
PAR_SINGLE_ATOL = 1e-3
# parallel_small's trajectories, from the snapshot files
PAR_TRAJ = {"vo_motion": "vo_motions", "pgo_pose": "pgo_poses",
            "pgo_vel": "pgo_vels"}


@contextlib.contextmanager
def _group(device):
    """A one-rank process group (NCCL for cuda, gloo for cpu) and its
    mesh; destroyed on the way out."""
    pmesh.initialize_distributed(f"localhost:{pmesh.free_port()}", 1, 0,
                                 device=device, timeout=600)
    try:
        yield pmesh.make_mesh(1, device=device)
    finally:
        dist.destroy_process_group()


def _traj_rows(snap, s, epoch, name):
    rows = np.loadtxt(os.path.join(snap, f"seq{s}", str(epoch),
                                   f"{name}.txt"))
    if not np.isfinite(rows).all():
        raise AssertionError(f"seq{s} epoch {epoch} {name}: nonfinite")
    return rows


def _parallel_small_run(device, sd, dn_sd, snap):
    """Epochs 1 ('vo') and 2 ('imu') at 64x128, B=2 on a one-rank group:
    counts are set to 0 just before and read just after."""
    out = {"losses": [], "launches": [], "grads": []}
    with _group(device) as mesh:
        tr = MultiSequenceTrainer(
            testing.make_sequences((0, 1), 5, 64, 128), batch_size=2,
            lr=PAR_LR, imu_lr=PAR_IMU_LR, mesh=mesh, state_dict=sd,
            denoiser_state_dict=dn_sd, device=device)
        out["backend"] = dist.get_backend()
        _reset_counts()
        for epoch in (1, 2):
            before = corr.LAUNCHES
            out["losses"].append(tr.run_epoch(epoch=epoch,
                                              snapshot_dir=snap))
            torch.cuda.synchronize()
            out["launches"].append(corr.LAUNCHES - before)
            out["grads"].append({k: g.cpu() for k, g in
                                 tr.last_grads.items()})
            if epoch == 1:
                out["pose"] = {k: p.detach().cpu().clone()
                               for k, p in tr.vo_params.items()}
        _other_kernels_idle(f"parallel_small {device}")
        out["denoiser"] = {k: p.detach().cpu().clone()
                           for k, p in tr.imu_params.items()}
        out["collective"] = tr.collective
    return out


def phase_parallel_small(pkl):
    """``MultiSequenceTrainer`` on cuda (NCCL) and on cpu (gloo), one rank
    each, from one state dict and one denoiser: losses, gradients, updated
    parameters and each sequence's trajectories must agree within
    train_small's bounds; 5 main-kernel launches per VO forward per
    sequence on cuda, none in 'imu' or on cpu."""
    sd = tvo.init_model(64, 128, seed=0, device="cpu").state_dict()
    dn_sd = ckpt.import_denoiser(ckpt.load_torch_state_dict(pkl))
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        runs = {dev: _parallel_small_run(dev, sd, dn_sd,
                                         os.path.join(tmp, dev))
                for dev in ("cuda", "cpu")}
        traj = {}
        for s in (0, 1):
            for e in (1, 2):
                for name, key in PAR_TRAJ.items():
                    g, c = (_traj_rows(os.path.join(tmp, d), s, e, name)
                            for d in ("cuda", "cpu"))
                    diff = float(np.abs(g - c).max())
                    traj[f"seq{s}/{e}/{name}"] = diff
                    if g.shape != c.shape or not diff <= SMALL_ATOL[key]:
                        bad.append(f"seq{s} epoch {e} {name} {diff}")
    g, c = runs["cuda"], runs["cpu"]
    report = {"phase": "parallel_small", "sequences": 2,
              "windows_per_epoch": 2, "backends": [g["backend"],
                                                   c["backend"]],
              "launches_cuda": g["launches"], "launches_cpu": c["launches"],
              "losses_cuda": g["losses"], "losses_cpu": c["losses"],
              "collective_cuda": g["collective"],
              "traj_max_abs_diff": traj, "grads": []}
    for e, (gg, cg) in enumerate(zip(g["grads"], c["grads"]), 1):
        gmax = max(float(v.abs().max()) for v in cg.values())
        diff = max(float((gg[k] - cg[k]).abs().max()) for k in cg)
        report["grads"].append({"epoch": e, "max_abs_g": gmax,
                                "max_abs_diff": diff})
        if sorted(gg) != sorted(cg) or not diff <= GRAD_RTOL * gmax:
            bad.append(f"epoch {e} gradients")
        ce = c["losses"][e - 1]
        if not np.allclose(g["losses"][e - 1], ce, rtol=LOSS_RTOL,
                           atol=LOSS_RTOL * max(ce)):
            bad.append(f"epoch {e} losses")
    wmax = max(float(v.abs().max()) for v in c["pose"].values())
    for name, atol in (("pose", 2 * PAR_LR
                        + 2 * float(np.spacing(np.float32(wmax)))),
                       ("denoiser", 2 * PAR_IMU_LR)):
        diff = max(float((g[name][k] - c[name][k]).abs().max())
                   for k in c[name])
        report[f"{name}_max_abs_diff"] = diff
        if not diff <= atol:
            bad.append(f"updated {name} {diff} > {atol}")
    emit(report)
    if g["launches"] != [20, 0] or c["launches"] != [0, 0]:
        bad.append(f"launches cuda={g['launches']} cpu={c['launches']}, "
                   "want [20, 0] and [0, 0]")
    if bad:
        raise AssertionError("parallel_small: " + "; ".join(bad))
    return sum(g["launches"])


def _ms(seconds):
    return [s * 1e3 for s in seconds]


def phase_parallel_full(smi, pkl):
    """Two sequences of 25 frames at 448x640, B=8 on a one-rank NCCL
    group, seed-0 VO weights and the seed-1 denoiser: epochs 0, 1 and 2;
    a fresh trainer's ``scan_chunk=2`` epoch 1 against the per-window one;
    a save after epoch 2 and a bitwise resume; each sequence's epoch-1
    pgo_pose against the single-sequence Trainer on it alone.  Counts are
    set to 0 just before and read just after."""
    sd = tvo.init_model(448, 640, seed=0, device="cpu").state_dict()
    dn_sd = ckpt.import_denoiser(ckpt.load_torch_state_dict(pkl))
    report = {"phase": "parallel_full", "card": smi, "sequences": 2,
              "hw": [448, 640], "batch": 8, "cudnn_deterministic": True,
              "epochs": {}}
    bad = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with _group("cuda") as mesh, tempfile.TemporaryDirectory() as tmp:
        def trainer():
            return MultiSequenceTrainer(
                testing.make_sequences((0, 1), 25, 448, 640), batch_size=8,
                lr=PAR_LR, imu_lr=PAR_IMU_LR, mesh=mesh, state_dict=sd,
                denoiser_state_dict=dn_sd)

        report["backend"] = dist.get_backend()
        tr = trainer()
        snap = os.path.join(tmp, "per_window")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for epoch in (0, 1, 2):
            before = corr.LAUNCHES
            losses = tr.run_epoch(epoch=epoch, snapshot_dir=snap)
            torch.cuda.synchronize()
            secs = tr.window_seconds[epoch]
            report["epochs"][epoch] = {
                "target": tr.train_target[epoch], "losses": losses,
                "launches": corr.LAUNCHES - before,
                "window_ms": _ms(secs),
                "window_ms_median_after_first":
                    statistics.median(secs[1:]) * 1e3,
                "backward_ms": _ms(tr.backward_seconds[epoch]),
                "collective": tr.collective[epoch]}
            if epoch == 1:
                pose1 = {k: p.detach().clone()
                         for k, p in tr.vo_params.items()}
                grads1 = {k: g.clone() for k, g in tr.last_grads.items()}
                motions1 = tr.prev_vo_motions.clone()
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        launches = corr.LAUNCHES
        _other_kernels_idle("parallel_full")
        want = {0: 30, 1: 30, 2: 0}
        got = {e: r["launches"] for e, r in report["epochs"].items()}
        if got != want:
            bad.append(f"launches per epoch {got}, want {want}")
        if not torch.equal(tr.prev_vo_motions, motions1):
            bad.append("the 'imu' epoch changed the motion cache")

        # save after epoch 2, resume bitwise
        models = os.path.join(tmp, "models")
        tr.save_models(models, 2)
        fresh = trainer()
        if fresh.resume(models, 3) != 2:
            bad.append("resume found no save of epoch 2")
        report["resume_unequal"] = testing.unequal_paths(
            *(x.checkpoint_state() for x in (tr, fresh)))
        bad += [f"resume {p}" for p in report["resume_unequal"]]
        if any(not np.array_equal(x[k], y[k]) for x, y in zip(
                tr._init_states, fresh._init_states) for k in x):
            bad.append("resume: sequence states")
        del fresh

        # scan_chunk=2 (one chunk, one tail window) against per-window
        sc = trainer()
        before = corr.LAUNCHES
        sc_losses = sc.run_epoch(scan_chunk=2, epoch=1,
                                 snapshot_dir=os.path.join(tmp, "scan"))
        torch.cuda.synchronize()
        scan_launches = corr.LAUNCHES - before
        gmax = max(float(g.abs().max()) for g in grads1.values())
        d = {"motions": float((sc.prev_vo_motions - motions1).abs().max()),
             "pgo_pose": max(float(np.abs(
                 _traj_rows(os.path.join(tmp, "scan"), s, 1, "pgo_pose")
                 - _traj_rows(snap, s, 1, "pgo_pose")).max())
                 for s in (0, 1)),
             "grads": max(float((sc.last_grads[k] - g).abs().max())
                          for k, g in grads1.items()),
             "pose": max(float((sc.vo_params[k].detach() - p).abs().max())
                         for k, p in pose1.items())}
        wmax = max(float(p.abs().max()) for p in pose1.values())
        atol = dict(PAR_SCAN_ATOL, grads=GRAD_RTOL * gmax,
                    pose=2 * PAR_LR + 2 * float(np.spacing(np.float32(wmax))))
        report["scan2"] = {
            "launches": scan_launches, "losses": sc_losses,
            "window_ms": _ms(sc.window_seconds[1]),
            "max_abs_diff_vs_per_window": d, "atol": atol}
        bad += [f"scan2 {k} {v}" for k, v in d.items() if not v <= atol[k]]
        if not np.allclose(sc_losses, report["epochs"][1]["losses"],
                           rtol=PAR_SCAN_LOSS_RTOL):
            bad.append("scan2 losses")
        if scan_launches != 30:
            bad.append(f"scan2 launches {scan_launches}")
        # a fresh per-window epoch 1 after the scan: its motions must be
        # the scan's bitwise (the same convolutions; see PAR_SCAN_ATOL)
        again = trainer()
        again.run_epoch(epoch=1)
        report["per_window_again_max_abs_diff"] = {
            "motions_vs_first": float((again.prev_vo_motions
                                       - motions1).abs().max()),
            "motions_vs_scan": float((again.prev_vo_motions
                                      - sc.prev_vo_motions).abs().max())}
        if not torch.equal(again.prev_vo_motions, sc.prev_vo_motions):
            bad.append("per-window epoch after the scan: motions "
                       f"{report['per_window_again_max_abs_diff']} differ "
                       "from the scan's")
        del sc, again

        # each sequence alone in the single-sequence Trainer
        args = get_args(["--imu-denoise-model-name", pkl,
                         "--print-interval", "0", *FULL])
        single = {}
        for s, ds in enumerate(testing.make_sequences((0, 1), 25, 448,
                                                      640)):
            before = corr.LAUNCHES
            traj = train.Trainer(args, ds, device="cuda",
                                 state_dict=sd).run_epoch(1)
            torch.cuda.synchronize()
            diff = float(np.abs(np.stack(traj.pgo_poses)
                                - _traj_rows(snap, s, 1, "pgo_pose")).max())
            single[f"seq{s}"] = {"pgo_pose_max_abs_diff": diff,
                                 "launches": corr.LAUNCHES - before}
            if not diff <= PAR_SINGLE_ATOL or single[f"seq{s}"][
                    "launches"] != 15:
                bad.append(f"seq{s} against the single-sequence Trainer: "
                           f"{single[f'seq{s}']}")
        report["single_sequence"] = single
        launches = corr.LAUNCHES
    torch.backends.cudnn.deterministic = deterministic
    report["launches"] = launches
    emit(report)
    if bad:
        raise AssertionError("parallel_full: " + "; ".join(bad))
    return launches


def phase_parallel_procs(smi):
    """``python -m islam_tpu_torch.validate_multihost --device cuda --bf16``
    at 448x640, B=8: two processes on the one card over gloo, 2 sequences
    each, a step and then the trainer's epochs.  Each child sets its counts
    to 0 just before its step and each epoch and reads them just after;
    the sum of the ranks' is returned."""
    cmd = [sys.executable, "-m", "islam_tpu_torch.validate_multihost",
           "--device", "cuda", "--bf16", "--height", "448", "--width", "640",
           "--batch-size", "8", "--timeout", "300", "--wait", "420"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=480)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"parallel_procs: exit {proc.returncode}\n"
                             + out[-6000:])
    summary = [json.loads(line) for line in out.splitlines()
               if line.startswith('{"validate_multihost"')]
    if len(summary) != 1:
        raise AssertionError("parallel_procs: no summary line\n"
                             + out[-6000:])
    ranks = summary[0]["ranks"]
    keep = ("rank", "sequences", "loss", "grad_checksum", "params_sha256",
            "step_s", "collective_ms", "collective_bytes",
            "collective_clock", "launches", "peak_mem_bytes", "device",
            "backend", "trainer_losses", "trainer_grad_checksums",
            "trainer_params_sha256", "trainer_launches",
            "trainer_window_ms", "trainer_collective", "resumed")
    emit({"phase": "parallel_procs", "card": smi, "processes": 2,
          "sequences": 4, "hw": [448, 640], "batch": 8, "bf16": True,
          "wall_s": wall, "children_wall_s": summary[0]["wall_s"],
          "ranks": [{k: r[k] for k in keep} for r in ranks]})
    bad = []
    for key in ("loss", "grad_checksum", "params_sha256", "trainer_losses",
                "trainer_grad_checksums", "trainer_params_sha256"):
        if len({json.dumps(r[key]) for r in ranks}) != 1:
            bad.append(f"ranks disagree on {key}")
    all_shift = {"correlation": 0, "correlation_all": 10}
    for r in ranks:
        if not (r["finite"] and r["trainer_finite"] and r["resumed"]
                and r["device"] == "cuda:0" and r["backend"] == "gloo"
                and r["launches"] == all_shift
                and r["trainer_launches"] == [
                    all_shift, {"correlation": 0, "correlation_all": 0}]):
            bad.append(f"rank {r['rank']}: {r['launches']}, "
                       f"{r['trainer_launches']}, {r['device']}, "
                       f"{r['backend']}, finite {r['finite']} "
                       f"{r['trainer_finite']}, resumed {r['resumed']}")
    if bad:
        raise AssertionError("parallel_procs: " + "; ".join(bad))
    return sum(r["launches"]["correlation_all"]
               + sum(e["correlation_all"] for e in r["trainer_launches"])
               for r in ranks)


# (noise, seed, t_noise, saturate) of the replica problems:
# tests/test_torch_pypose_replica.py's four (the last one's steps reject
# trials), and three more seeds
REPLICA_CASES = [(0.0, 0, 0.05, 0.0), (0.02, 1, 0.05, 0.0),
                 (0.05, 2, 0.05, 0.0), (0.05, 2, 0.5, 3.0),
                 (0.02, 3, 0.05, 0.0), (0.05, 4, 0.05, 0.0),
                 (0.1, 5, 0.05, 0.0)]
REPLICA_TOL = {"cost_rtol": 1e-5, "radius_rtol": 1e-9, "trans": 5e-6,
               "quat_dot": 1e-9, "vels": 5e-6, "f32": 2e-3}


def _replica_diffs(nodes, vels, rec_nodes, rec_vels):
    nodes, vels = nodes.cpu().numpy(), vels.cpu().numpy()
    return {"trans": float(np.abs(nodes[:, :3] - rec_nodes[:, :3]).max()),
            "quat_dot": float(np.abs(np.abs(np.sum(
                nodes[:, 3:] * rec_nodes[:, 3:], axis=-1)) - 1).max()),
            "vels": float(np.abs(vels - rec_vels).max())}


def phase_pvgo_replica():
    """The port's LM on the card against the numpy replica of PyPose's
    LM, step by step (``lm_solve_trace``) and at the solution
    (``lm_solve_graphed``: one CUDA graph a dtype, replayed on every
    problem after the first)."""
    worst = {k: 0.0 for k in ("cost_rel", "radius_rel", "trans", "quat_dot",
                              "vels", "graphed_trans", "graphed_quat_dot",
                              "graphed_vels", "graphed_f32")}
    cases, bad = [], []
    for noise, seed, t_noise, sat in REPLICA_CASES:
        p = testing.pvgo_problem(noise=noise, seed=20 + seed)
        nodes0, vels0 = testing.pvgo_perturbed_init(
            p, np.random.default_rng(seed), t_noise)
        ref = pypose_lm_replica(*testing.pvgo_np_residual(p, saturate=sat),
                                nodes0, vels0)
        res, inputs = testing.pvgo_residual(p, dtype=torch.float64,
                                            saturate=sat)
        n0 = torch.tensor(nodes0, device="cuda")
        v0 = torch.tensor(vels0, device="cuda")
        _, steps, active = lm_solve_trace(lambda n, v: res(n, v, inputs),
                                          n0, v0)
        n_active = int(active.sum())
        if n_active != ref.steps:
            bad.append(f"{noise, seed, sat}: {n_active} steps, replica "
                       f"{ref.steps}")
            continue
        for i, rec in enumerate(ref.trace):
            if int(steps.patience[i]) != rec.patience:
                bad.append(f"{noise, seed, sat}: patience at step {i}")
            cost = float(steps.cost[i])
            if abs(cost - rec.cost) > 1e-12 + REPLICA_TOL["cost_rtol"] * abs(
                    rec.cost):
                bad.append(f"{noise, seed, sat}: cost at step {i}")
            worst["cost_rel"] = max(worst["cost_rel"], abs(
                cost - rec.cost) / max(abs(rec.cost), 1e-30))
            worst["radius_rel"] = max(worst["radius_rel"], abs(
                float(steps.radius[i]) - rec.radius) / rec.radius)
            for k, v in _replica_diffs(steps.nodes[i], steps.vels[i],
                                       rec.nodes, rec.vels).items():
                worst[k] = max(worst[k], v)
        nodes, vels, _, n_steps = lm_solve_graphed(res, inputs, n0, v0,
                                                   key=("replica", sat))
        if int(n_steps) != ref.steps:
            bad.append(f"{noise, seed, sat}: graphed {int(n_steps)} steps")
        for k, v in _replica_diffs(nodes, vels, ref.nodes, ref.vels).items():
            worst["graphed_" + k] = max(worst["graphed_" + k], v)
        if not sat:  # float32 solutions of the converged problems
            res32, inputs32 = testing.pvgo_residual(p, dtype=torch.float32)
            nodes, vels, _, _ = lm_solve_graphed(
                res32, inputs32, n0.float(), v0.float(), key=("replica", sat))
            d32 = _replica_diffs(nodes, vels, ref.nodes, ref.vels)
            worst["graphed_f32"] = max(worst["graphed_f32"], d32["trans"],
                                       d32["vels"])
        cases.append({"noise": noise, "seed": seed, "t_noise": t_noise,
                      "saturate": sat, "steps": ref.steps,
                      "rejects": sum(r.rejects for r in ref.trace),
                      "final_cost": ref.cost})
    torch.cuda.synchronize()
    emit({"phase": "pvgo_replica", "cases": cases, "worst": worst,
          "tolerance": REPLICA_TOL})
    for k in ("radius_rel", "trans", "quat_dot", "vels"):
        if worst[k] > REPLICA_TOL[k if k != "radius_rel" else
                                  "radius_rtol"]:
            bad.append(f"{k} {worst[k]}")
    for k in ("trans", "quat_dot", "vels"):
        if worst["graphed_" + k] > REPLICA_TOL[k]:
            bad.append(f"graphed_{k} {worst['graphed_' + k]}")
    if worst["graphed_f32"] > REPLICA_TOL["f32"]:
        bad.append(f"graphed_f32 {worst['graphed_f32']}")
    if bad:
        raise AssertionError("pvgo_replica: " + "; ".join(bad))


# imperative_full's runs: (name, epochs, bf16, bilevel)
STUDY_RUNS = [("f32_detached", 4, False, "detached"),
              ("bf16_detached", 4, True, "detached"),
              ("bf16_implicit", 2, True, "implicit"),
              ("bf16_unrolled", 2, True, "unrolled")]
STUDY_METRICS = ("ate_vo", "ate_pgo", "rpe_rot_vo", "rpe_rot_pgo")


def phase_imperative_full(smi):
    """The study's path at its size, one run a configuration, each from
    the same seed-0 weights; counts are set to 0 just before each run and
    read just after.  Returns (main-kernel launches, all-shift launches)."""
    sd = {k: v.clone() for k, v in tvo.init_model(
        448, 640, seed=0, device="cuda").state_dict().items()}
    report = {"phase": "imperative_full", "card": smi, "hw": [448, 640],
              "batch": 8, "frames": 33, "lr": 1e-4, "runs": {}}
    totals = [0, 0]
    bad = []
    for name, epochs, bf16, bilevel in STUDY_RUNS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds, windows = [], []
        last = [time.perf_counter()]

        def on_epoch(epoch, trainer, traj, record):
            now = time.perf_counter()
            seconds.append(now - last[0])
            windows.append(trainer.window_seconds[epoch])
            last[0] = now

        _reset_counts()
        t0 = time.perf_counter()
        records = demo_imperative.run_study(
            epochs, 1e-4, bf16, bilevel, device="cuda", state_dict=sd,
            on_epoch=on_epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"correlation": corr.LAUNCHES,
                    "correlation_all": corr.LAUNCHES_ALL,
                    "correlation_81": corr.LAUNCHES_81,
                    "correlation_all_dy": corr.LAUNCHES_ALL_DY}
        n_vo = sum(r["target"] == "vo" for r in records)
        want = {"correlation": 0 if bf16 else 20 * n_vo,
                "correlation_all": 20 * n_vo if bf16 else 0,
                "correlation_81": 0, "correlation_all_dy": 0}
        if launches != want:
            bad.append(f"{name}: launches {launches}, want {want}")
        totals[0] += launches["correlation"]
        totals[1] += launches["correlation_all"]
        for rec in records:
            print(json.dumps({"run": name, **rec}), flush=True)
            if not all(np.isfinite(rec[k]) for k in STUDY_METRICS):
                bad.append(f"{name} epoch {rec['epoch']}: nonfinite")
            elif not rec["ate_pgo"] < rec["ate_vo"]:
                bad.append(f"{name} epoch {rec['epoch']}: PVGO ATE "
                           f"{rec['ate_pgo']} not below VO {rec['ate_vo']}")
        vo_epochs = [r for r in records if r["target"] == "vo"]
        report["runs"][name] = {
            "epochs": epochs, "bf16": bf16, "bilevel": bilevel,
            "records": records, "epoch_s": seconds, "window_s": windows,
            "wall_s": wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches,
            # the learning signal: VO rotation RPE, epoch 1 and the last
            # 'vo' epoch (its motions were made before that epoch's update)
            "rpe_rot_vo_first_last_vo": [vo_epochs[0]["rpe_rot_vo"],
                                         vo_epochs[-1]["rpe_rot_vo"]],
            "summary": demo_imperative.summary(records)}
    f32, b16 = (report["runs"][n]["records"]
                for n in ("f32_detached", "bf16_detached"))
    report["bf16_minus_f32"] = [{k: b[k] - f[k] for k in STUDY_METRICS}
                                for f, b in zip(f32, b16)]
    report["launches"] = {"correlation": totals[0],
                          "correlation_all": totals[1]}
    emit(report)
    if bad:
        raise AssertionError("imperative_full: " + "; ".join(bad))
    return totals


def _f1(found, ref):
    """F1, precision and recall of the distinct floored positions of two
    detections of the same frames, a match within 1 px in x and y."""
    hits = [0, 0]
    sizes = [0, 0]
    for a, b in zip(found, ref):
        a, b = (np.unique(np.floor(x), axis=0) for x in (a, b))
        sizes[0] += len(a)
        sizes[1] += len(b)
        if len(a) and len(b):
            d = np.abs(a[:, None] - b[None]).max(-1)
            hits[0] += int((d.min(1) <= 1).sum())
            hits[1] += int((d.min(0) <= 1).sum())
    p, r = hits[0] / max(sizes[0], 1), hits[1] / max(sizes[1], 1)
    return 2 * p * r / max(p + r, 1e-12), p, r


def _device_profile(fn, top=6):
    """One call of ``fn`` under torch.profiler: its kernels' summed device
    ms, their launches and the ``top`` kernels by device ms."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": t, "launches": n}
                    for k, t, n in rows[:top]]}


def phase_keypoints_full(smi):
    """The keypoint picker and the sparse loss's overlay at 448x640, B=8."""
    B, H, W, N, scale = 8, 448, 640, 100, 4
    report = {"phase": "keypoints_full", "card": smi}
    bad = []
    ds = testing.make_dataset(B + 1, H, W)
    img = np.stack([np.asarray(ds[i]["img0"]).reshape(H, W, 3)
                    for i in range(B)])
    gray = dense_ba.bgr2gray_u8(torch.as_tensor(
        (img * 255).astype(np.uint8), device="cuda"))
    raw, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        raw[dev] = sift.sift_keypoints(gray.to(dev), dev)
        seconds[dev] = time.perf_counter() - t0
    report["first_call_ms"] = {d: t * 1e3 for d, t in seconds.items()}
    f1, precision, recall = _f1(raw["cuda"], raw["cpu"])
    report.update(keypoints_per_frame=[len(k) for k in raw["cuda"]],
                  keypoints_per_frame_cpu=[len(k) for k in raw["cpu"]],
                  f1=f1, precision=precision, recall=recall,
                  identical=all(np.array_equal(a, b) for a, b in zip(
                      raw["cuda"], raw["cpu"])))
    _, ms, times = _timed(lambda: sift.sift_keypoints(gray, "cuda"))
    _, pyramid_ms, _ = _timed(lambda: sift.gaussian_pyramid(gray))
    report.update(detector_ms=ms, detector_ms_all=times,
                  pyramid_ms=pyramid_ms,
                  detector_device=_device_profile(
                      lambda: sift.sift_keypoints(gray, "cuda")))

    mask = np.random.default_rng(0).uniform(size=(B, H, W)) > 0.3
    picked = {}
    for dev in ("cuda", "cpu"):
        for m in (None, mask):
            pts = dense_ba.detect_keypoints(img, W, H, N=N, mask=m, seed=0,
                                            device=dev)
            if pts.shape != (B, N, 2) or pts.dtype != np.float32 or not (
                    (pts >= 0).all() and (pts < [W, H]).all()):
                bad.append(f"detect_keypoints on {dev}: {pts.shape} "
                           f"{pts.dtype} or a point off the image")
            picked[dev, m is not None] = pts
    xy = picked["cuda", True].astype(int)
    outside = int((~mask[np.arange(B)[:, None], xy[..., 1], xy[..., 0]])
                  .sum())
    report.update(masked_points_outside=outside, picked_equal={
        str(k): bool(np.array_equal(picked["cuda", k], picked["cpu", k]))
        for k in (False, True)})

    gen = torch.Generator(device="cuda").manual_seed(0)
    depth = 3 + 5 * torch.rand(B, H, W, device="cuda", generator=gen)
    flow = 2 * torch.randn(B, 2, H, W, device="cuda", generator=gen)
    rgb2imu = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device="cuda")
    loss = dense_ba.SparseReprojectionLoss(
        torch.as_tensor(picked["cuda", False], device="cuda"), depth, flow,
        320.0, 320.0, W / 2, H / 2, rgb2imu)
    motion = np.array([0.05, 0.02, 0, 0, 0.01, 0, 1], np.float32)
    motion[3:] /= np.linalg.norm(motion[3:])
    motion = torch.as_tensor(np.tile(motion, (B, 1)), device="cuda")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        loss.debug(motion, img, img, W, H, scale=scale, out_dir=out)
        report["debug_ms"] = (time.perf_counter() - t0) * 1e3
        shapes = [image_io.read_image(os.path.join(out, f"{i}_reproj.png"))
                  .shape for i in range(B)]
    report["debug_shapes"] = sorted(set(shapes))
    emit(report)
    if f1 < KEYPOINTS_F1:
        bad.append(f"cuda vs cpu detections: F1 {f1} < {KEYPOINTS_F1}")
    if outside:
        bad.append(f"{outside} masked points outside the mask")
    if shapes != [(H * scale, 2 * W * scale, 3)] * B:
        bad.append(f"debug overlays {shapes}")
    if bad:
        raise AssertionError("keypoints_full: " + "; ".join(bad))


# tools_full: bench.py's count of the 448x640, B=8 'vo' step under JAX's
# rule, to its 4 decimals; the share of a window's device time the
# roofline's rows must cover
JAX_RULE_ATOL = 1e-3
ROOFLINE_COVER = 0.5
# rows add kernel durations, the total sums device activities: equal up to
# rounding of the profiler's microseconds, unless a kernel counts twice
COVER_SLACK = 1e-3
TOP_COPIES = 40


def _roofline(w, model_tflops=None):
    """The roofline of a profiled window, with its MFU lines; checks its
    coverage, TF32 and its correlation launches."""
    if model_tflops is None:
        model_tflops = conv_roofline.window_model_tflops(w)
    r = conv_roofline.roofline(w, model_tflops, top=8)
    emit({"phase": "tools_full", "roofline": r})
    if not ROOFLINE_COVER <= r["covered_share"] <= 1 + COVER_SLACK:
        raise AssertionError(f"the roofline covers {r['covered_share']:.3f} "
                             f"of the window's device time, want >= "
                             f"{ROOFLINE_COVER} (and no kernel twice)")
    if r["tf32_kernels"]:
        raise AssertionError(f"float32 window launched TF32 kernels: "
                             f"{r['tf32_kernels'][:3]}")
    if w.correlation_launches != 5 * w.windows:
        raise AssertionError(f"{w.correlation_launches} correlation launches "
                             f"in {w.windows} VO forwards, want 5 each")
    return r


def _copies(w, concat_free):
    """The copies of an eval window; the cost-volume concat must be among
    the top rows by bytes, or with ``concat_free`` gone."""
    c = copy_tool.copies(w, TOP_COPIES)
    listed = any(r["op"] == "aten::cat" and r["site"].startswith(
        "models/pwcnet.py:") and r["site"].endswith(" _level")
        for r in c["top"])
    calls = c["named"]["cost_volume_concat"]["calls_per_window"]
    c["top"] = c["top"][:12]
    emit({"phase": "tools_full", "copies": c})
    if listed == concat_free or (calls > 0) == concat_free:
        raise AssertionError(
            f"concat_free={concat_free}: cost-volume concat in the top "
            f"{TOP_COPIES}: {listed}, {calls} a window")


def phase_tools_full(smi):
    """The tools on the card; counts are set to 0 just before and read
    just after.  Returns the launches of the main kernel and of the
    all-shift kernel."""
    _reset_counts()
    small = {}
    for name, bf16, target in (("f32", False, "vo"), ("bf16", True, "vo"),
                               ("f32_imu", False, "imu")):
        dev = {d: flop_tool.train_step_flops(64, 128, 2, bf16=bf16,
                                             target=target, device=d)
               for d in ("cuda", "cpu")}
        if dev["cuda"]["flops"] != dev["cpu"]["flops"]:
            raise AssertionError(f"the 64x128 count on cuda is not cpu's "
                                 f"({name}): {dev['cuda']['flops']} "
                                 f"against {dev['cpu']['flops']}")
        small[name] = dev["cuda"]["flops"]
    full = {}
    for bf16 in (True, False):
        f = flop_tool.train_step_flops(448, 640, 8, bf16=bf16, device="cuda")
        full["bf16" if bf16 else "f32"] = {
            k: f[k] for k in ("model_tflops", "model_tflops_jax_rule",
                              "parts_tflops", "pvgo_mflops",
                              "jax_rule_minus_model_tflops")}
        full["correlation_multiply_adds"] = f["correlation"]["multiply_adds"]
        if abs(f["model_tflops_jax_rule"] - flop_tool.FULL_JAX_RULE_TFLOPS) \
                > JAX_RULE_ATOL:
            raise AssertionError(
                f"448x640 B=8 count {f['model_tflops_jax_rule']} under JAX's "
                f"rule, want {flop_tool.FULL_JAX_RULE_TFLOPS}")
    emit({"phase": "tools_full", "counts_64x128_cuda_eq_cpu": small,
          "counts_448x640": full, "card": smi})
    # the f32 eval window, profiled with the stack, serves both tools
    w = tool_window.profile(0, with_stack=True)
    mfu = {"f32_eval": _roofline(w)}
    _copies(w, concat_free=False)
    mfu["bf16_eval"] = _roofline(tool_window.profile(0, bf16=True))
    mfu["f32_vo"] = _roofline(tool_window.profile(1),
                              full["f32"]["model_tflops"])
    rows = {c["name"] for r in mfu.values() for c in r["correlation"]}
    if rows != {n for n, _ in conv_roofline.CORRELATION_KERNELS}:
        raise AssertionError(f"correlation rows {rows}, want both kernels")
    _copies(tool_window.profile(0, concat_free=True, with_stack=True),
            concat_free=True)
    torch.cuda.synchronize()
    launches = corr.LAUNCHES, corr.LAUNCHES_ALL
    emit({"phase": "tools_full", "launches": launches, "card": smi,
          "mfu": {k: {n: r[n] for n in (
              "model_tflops", "mfu_wall", "mfu_device", "window_ms_median",
              "device_ms_per_window", "covered_share", "correlation")}
              for k, r in mfu.items()}})
    return launches


def main():
    smi = phase_device()
    phase_build()
    checks = phase_kernels()
    rows, bench_launches = phase_bench_corr()
    phase_slice_small()
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "denoiser.pkl")
        torch.save(init_denoiser(1, "cpu").state_dict(), pkl)
        phase_train_small(pkl)
        launches, f32_eval = phase_slice_full(smi)
        train_launches, f32_train = phase_train_full(smi, pkl)
        launches += train_launches
        drive = kitti_drive(tmp)
        launches += phase_kitti_full(smi, pkl, drive)
        launches += phase_bilevel_small(pkl)
        launches += phase_bilevel_full(smi, pkl, drive)
        bf16_launches = phase_bf16_small(pkl)
        bf16_launches += phase_bf16_full(smi, pkl, f32_eval, f32_train)
        scan_launches = phase_scan_full(smi, pkl, drive)
        launches += scan_launches["correlation"]
        bf16_launches += scan_launches["correlation_all"]
        launches += phase_profile_dir()
        launches += phase_variants_small(tmp)
        full_launches, full_bf16 = phase_variants_full(smi, tmp)
        launches += full_launches
        bf16_launches += full_bf16
        launches += phase_parallel_small(pkl)
        launches += phase_parallel_full(smi, pkl)
        bf16_launches += phase_parallel_procs(smi)
        phase_pvgo_replica()
        study_f32, study_bf16 = phase_imperative_full(smi)
        launches += study_f32
        bf16_launches += study_bf16
        phase_keypoints_full(smi)
        tool_launches = phase_tools_full(smi)
        launches += tool_launches[0]
        bf16_launches += tool_launches[1]

    def summary(name, fn, source, replaces, n, dtype="float32"):
        lv = [r[dtype] for r in rows]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "dtype": dtype,
            "max_abs_err": max(c[f"{fn}_max_abs_err"] for c in checks
                               if c["dtype"] == dtype),
            # one VO forward: the five levels, one launch each
            "ms": sum(r[f"{fn}_ms"] for r in lv),
            "plain_ms": sum(r["plain_ms"] for r in lv),
            "bound_ms": sum(r["bound_ms"] for r in lv),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in lv)
                         else "operations"),
            "library_ms": None}

    # launches on the main paths: the main kernel's in float32 (slice_full,
    # train_full, kitti_full, bilevel_small on cuda, bilevel_full,
    # scan_full's float32 runs, profile_dir, variants_small on cuda,
    # variants_full's float32 items, parallel_small on cuda,
    # parallel_full, imperative_full's float32 run, tools_full's float32
    # counts and windows), the all-shift kernel's in bfloat16 (bf16_small
    # on cuda, bf16_full, scan_full's bf16 run, variants_full's bf16 VO
    # forwards, parallel_procs' two processes, imperative_full's bf16 runs,
    # tools_full's bf16 counts and window); the other two run only on
    # the bench path.  Each kernel's times are in the
    # type its main path runs.
    emit({"kernels": [
        summary("correlation_fwd_sm90", "correlation",
                "islam_tpu_torch/csrc/correlation_sm90.cu",
                "islam_tpu/ops/pallas/correlation_kernel.py:38", launches),
        summary("correlation_fwd_81", "correlation_81",
                "islam_tpu_torch/csrc/correlation.cu",
                "islam_tpu/ops/pallas/correlation_kernel.py:38",
                bench_launches["correlation_81"]),
        summary("correlation_all_fwd_sm90", "correlation_all",
                "islam_tpu_torch/csrc/correlation_all_sm90.cu",
                "islam_tpu/ops/pallas/correlation_kernel.py:57",
                bf16_launches, dtype="bfloat16"),
        summary("correlation_all_fwd_dy", "correlation_all_dy",
                "islam_tpu_torch/csrc/correlation_dy.cu",
                "islam_tpu/ops/pallas/correlation_kernel.py:57",
                bench_launches["correlation_all_dy"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
