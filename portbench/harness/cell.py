"""One run of one cell: the set-up, the timed window, the readings, and the
comparison with the plain reference once the window has closed.

The system under test is ``islam_tpu_torch``'s trainer as ``train.main``
builds it from the preset's flags (``arguments.get_args``): a
``TrajFolderDataset`` of the drive, the ``Trainer`` with the seed's VONet
weights and denoiser, and ``Trainer.run_epoch``.  The drive holds the
set-up's slices and then the timed one: consecutive frames, each slice a
dataset of its own over the one parsed drive (``--start-frame`` /
``--end-frame``), so that no two steps see the same frame pair.

- 'vo' (training): the set-up runs the preset's first three 'vo' epochs
  (epochs 1, 3, 5; an epoch is one optimizer step) on slices of
  ``WARM_WINDOWS`` windows each, through the same ``run_epoch``, and hands
  the same trainer to the window, whose epoch 7 runs the timed slice and
  ends with the fourth step.
- 'eval' (serving): the set-up runs epoch 0 on a slice, then forgets its
  motions (so that the timed epoch 0 runs the VO forward, as a fresh
  ``--eval-only`` run does), and the window runs epoch 0 on the timed
  slice.

The timed slice holds ceil(seconds x ``windows_per_s``) windows (at least
``MIN_WINDOWS``), the cell's pace at which its window lasts about
``--seconds``: a fixed amount of work for a given length.  The window is
all of that epoch, from the call to the device's last operation.  With
``--trace 1`` the profiler records timed windows ``TRACE_SKIP`` to
``TRACE_SKIP + TRACE_WINDOWS - 1``.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import (check, drive, flops, report, spec, trace,
                               weights)

B1 = 0.9   # Adam's first decay (optax and the program's optim.adam)
WARM_WINDOWS = 2     # windows of each set-up slice
MIN_WINDOWS = 4      # the fewest timed windows
TRACE_SKIP = 12      # timed windows before the traced ones
TRACE_WINDOWS = 3    # traced windows


def _setup_program(cell, root, workdir, seed, device):
    """The trainer over the timed slice, and the datasets of every slice."""
    from islam_tpu_torch.arguments import get_args
    from islam_tpu_torch.data.dataset import TrajFolderDataset
    from islam_tpu_torch.data.loaders import LOADERS
    from islam_tpu_torch.train import Trainer, make_transform

    cfg, traffic = cell.config, cell.traffic
    H, W, B = cfg["image_height"], cfg["image_width"], cfg["batch_size"]
    sd = weights.vonet(H, W, cfg["weights"], seed, device)
    dn_path = os.path.join(workdir, "imudenoise.pkl")
    torch.save({k: v.cpu() for k, v in weights.denoiser(seed, device).items()},
               dn_path)
    slices = _slices(cell, cell.n_timed)
    a, b = slices[-1]
    argv = [*cfg["preset"], "--data-type", cfg["datatype"], "--data-root",
            root, "--imu-denoise-model-name", dn_path, "--batch-size", str(B),
            "--image-height", str(H), "--image-width", str(W),
            "--result-dir", os.path.join(workdir, "results"),
            "--start-frame", str(a), "--end-frame", str(b),
            "--device", device.type]
    if traffic["target"] == "eval":
        argv.append("--eval-only")
    args = get_args(argv)
    loader = LOADERS[cfg["datatype"]](root)
    transform = make_transform(H, W)
    datasets = [TrajFolderDataset(datadir=root, datatype=cfg["datatype"],
                                  transform=transform, start_frame=s,
                                  end_frame=e, loader=loader)
                for s, e in slices]
    trainer = Trainer(args, datasets[-1], device=device, state_dict=sd)
    return trainer, datasets, sd, args


def _slices(cell, n_timed):
    """[start, end) frames of each set-up slice, then the timed one."""
    B = cell.config["batch_size"]
    steps, ww = cell.traffic["warm_steps"], WARM_WINDOWS
    out = [(s * ww * B, (s + 1) * ww * B + 1) for s in range(steps)]
    t0 = steps * ww * B
    return out + [(t0, t0 + n_timed * B + 1)]


def _use(trainer, dataset):
    """Point the trainer at ``dataset``: its samples and its IMU stream,
    built as ``Trainer.__init__`` builds them."""
    from islam_tpu_torch.imu.module import IMUModule
    trainer.dataset = dataset
    trainer.imu_module = IMUModule(
        dataset.accels, dataset.gyros, dataset.imu_dts, dataset.accel_bias,
        dataset.gyro_bias, gravity=dataset.gravity,
        rgb2imu_sync=dataset.rgb2imu_sync, denoise_params=trainer.denoiser,
        denoise_accel=True, denoise_gyro=(dataset.datatype != "kitti"),
        batch_frames=trainer.args.batch_size, device=trainer.device)


def _outputs(traj, B, init):
    """The epoch's answers by window: the program's VO motions, IMU poses,
    PVGO poses and velocities, and the state each window started from."""
    vo = np.asarray(traj.vo_motions, np.float64)
    pg = np.asarray(traj.pgo_poses, np.float64)
    pv = np.asarray(traj.pgo_vels, np.float64)
    ip = np.asarray(traj.imu_poses, np.float64)
    out = []
    for w in range(len(vo) // B):
        if w == 0:
            start = tuple(np.asarray(init[k], np.float64)
                          for k in ("pos", "rot", "vel"))
        else:
            q = pg[w * B, 3:]
            start = (pg[w * B, :3], q / np.linalg.norm(q), pv[w * B])
        s = slice(1 + w * B, 1 + (w + 1) * B)
        out.append({"motions": vo[w * B:(w + 1) * B], "imu_poses": ip[s],
                    "pgo_poses": pg[s], "pgo_vels": pv[s], "start": start})
    return out


def run(cell, seed: int, seconds: float, trace_on: bool, start: float,
        device="cuda", control=False):
    """One run; returns (result dict, the compared numbers).  With
    ``control`` the numbers are the control's (``check.run``)."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    B = cfg["batch_size"]
    n_timed = max(MIN_WINDOWS,
                  math.ceil(seconds * cell.spec["windows_per_s"]))
    cell = SimpleNamespace(**cell._asdict(), n_timed=n_timed)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        slices = _slices(cell, n_timed)
        root = drive.write(cfg["datatype"], workdir, cfg["drive"],
                           slices[-1][1], seed)
        trainer, datasets, sd, args = _setup_program(cell, root, workdir,
                                                     seed, device)
        snap = os.path.join(workdir, "results")
        run_kw = dict(snapshot_dir=snap,
                      snapshot_interval=args.snapshot_interval)
        prog = {"warm": []}
        on_card = device.type == "cuda"
        # ---- set-up: the cell's first steps, through run_epoch ----
        if traffic["target"] == "vo":
            params0 = {k: p.detach().clone()
                       for k, p in trainer.vo_params.items()}
            for s in range(traffic["warm_steps"]):
                epoch = 2 * s + 1
                _use(trainer, datasets[s])
                traj = trainer.run_epoch(epoch, **run_kw)
                prog["warm"].append({
                    "first": slices[s][0],
                    "losses": list(trainer.window_losses[epoch]),
                    "out": _outputs(traj, B, datasets[s].imu_init)})
                if s == 0:
                    prog["grad1"] = {
                        k: (v / (1 - B1)).double().cpu()
                        for k, v in trainer.vo_opt_state["mu"].items()}
            prog["change"] = {k: (p.detach() - params0[k]).double().cpu()
                              for k, p in trainer.vo_params.items()}
            timed_epoch = 2 * traffic["warm_steps"] + 1
        else:
            _use(trainer, datasets[0])
            trainer.run_epoch(0, **run_kw)
            trainer.prev_vo_motions = None
            timed_epoch = 0
        _use(trainer, datasets[-1])
        if on_card:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - start
        # ---- the timed window ----
        tracer = (trace.Tracer(trainer.model, TRACE_SKIP, TRACE_WINDOWS)
                  if trace_on else None)
        t0 = time.perf_counter()
        if tracer is not None:
            with tracer:
                traj = trainer.run_epoch(timed_epoch, **run_kw)
        else:
            traj = trainer.run_epoch(timed_epoch, **run_kw)
        if on_card:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
        lists = {k: list(getattr(trainer, k)[timed_epoch]) for k in (
            "window_seconds", "prep_seconds", "prep_split_seconds",
            "backward_seconds")}
        if trace_on:
            metrics = _per_layer(cell, tracer, lists)
        else:
            metrics = {"pairs_per_s": n_timed * B / window_s,
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        prog["timed"] = _outputs(traj, B, datasets[-1].imu_init)
        prog["timed_start"] = slices[-1][0]
        breakdown = (trace.breakdown(tracer.trace) if tracer is not None
                     else None)
        busy = ((tracer.trace.busy / 1e9, (tracer.trace.end
                                           - tracer.trace.start) / 1e9)
                 if tracer is not None else None)
        # ---- the program's state goes before the reference runs ----
        del trainer, datasets, traj, tracer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checks = check.run(cell, root, sd, weights.denoiser(seed, device),
                           prog, seed, device, control=control)
        result = {
            "metrics": metrics, "breakdown": breakdown, "busy": busy,
            "peak": max(peak, setup_peak) if on_card else 0,
            "attempted": n_timed, "window_s": window_s,
            "failed": report.failed_windows(prog["timed"])}
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _per_layer(cell, tracer, lists):
    tracer.trace = trace.read(tracer.prof)
    H, W = cell.config["image_height"], cell.config["image_width"]
    work = flops.count(H, W, cell.config["batch_size"],
                       cell.traffic["target"] == "vo")
    # the profiler's step k (k >= 1) runs from window k-1's VO forward to
    # window k's: its active steps TRACE_SKIP + 1 .. are windows TRACE_SKIP ..
    traced = set(range(TRACE_SKIP, TRACE_SKIP + TRACE_WINDOWS))
    secs = lists["window_seconds"]
    ctx = SimpleNamespace(
        trace=tracer.trace, traced=TRACE_WINDOWS, epoch=lists,
        work=work, untraced_seconds=[s for i, s in enumerate(secs)
                                     if i not in traced])
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = value
    return out

