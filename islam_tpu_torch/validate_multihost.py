"""Two-process validation of the multi-sequence path across processes.

Counterpart of ``scripts/validate_multihost.py``.  The parent starts TWO
Python processes that join one ``torch.distributed`` group over local TCP
(``initialize_distributed``), each loading only its own 2 of the 4
synthetic sequences (``host_local_batch_slice``; sequence 1 on its own
calibration, ``testing.make_sequences``).  Each rank:

1. feeds them through ``global_shard_batch`` / ``global_replicate`` and
   runs one 'vo' ``multi_sequence_train_step``, whose gradient mean over
   the 4 sequences is one all-reduce across the processes, then one Adam
   step of the pose head;
2. runs ``MultiSequenceTrainer`` on them: epoch 1 ('vo') and epoch 2
   ('imu' replay), one window each, with per-sequence snapshots under
   ``{out}/snapshots/seq{i}/``; saves after epoch 2 under ``{out}/models``
   (rank 0 writes) and resumes the save into a fresh trainer built without
   a denoiser, which must restore every rank's state bitwise.

Each rank prints its losses, checksums of the all-reduced gradients, hashes
of its updated parameters, the collectives' ms and bytes and its
correlation launches.  The parent fails unless both children exit 0 and
print "ok", the ranks' checksums and hashes are equal, and both resumed.

Backend: gloo, on the CPU and on the card, where it reduces through the
host and so runs both ranks on one GPU (NCCL refuses two ranks on one
GPU).

Usage: python -m islam_tpu_torch.validate_multihost [--device cuda|cpu]
           [--height 448 --width 640 --batch-size 8] [--bf16] [--out DIR]
       (internal) ... --child <pid> <port>
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from islam_tpu_torch import optim, testing
from islam_tpu_torch.imu.denoiser import IMUDenoiser, init_denoiser
from islam_tpu_torch.models import tartanvo as tvo
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.ops import correlation as corr
from islam_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT, free_port,
                                           global_replicate,
                                           global_shard_batch,
                                           host_local_batch_slice,
                                           initialize_distributed,
                                           make_global_mesh,
                                           multi_sequence_train_step, stack)
from islam_tpu_torch.parallel.trainer import MultiSequenceTrainer
from islam_tpu_torch.train import pose_params

N_SEQ = 4   # global sequences; 2 per process
PROCS = 2
STEP = dict(target="vo", datatype="kitti", correct_scale=False,
            use_kitti_coord=True, denoise_accel=True, denoise_gyro=False,
            loss_weight=(1.0, 0.1, 10.0, 0.1), rot_w=1.0, trans_w=0.1)
LR, IMU_LR = 3e-6, 3e-5


def _sha256(tensors):
    sha = hashlib.sha256()
    for k in sorted(tensors):
        sha.update(tensors[k].detach().cpu().numpy().tobytes())
    return sha.hexdigest()


def _checksum(grads):
    return float(sum(g.double().abs().sum() for g in grads.values()))


def _finite(*tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def initial_weights(height, width):
    """What every rank starts from, as CPU state dicts: the VO weights
    (``tvo.init_model`` seed 0) and the seed-1 denoiser."""
    return (tvo.init_model(height, width, seed=0, device="cpu").state_dict(),
            init_denoiser(1, "cpu").state_dict())


def run_step(mesh, sequences, height, width, batch_size, weights,
             **step_kw):
    """One 'vo' multi-sequence step over this rank's ``sequences`` (global
    indices; ``testing.make_sequences`` of B+1 frames) from ``weights``
    (``initial_weights``), then one Adam step of the pose head: the window
    ``run_trainer``'s 'vo' epoch runs.  Returns what a rank prints."""
    B = batch_size
    sd, dn_sd = weights
    datasets = testing.make_sequences(sequences, B + 1, height, width)
    imus = [testing.make_imu_module(ds, B, dn_sd, device="cpu")
            for ds in datasets]
    inputs = [testing.make_step_inputs(ds, imu, 0, B, "cpu")
              for ds, imu in zip(datasets, imus)]
    batches, wins, inits = (global_shard_batch(mesh, stack(list(x)))
                            for x in zip(*inputs))
    # each sequence's own calibration, assembled per rank like the batches
    consts = [global_shard_batch(mesh, torch.stack([
        torch.as_tensor(np.asarray(c)) for c in col])) for col in (
        [np.asarray(ds.rgb2imu_pose, np.float32) for ds in datasets],
        [m.gravity for m in imus], [m.accel_bias for m in imus],
        [m.gyro_bias for m in imus], [m.optm_bias for m in imus])]

    model = VONet(height, width).to(mesh.device)
    model.load_state_dict(global_replicate(mesh, sd))
    denoiser = IMUDenoiser().to(mesh.device)
    denoiser.load_state_dict(global_replicate(mesh, dn_sd))

    step = multi_sequence_train_step(mesh, **STEP, **step_kw)
    record = {}
    corr.LAUNCHES = corr.LAUNCHES_ALL = 0
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    loss, grads, _ = step(model, denoiser, batches, wins, inits, *consts,
                          None, record=record)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    step_s = time.perf_counter() - t0
    launches = {"correlation": corr.LAUNCHES,
                "correlation_all": corr.LAUNCHES_ALL}

    params = pose_params(model)
    opt = optim.adam(LR)
    updates, _ = opt.update(grads, opt.init(params))
    optim.apply_updates(params, updates)
    return {
        "rank": mesh.rank, "sequences": list(sequences),
        "loss": float(loss), "finite": _finite(loss, *grads.values()),
        "grad_checksum": _checksum(grads),
        "grad_tensors": len(grads), "params_sha256": _sha256(params),
        "step_s": step_s, "collective_ms": record["ms"],
        "collective_bytes": record["bytes"],
        "collective_clock": record["clock"], "launches": launches,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                           if mesh.device.type == "cuda" else None),
        "device": str(mesh.device), "backend": dist.get_backend()}


def run_trainer(mesh, sequences, height, width, batch_size, out, weights,
                **kw):
    """``MultiSequenceTrainer`` over this rank's ``sequences`` (global
    indices, as ``run_step``) from ``weights``: epoch 1 ('vo') and epoch 2
    ('imu'), one window each, snapshots under ``{out}/snapshots``; a save
    after epoch 2 under ``{out}/models`` and its resume into a fresh
    trainer built without a denoiser.  Returns what a rank prints."""
    B = batch_size
    sd, dn_sd = weights

    def trainer(denoiser):
        return MultiSequenceTrainer(
            testing.make_sequences(sequences, B + 1, height, width),
            batch_size=B, lr=LR, imu_lr=IMU_LR, mesh=mesh, state_dict=sd,
            denoiser_state_dict=dn_sd if denoiser else None,
            device=mesh.device, **kw)

    tr = trainer(True)
    losses, checksums, launches, finite = [], [], [], True
    for epoch in (1, 2):
        corr.LAUNCHES = corr.LAUNCHES_ALL = 0
        losses.append(tr.run_epoch(epoch=epoch, snapshot_dir=os.path.join(
            out, "snapshots")))
        launches.append({"correlation": corr.LAUNCHES,
                         "correlation_all": corr.LAUNCHES_ALL})
        checksums.append(_checksum(tr.last_grads))
        finite &= _finite(torch.tensor(losses[-1]),
                          *tr.last_grads.values())
    models = os.path.join(out, "models")
    tr.save_models(models, 2)
    fresh = trainer(False)
    restored = fresh.resume(models, start_epoch=3)
    unequal = testing.unequal_paths(fresh.checkpoint_state(),
                                    tr.checkpoint_state())
    unequal += [f"own carries {s}" for s, (a, b) in enumerate(zip(
        fresh._init_states, tr._init_states))
        if any(not np.array_equal(a[k], b[k]) for k in a)]
    return {"trainer_losses": losses, "trainer_grad_checksums": checksums,
            "trainer_finite": finite, "trainer_launches": launches,
            "trainer_params_sha256": _sha256(dict(tr.vo_params,
                                                  **tr.imu_params)),
            "trainer_window_ms": {e: [x * 1e3 for x in v]
                                  for e, v in tr.window_seconds.items()},
            "trainer_collective": tr.collective,
            "resumed": restored == 2 and not unequal,
            "resume_unequal": unequal}


def child(pid, port, args):
    initialize_distributed(f"localhost:{port}", PROCS, pid,
                           device=args.device, backend="gloo",
                           timeout=args.timeout)
    try:
        if dist.get_world_size() != PROCS:
            raise RuntimeError(f"world size {dist.get_world_size()}")
        mesh = make_global_mesh(device=args.device)
        own = range(N_SEQ)[host_local_batch_slice(N_SEQ)]
        weights = initial_weights(args.height, args.width)
        out = run_step(mesh, own, args.height, args.width, args.batch_size,
                       weights, bf16=args.bf16)
        out.update(run_trainer(mesh, own, args.height, args.width,
                               args.batch_size, args.out, weights,
                               bf16=args.bf16))
        if not (out["finite"] and out["trainer_finite"]):
            raise RuntimeError(f"nonfinite loss or gradient: {out}")
        if not out["resumed"]:
            raise RuntimeError(f"resume: {out['resume_unequal']}")
        print("RESULT " + json.dumps(out), flush=True)
        print(f"child {pid} ok: loss={out['loss']:.6f}, "
              f"{out['grad_tensors']} grad tensors", flush=True)
    finally:
        dist.destroy_process_group()


def parent(args):
    """Start both children, wait for them (killing them at the time
    limit), check them, print one JSON line; raises on any failure.  The
    children write under ``args.out``, or a temporary directory removed on
    the way out."""
    if args.out is None:
        with tempfile.TemporaryDirectory() as tmp:
            args.out = tmp
            return parent(args)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", "islam_tpu_torch.validate_multihost",
            "--device", args.device, "--height", str(args.height),
            "--width", str(args.width), "--batch-size", str(args.batch_size),
            "--timeout", str(args.timeout), "--out", args.out] + (
                ["--bf16"] if args.bf16 else [])
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile("w+") for _ in range(PROCS)]
    procs = [subprocess.Popen(argv + ["--child", str(pid), str(port)],
                              stdout=log, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for pid, log in enumerate(logs)]
    try:
        deadline = time.monotonic() + args.wait
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    failed, ranks = [], []
    for pid, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out = log.read()
        log.close()
        tail = "\n".join(out.strip().splitlines()[-8:])
        print(f"--- process {pid} (exit {p.returncode}) ---\n{tail}",
              flush=True)
        results = [json.loads(line[len("RESULT "):])
                   for line in out.splitlines() if line.startswith("RESULT ")]
        if p.returncode != 0 or f"child {pid} ok" not in out or not results:
            failed.append(pid)
        else:
            ranks.append(results[0])
    if failed:
        raise SystemExit(f"multihost validation FAILED: process(es) "
                         f"{failed}")
    for key in ("loss", "grad_checksum", "params_sha256", "trainer_losses",
                "trainer_grad_checksums", "trainer_params_sha256"):
        if len({json.dumps(r[key]) for r in ranks}) != 1:
            raise SystemExit(f"multihost validation FAILED: ranks disagree "
                             f"on {key}: {[r[key] for r in ranks]}")
    print(json.dumps({"validate_multihost": "ok", "processes": PROCS,
                      "sequences": N_SEQ, "wall_s": wall,
                      "size": [args.height, args.width, args.batch_size],
                      "bf16": args.bf16, "ranks": ranks}), flush=True)
    print(f"multihost validation OK: {PROCS} processes x {N_SEQ // PROCS} "
          "sequences, cross-process gradient all-reduce, trainer epochs, "
          "save and resume", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--height", type=int, default=448)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="the VO networks in bfloat16 (train_step's bf16)")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                    help="seconds a collective may wait")
    ap.add_argument("--wait", type=float, default=1800.0,
                    help="seconds the parent waits for both children")
    ap.add_argument("--out", default=None,
                    help="directory for the trainer's snapshots and save "
                    "(default: a temporary one)")
    ap.add_argument("--child", nargs=2, type=int, metavar=("PID", "PORT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_multihost: --device cuda, but torch sees "
                         "no GPU (pass --device cpu)")
    if args.child:
        child(args.child[0], args.child[1], args)
    else:
        parent(args)


if __name__ == "__main__":
    main()
