"""Imperative-learning study on synthetic data.

Counterpart of ``scripts/demo_imperative.py``: the full bi-level loop for N
epochs (alternating 'vo'/'imu' targets, the reference's schedule) on one
synthetic sequence, printing per epoch the ATE and the rotation RPE of the
raw-VO and of the PVGO trajectories against the ground truth, then a
summary of the VO ATE's change.  The reference's headline result is that
imperative iterations reduce the VO error (README.md:15,33).

Usage: python -m islam_tpu_torch.demo_imperative [epochs] [lr] [--f32]
           [--bilevel=detached|implicit|unrolled] [--device cuda|cpu]

Defaults: 8 epochs, lr 1e-4, the VO networks in bfloat16 (``--bf16``);
``--f32`` runs them in float32 with TF32 off (the bf16 accuracy study:
the same data and init, only the compute type differs).  ``--bilevel``
picks the coupling through the PVGO solve (detached = the reference's;
implicit = implicit function theorem; unrolled = through the damped
Gauss-Newton steps): the same data and init, only the upper-level gradient
differs.  The data is ``testing.make_dataset(num_frames=33, height=448,
width=640)`` (4 windows of 8), the trainer the port's ``train.Trainer`` with
Adam for the pose head, the ground-truth scale and the KITTI preset's loss
weights, from ``tvo.init_model(..., seed=0)``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from islam_tpu_torch import testing
from islam_tpu_torch.arguments import get_args
from islam_tpu_torch.pvgo.run import BILEVEL
from islam_tpu_torch.train import Trainer
from islam_tpu_torch.utils.evaluation import ate_rmse, rpe


def study_args(lr: float, bf16: bool, bilevel: str, batch_size: int = 8,
               device: str = "cuda"):
    """The trainer's flags: the JAX script's ``Args`` through the port's
    parser."""
    return get_args([
        "--data-type", "synthetic", "--batch-size", str(batch_size),
        "--vo-optimizer", "adam", "--loss-weight", "(1,0.1,10,0.1)",
        "--rot-w", "1", "--trans-w", "0.1", "--use-gt-scale",
        "--print-interval", "0", "--lr", repr(float(lr)),
        "--bilevel", bilevel, "--device", device,
        *(["--bf16"] if bf16 else [])])


def epoch_record(epoch, bilevel, target, traj, gt_poses, seconds):
    """The JAX script's per-epoch record (scripts/demo_imperative.py:73-84)
    of one epoch's trajectories."""
    vo = np.stack(traj.vo_poses)
    pgo = np.stack(traj.pgo_poses)
    n = len(pgo)
    gt = gt_poses[:n]
    return {
        "epoch": epoch,
        "bilevel": bilevel,
        "target": target,
        "ate_vo": round(ate_rmse(vo[:n], gt), 6),
        "ate_pgo": round(ate_rmse(pgo, gt), 6),
        "rpe_rot_vo": round(rpe(vo[:n], gt)[1], 6),
        "rpe_rot_pgo": round(rpe(pgo, gt)[1], 6),
        "wall_s": round(seconds, 1),
    }


def run_study(epochs: int, lr: float, bf16: bool, bilevel: str, *,
              num_frames: int = 33, height: int = 448, width: int = 640,
              batch_size: int = 8, device: str = "cuda", state_dict=None,
              on_epoch=None):
    """Epochs 1..``epochs`` of the study; returns their records.

    ``state_dict`` is the VONet's start (default ``tvo.init_model`` seed 0).
    ``on_epoch(epoch, trainer, traj, record)``, if given, is called after
    each epoch."""
    if device.startswith("cuda"):
        # float32 means float32: cuDNN's default TF32 convolutions would
        # keep only ~3 decimal digits (as train.main)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ds = testing.make_dataset(num_frames=num_frames, height=height,
                              width=width)
    trainer = Trainer(study_args(lr, bf16, bilevel, batch_size, device), ds,
                      device=device, state_dict=state_dict)
    history = []
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        traj = trainer.run_epoch(epoch)
        rec = epoch_record(epoch, bilevel, trainer.train_target[epoch], traj,
                           ds.poses, time.time() - t0)
        history.append(rec)
        if on_epoch is not None:
            on_epoch(epoch, trainer, traj, rec)
    return history


def summary(history):
    """The JAX script's closing line (scripts/demo_imperative.py:86-91)."""
    first_vo = history[0]["ate_vo"]
    last_vo = history[-1]["ate_vo"]
    return {"vo_ate_first": first_vo, "vo_ate_last": last_vo,
            "vo_ate_change_pct": round(100 * (last_vo - first_vo) / first_vo,
                                       2)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="imperative-learning study on synthetic data")
    parser.add_argument("epochs", nargs="?", type=int, default=8)
    parser.add_argument("lr", nargs="?", type=float, default=1e-4)
    parser.add_argument("--f32", action="store_true",
                        help="run the VO networks in float32 (default "
                             "bfloat16)")
    parser.add_argument("--bilevel", default="detached", choices=BILEVEL)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    history = run_study(
        args.epochs, args.lr, not args.f32, args.bilevel, device=args.device,
        on_epoch=lambda epoch, trainer, traj, rec: print(json.dumps(rec),
                                                         flush=True))
    print(json.dumps(summary(history)), flush=True)
    return history


if __name__ == "__main__":
    main()
