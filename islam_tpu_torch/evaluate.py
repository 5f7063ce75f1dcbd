"""Evaluate a run's trajectory snapshots against ground truth.

    python -m islam_tpu_torch.evaluate <result_dir> [--with-scale] [--delta N]

The port of ``scripts/evaluate.py``: given a ``--result-dir`` written by
``python -m islam_tpu_torch.train``, computes ATE (Umeyama-aligned
translation RMSE) and RPE (per-step relative translation and rotation) of
every trajectory kind in every epoch directory against ``gt_pose.txt``,
and prints one JSON line per (epoch, kind) and then the best epoch of each
kind.  ``main`` returns the per-(epoch, kind) records.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from islam_tpu_torch.utils.evaluation import ate_rmse, rpe

KINDS = ("vo_pose", "pgo_pose", "imu_pose")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = [a for a in argv if not a.startswith("--")]
    if "--delta" in argv:
        delta_arg = argv[argv.index("--delta") + 1]
        pos.remove(delta_arg)
        delta = int(delta_arg)
    else:
        delta = 1
    if not pos:
        raise SystemExit(__doc__)
    root = pos[0]
    with_scale = "--with-scale" in argv

    gt_path = os.path.join(root, "gt_pose.txt")
    if not os.path.isfile(gt_path):
        raise SystemExit(f"no gt_pose.txt under {root}")
    gt = np.loadtxt(gt_path)

    epochs = sorted((d for d in os.listdir(root)
                     if d.isdigit() and os.path.isdir(os.path.join(root, d))),
                    key=int)
    if not epochs:
        raise SystemExit(f"no epoch directories under {root}")

    best, records = {}, []
    for ep in epochs:
        for kind in KINDS:
            path = os.path.join(root, ep, kind + ".txt")
            if not os.path.isfile(path):
                continue
            est = np.loadtxt(path)
            if est.ndim != 2 or est.shape[1] != 7 or len(est) < 2:
                continue
            n = min(len(est), len(gt))
            ate = ate_rmse(est[:n], gt[:n], with_scale=with_scale)
            rpe_t, rpe_r = rpe(est[:n], gt[:n], delta=delta)
            rec = {"epoch": int(ep), "kind": kind, "frames": n,
                   "ate": round(ate, 6), "rpe_trans": round(rpe_t, 6),
                   "rpe_rot": round(rpe_r, 6)}
            print(json.dumps(rec))
            records.append(rec)
            if kind not in best or ate < best[kind]["ate"]:
                best[kind] = rec

    for kind, rec in best.items():
        print(json.dumps({"best_" + kind: rec}))
    return records


if __name__ == "__main__":
    main()
