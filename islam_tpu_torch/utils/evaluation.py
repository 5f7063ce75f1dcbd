"""Trajectory evaluation: ATE / RPE with SE(3)/Sim(3) alignment.

A copy of ``islam_tpu/utils/evaluation.py``.  ATE is the RMSE of the
translation residuals after Umeyama alignment of the estimated trajectory
to ground truth; RPE the per-step relative-pose error.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation as R


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning x (N,3) onto y (N,3).

    Returns (R, t, s) with y ~ s * R @ x + t.
    """
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / x.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_x)
    else:
        s = 1.0
    t = mu_y - s * rot @ mu_x
    return rot, t, s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (translation RMSE) after alignment.

    Poses are (N, 7) [t, q] rows (the snapshot format of train.py:51-61).
    """
    est = np.asarray(est_poses)[:, :3]
    gt = np.asarray(gt_poses)[:, :3]
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    rot, t, s = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (rot @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def _se3(p) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R.from_quat(p[3:]).as_matrix()
    T[:3, 3] = p[:3]
    return T


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error: (trans RMSE, rot RMSE in radians) over steps of
    ``delta`` frames."""
    def rel(poses, i, j):
        return np.linalg.inv(_se3(poses[i])) @ _se3(poses[j])

    n = min(len(est_poses), len(gt_poses))
    terrs, rerrs = [], []
    for i in range(n - delta):
        E = np.linalg.inv(rel(gt_poses, i, i + delta)) @ rel(
            est_poses, i, i + delta)
        terrs.append(np.linalg.norm(E[:3, 3]))
        rerrs.append(np.linalg.norm(R.from_matrix(E[:3, :3]).as_rotvec()))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
