"""Pose-velocity factor graph residuals and upper-level (imperative) losses.

Counterpart of ``islam_tpu/pvgo/graph.py`` (reference pvgo.py:15-119).  Nodes
are B+1 SE3 poses plus B+1 world velocities; the four residual blocks:

  (a) VO relative pose:      (vo.Inv() @ n1.Inv() @ n2).Log()        -> (E, 6)
  (b) IMU delta velocity:    imu_dvels - diff(vels)                  -> (M, 3)
  (c) IMU relative rotation: (drot.Inv() @ r1.Inv() @ r2).Log()      -> (M, 3)
  (d) translation-velocity:  diff(trans) - (vels[:-1]*dt + dtrans)   -> (M, 3)
"""

from __future__ import annotations

import torch

from islam_tpu_torch import lie


def pvgo_residuals(nodes, vels, edges, poses, imu_drots, imu_dtrans,
                   imu_dvels, dts):
    """nodes (N, 7), vels (N, 3), edges (E, 2) int, poses (E, 7) VO motions,
    imu_drots (M, 4), dts (M,) or (M, 1).  Returns the 4 blocks."""
    dts = dts.reshape(-1, 1).to(vels.dtype)
    n1 = nodes[edges[:, 0]]
    n2 = nodes[edges[:, 1]]
    pgerr = lie.se3_log(lie.se3_mul(lie.se3_inv(poses),
                                    lie.se3_mul(lie.se3_inv(n1), n2)))
    adjvelerr = imu_dvels - (vels[1:] - vels[:-1])
    imuroterr = lie.so3_log(lie.quat_mul(
        lie.quat_conj(imu_drots),
        lie.quat_mul(lie.quat_conj(nodes[:-1, 3:]), nodes[1:, 3:])))
    trans = nodes[:, :3]
    transvelerr = (trans[1:] - trans[:-1]) - (vels[:-1] * dts + imu_dtrans)
    return pgerr, adjvelerr, imuroterr, transvelerr


def reproj_residual(nodes, reproj):
    """The optional fifth factor (pvgo.py:53-61): ``reproj`` (a Dense or
    Sparse reprojection loss) of the consecutive-node motions, as (M, n):
    one column for the dense per-frame mean, N*2 for N keypoints."""
    err = reproj(lie.se3_mul(lie.se3_inv(nodes[:-1]), nodes[1:]))
    return err[:, None] if err.dim() == 1 else err.reshape(err.shape[0], -1)


def vo_loss(nodes, edges, poses, detach_nodes: bool = True):
    """Upper-level VO loss (pvgo.py:67-78).  With ``detach_nodes`` (the
    reference's coupling) gradients reach ``poses`` only; without, they also
    flow through the nodes, as the implicit and unrolled modes need
    (pvgo.py:81-92).  Returns per-edge (trans, rot)."""
    if detach_nodes:
        nodes = nodes.detach()
    err = lie.se3_log(lie.se3_mul(
        lie.se3_inv(poses),
        lie.se3_mul(lie.se3_inv(nodes[edges[:, 0]]), nodes[edges[:, 1]])))
    return torch.sum(err[:, :3] ** 2, dim=1), torch.sum(err[:, 3:] ** 2, dim=1)


def imu_loss(nodes, vels, imu_drots, imu_dvels):
    """Upper-level IMU loss on the detached solution (pvgo.py:95-111):
    gradients reach ``imu_drots``/``imu_dvels`` only."""
    nodes, vels = nodes.detach(), vels.detach()
    adjvelerr = imu_dvels - (vels[1:] - vels[:-1])
    imuroterr = lie.so3_log(lie.quat_mul(
        lie.quat_conj(imu_drots),
        lie.quat_mul(lie.quat_conj(nodes[:-1, 3:]), nodes[1:, 3:])))
    return (torch.sum(adjvelerr ** 2, dim=1),
            torch.sum(imuroterr ** 2, dim=1))


def align_to(nodes, vels, target, idx: int = 0):
    """Re-anchor the solution so nodes[idx] == target (pvgo.py:114-119)."""
    source = nodes[idx]
    vels_out = lie.quat_rotate(target[3:],
                               lie.quat_rotate(lie.quat_conj(source[3:]), vels))
    correction = lie.se3_mul(target, lie.se3_inv(source))
    return lie.se3_mul(correction[None], nodes), vels_out
