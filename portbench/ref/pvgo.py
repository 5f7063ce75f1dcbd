"""The pose-velocity graph of the plain reference: its four weighted
residual blocks (reference pvgo.py:15-143), the solve by the frozen PyPose
replica (``ref/replica.py``) in float64, the re-anchoring to the first
node, and the upper-level VO loss.

Residuals, for nodes T_i (SE3 [t, q]) and world velocities v_i:
  VO       Log(vo^-1 T_i^-1 T_j) of each edge, weighed w0
  IMU vel  dvel_i - (v_{i+1} - v_i), weighed w1
  IMU rot  Log(drot_i^-1 q_i^-1 q_{i+1}), weighed w2
  trans    (t_{i+1} - t_i) - (v_i dt_i + dpos_i), weighed w3
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from portbench.ref import lie
from portbench.ref.replica import pypose_lm_replica


def residual(nodes, vels, edges, motions, drots, dpos, dvels, dts, w):
    n1, n2 = nodes[edges[:, 0]], nodes[edges[:, 1]]
    vo = lie.se3_log(lie.se3_mul(lie.se3_inv(motions),
                                 lie.se3_mul(lie.se3_inv(n1), n2)))
    dv = dvels - (vels[1:] - vels[:-1])
    rot = lie.so3_log(lie.quat_mul(lie.quat_conj(drots), lie.quat_mul(
        lie.quat_conj(nodes[:-1, 3:]), nodes[1:, 3:])))
    tr = (nodes[1:, :3] - nodes[:-1, :3]) - (vels[:-1] * dts[:, None] + dpos)
    return torch.cat([(b * wi).reshape(-1)
                      for b, wi in zip((vo, dv, rot, tr), w)])


class Problem:
    """One window's graph in float64 on the CPU; tensors or arrays in."""

    def __init__(self, edges, motions, drots, dpos, dvels, dts, weights):
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
        self.edges = torch.as_tensor(np.asarray(edges), dtype=torch.long)
        self.theta = tuple(f64(a) for a in (motions, drots, dpos, dvels,
                                            np.reshape(dts, -1)))
        self.w = [float(x) for x in weights[:4]]

    def r(self, nodes, vels):
        return residual(nodes, vels, self.edges, *self.theta, self.w)

    def r_np(self, nodes, vels):
        return self.r(torch.as_tensor(nodes), torch.as_tensor(vels)).numpy()

    def jacobian(self, nodes, vels):
        """(R, 9N) Jacobian at the zero tangent under Exp(xi) o T (poses)
        and v + dv (velocities)."""
        nodes, vels = torch.as_tensor(nodes), torch.as_tensor(vels)
        N = nodes.shape[0]

        def f(d):
            xi, dv = d[:6 * N].reshape(N, 6), d[6 * N:].reshape(N, 3)
            return self.r(lie.se3_retract(nodes, xi), vels + dv)
        return jacfwd(f)(torch.zeros(9 * N, dtype=torch.float64))

    def jacobian_np(self, nodes, vels):
        return self.jacobian(nodes, vels).numpy()

    def solve(self, nodes0, vels0, **config):
        """The replica's LM from (nodes0, vels0): a ReplicaResult, its
        nodes and velocities not yet re-anchored."""
        return pypose_lm_replica(self.r_np, self.jacobian_np,
                                 np.asarray(nodes0, np.float64),
                                 np.asarray(vels0, np.float64), **config)


def align_to(nodes, vels, target):
    """Re-anchor so that nodes[0] == target (pvgo.py:114-119)."""
    nodes, vels, target = (torch.as_tensor(np.asarray(a, np.float64))
                           for a in (nodes, vels, target))
    src = nodes[0]
    vels = lie.quat_rotate(target[3:], lie.quat_rotate(
        lie.quat_conj(src[3:]), vels))
    corr = lie.se3_mul(target, lie.se3_inv(src))
    return lie.se3_mul(corr[None], nodes), vels


def vo_loss(nodes, edges, motions, rot_w, trans_w):
    """rot_w sum |phi|^2 + trans_w sum |tau|^2 of Log(vo^-1 T_i^-1 T_j) on
    constant nodes (the detached coupling, pvgo.py:67-78)."""
    n1, n2 = nodes[edges[:, 0]], nodes[edges[:, 1]]
    err = lie.se3_log(lie.se3_mul(lie.se3_inv(motions),
                                  lie.se3_mul(lie.se3_inv(n1), n2)))
    return (rot_w * torch.sum(err[:, 3:] ** 2)
            + trans_w * torch.sum(err[:, :3] ** 2))
