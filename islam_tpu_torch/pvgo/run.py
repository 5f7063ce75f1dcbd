"""PVGO solve: weighted residuals, LM, upper-level losses.

Counterpart of ``islam_tpu/pvgo/run.py`` (reference pvgo.py:122-205) for the
reference's detached bi-level coupling: the solver sees detached inputs, the
converged nodes are constants, and the upper-level loss carries gradients to
the VO motions ('vo') or the IMU deltas ('imu') only.  The implicit and
unrolled modes and the reprojection factor are not ported yet.
"""

from __future__ import annotations

import torch

from islam_tpu_torch.pvgo import graph as G
from islam_tpu_torch.pvgo.lm import LMConfig, lm_solve_manifold


def run_pvgo(init_nodes, init_vels, vo_motions, links, dts, imu_drots,
             imu_dtrans, imu_dvels, radius: float = 1e4,
             loss_weight=(1., 1., 1., 1.), target: str = "vo",
             bilevel: str = "detached"):
    """Solve the pose-velocity graph and return the imperative losses.

    init_nodes (B+1, 7) initial poses (the IMU world poses), init_vels
    (B+1, 3), vo_motions (E, 7), links (E, 2) int, dts (M,), imu_drots
    (M, 4), imu_dtrans / imu_dvels (M, 3).  ``loss_weight`` = (vo, imu_vel,
    imu_rot, transvel); the information matrices are diag(w^2).

    Returns (trans_loss, rot_loss, nodes (B+1, 7), vels (B+1, 3), covs);
    nodes/vels are re-anchored to init_nodes[0] and detached.
    """
    if bilevel != "detached":
        raise NotImplementedError(f"bilevel={bilevel!r} is not ported yet")
    w = [float(x) for x in loss_weight[:4]]
    dts = dts.reshape(-1, 1).to(init_vels.dtype)
    poses_d, drots_d = vo_motions.detach(), imu_drots.detach()
    dtrans_d, dvels_d = imu_dtrans.detach(), imu_dvels.detach()

    def residual_fn(nodes, vels):
        blocks = G.pvgo_residuals(nodes, vels, links, poses_d, drots_d,
                                  dtrans_d, dvels_d, dts)
        # sqrt(info) scaling: ||w r||^2 = r^T diag(w^2) r (pvgo.py:125-143)
        return torch.cat([(b * wi).reshape(-1) for b, wi in zip(blocks, w)])

    nodes, vels, _, _ = lm_solve_manifold(
        residual_fn, init_nodes.detach(), init_vels.detach(),
        LMConfig(radius=radius))

    if target == "vo":
        trans_loss, rot_loss = G.vo_loss(nodes, links, vo_motions)
    elif target == "imu":
        trans_loss, rot_loss = G.imu_loss(nodes, vels, imu_drots, imu_dvels)
    else:
        trans_loss = torch.zeros(links.shape[0], dtype=init_vels.dtype,
                                 device=init_vels.device)
        rot_loss = torch.zeros_like(trans_loss)

    # Re-anchor to the original first pose and detach (pvgo.py:195-197).
    nodes, vels = G.align_to(nodes, vels, init_nodes[0].detach())
    n_edges, n_imu = links.shape[0], init_nodes.shape[0] - 1

    def full(n, v):
        return torch.full((n,), v, dtype=init_vels.dtype,
                          device=init_vels.device)

    covs = {"vo_rot": full(n_edges, w[0] ** 2),
            "vo_trans": full(n_edges, w[0] ** 2),
            "imu_rot": full(n_imu, w[2] ** 2),
            "imu_vel": full(n_imu, w[1] ** 2),
            "transvel": full(n_imu, w[3] ** 2)}
    return trans_loss, rot_loss, nodes.detach(), vels.detach(), covs
