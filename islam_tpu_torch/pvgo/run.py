"""PVGO solve: weighted residuals, LM, upper-level losses.

Counterpart of ``islam_tpu/pvgo/run.py`` (reference pvgo.py:122-205), with
its three bi-level couplings:

- ``detached`` (the reference's): the solver sees detached inputs, the
  converged nodes are constants, and the upper-level loss carries gradients
  to the VO motions ('vo') or the IMU deltas ('imu') only.  On the card the
  solve is one CUDA graph replay (``lm_solve_graphed``), without the fifth
  factor;
- ``implicit``: implicit-function-theorem gradients through the LM solution;
- ``unrolled``: reverse mode through ``LMConfig.max_steps // 2`` damped
  Gauss-Newton steps.

In the last two the 'vo' loss also reaches the VO motions through the
solution.  An optional fifth factor, a reprojection loss (``reproj``), joins
the four blocks in every mode.
"""

from __future__ import annotations

import torch

from islam_tpu_torch.pvgo import graph as G
from islam_tpu_torch.pvgo.lm import (LMConfig, lm_solve_graphed,
                                     lm_solve_implicit, lm_solve_unrolled)

BILEVEL = ("detached", "implicit", "unrolled")


def run_pvgo(init_nodes, init_vels, vo_motions, links, dts, imu_drots,
             imu_dtrans, imu_dvels, radius: float = 1e4,
             loss_weight=(1., 1., 1., 1.), reproj=None, target: str = "vo",
             bilevel: str = "detached"):
    """Solve the pose-velocity graph and return the imperative losses.

    init_nodes (B+1, 7) initial poses (the IMU world poses), init_vels
    (B+1, 3), vo_motions (E, 7), links (E, 2) int, dts (M,), imu_drots
    (M, 4), imu_dtrans / imu_dvels (M, 3).  ``loss_weight`` = (vo, imu_vel,
    imu_rot, transvel[, reproj]); the information matrices are diag(w^2).
    ``reproj`` (``ops/dense_ba.py``) adds the reprojection factor, weighted
    by ``loss_weight[4]`` (default 1) over its point count.

    Returns (trans_loss, rot_loss, nodes (B+1, 7), vels (B+1, 3), covs);
    nodes/vels are re-anchored to init_nodes[0] and detached.
    """
    if bilevel not in BILEVEL:
        raise ValueError(f"unknown bilevel mode {bilevel!r}")
    w = [float(x) for x in loss_weight[:4]]
    w4 = float(loss_weight[4]) if len(loss_weight) > 4 else 1.0
    dts = dts.reshape(-1, 1).to(init_vels.dtype)
    dtrans_d = imu_dtrans.detach()

    def residual_all(nodes, vels, tensors):
        links, dts, dtrans, poses, drots, dvels, *reproj_tensors = tensors
        blocks = G.pvgo_residuals(nodes, vels, links, poses, drots, dtrans,
                                  dvels, dts)
        # sqrt(info) scaling: ||w r||^2 = r^T diag(w^2) r (pvgo.py:125-143)
        out = [(b * wi).reshape(-1) for b, wi in zip(blocks, w)]
        if reproj is not None:
            # info (w4/N)^2 per keypoint (pvgo.py:130-131); the dense
            # per-frame mean is one residual per edge (N = 1)
            rerr = G.reproj_residual(nodes, reproj.replace(reproj_tensors))
            out.append((rerr * (w4 / max(rerr.shape[1] // 2, 1))).reshape(-1))
        return torch.cat(out)

    def residual_theta(nodes, vels, theta):
        return residual_all(nodes, vels, (links, dts, dtrans_d, *theta))

    theta = (vo_motions, imu_drots, imu_dvels,
             *(() if reproj is None else reproj.tensors()))
    nodes0, vels0 = init_nodes.detach(), init_vels.detach()
    cfg = LMConfig(radius=radius)
    if bilevel == "detached":
        # one CUDA graph on the card; the dense factor's mask is not one of
        # its tensors, so with the factor the solve runs op by op
        nodes, vels, _, _ = lm_solve_graphed(
            residual_all, (links, dts, dtrans_d, *theta), nodes0, vels0, cfg,
            key=None if reproj is not None else ("pvgo", tuple(w)))
    elif bilevel == "implicit":
        nodes, vels = lm_solve_implicit(residual_theta, theta, nodes0, vels0,
                                        cfg)
    else:
        nodes, vels = lm_solve_unrolled(
            lambda n, v: residual_theta(n, v, theta), nodes0, vels0,
            iters=cfg.max_steps // 2, config=cfg)

    if target == "vo":
        trans_loss, rot_loss = G.vo_loss(nodes, links, vo_motions,
                                         detach_nodes=bilevel == "detached")
    elif target == "imu":
        trans_loss, rot_loss = G.imu_loss(nodes, vels, imu_drots, imu_dvels)
    else:
        trans_loss = torch.zeros(links.shape[0], dtype=init_vels.dtype,
                                 device=init_vels.device)
        rot_loss = torch.zeros_like(trans_loss)

    # Re-anchor to the original first pose and detach (pvgo.py:195-197).
    nodes, vels = G.align_to(nodes.detach(), vels.detach(),
                             init_nodes[0].detach())
    n_edges, n_imu = links.shape[0], init_nodes.shape[0] - 1

    def full(n, v):
        return torch.full((n,), v, dtype=init_vels.dtype,
                          device=init_vels.device)

    covs = {"vo_rot": full(n_edges, w[0] ** 2),
            "vo_trans": full(n_edges, w[0] ** 2),
            "imu_rot": full(n_imu, w[2] ** 2),
            "imu_vel": full(n_imu, w[1] ** 2),
            "transvel": full(n_imu, w[3] ** 2)}
    if reproj is not None and len(loss_weight) > 4:
        covs["reproj"] = full(n_imu, (w4 / getattr(reproj, "N", 1)) ** 2)
    return trans_loss, rot_loss, nodes, vels, covs
