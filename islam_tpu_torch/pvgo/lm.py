"""Levenberg-Marquardt on the SE(3)^N x R^{3N} product manifold.

Counterpart of ``islam_tpu/pvgo/lm.py`` (``lm_solve_manifold``), which
reproduces the PyPose stack the reference uses (pvgo.py:169-180): Cholesky
solver, ``TrustRegion(radius=1e4)``, ``LM(min=1e-4, reject=16)`` and
``StopOnPlateau(steps=10, patience=3, decreasing=1e-3)``:

- damped normal matrix A = J^T J + diag(clamp(diag(J^T J), min, max)) / radius;
- after every trial the step quality rho = (actual decrease) / (decrease the
  linear model ||r + J d||^2 predicts) grows the radius by ``radius_up`` if
  rho > ``quality_factor``, else shrinks it by ``radius_down``;
- a trial whose cost is worse than the current one (or NaN) is rolled back
  and retried with the new radius and the same Jacobian, up to
  ``max_rejects`` times in one step;
- stop after ``max_steps`` steps, or once the relative cost decrease stayed
  below ``decreasing`` for ``patience`` consecutive steps.

The Jacobian is ``torch.func.jacfwd`` of the residual at the zero tangent
(pose update Exp(xi) o T, velocity update additive).  The loop control runs
on the host: each trial's accept test and each step's plateau test read one
scalar from the device (``.item()``).  The graph is tiny (81 unknowns at
B=8), so those reads cost little next to the VO forward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from islam_tpu_torch import lie


class LMConfig(NamedTuple):
    radius: float = 1e4          # initial trust-region radius (pvgo.py:170)
    damping_min: float = 1e-4    # diagonal clamp floor (pvgo.py:171 `min`)
    damping_max: float = 1e32    # diagonal clamp ceiling (pp.optim.LM `max`)
    max_steps: int = 10          # StopOnPlateau steps (pvgo.py:172)
    patience: int = 3            # StopOnPlateau patience
    decreasing: float = 1e-3     # StopOnPlateau relative-decrease threshold
    radius_up: float = 2.0       # TrustRegion growth factor `up`
    radius_down: float = 0.5     # TrustRegion shrink factor `down`
    radius_max: float = 1e16
    radius_min: float = 1e-6
    quality_factor: float = 1e-3  # TrustRegion quality threshold `factor`
    max_rejects: int = 16        # pp.optim.LM `reject`


def _apply_delta(nodes, vels, delta):
    N = nodes.shape[0]
    xi = delta[:6 * N].reshape(N, 6)
    dv = delta[6 * N:].reshape(N, 3)
    return lie.se3_retract(nodes, xi), vels + dv


def lm_solve_manifold(residual_fn: Callable, nodes0: torch.Tensor,
                      vels0: torch.Tensor, config: LMConfig = LMConfig()):
    """Minimize ||residual_fn(nodes, vels)||^2 over SE3 nodes + velocities.

    residual_fn: (nodes (N, 7), vels (N, 3)) -> flat weighted residual (R,).
    Returns (nodes, vels, final_cost, steps_taken); the start values are
    treated as constants.
    """
    nodes, vels = nodes0.detach(), vels0.detach()
    zero = torch.zeros(9 * nodes.shape[0], dtype=vels.dtype,
                       device=vels.device)
    cost = torch.sum(residual_fn(nodes, vels) ** 2)
    radius = torch.tensor(config.radius, dtype=vels.dtype, device=vels.device)
    patience = step = 0
    while step < config.max_steps and patience < config.patience:
        J = jacfwd(lambda d: residual_fn(*_apply_delta(nodes, vels, d)))(zero)
        r = residual_fn(nodes, vels)
        H = J.T @ J
        g = J.T @ r
        # pp.optim.LM: damping acts on the clamped diagonal of J^T J.
        diag_clamped = torch.clamp(torch.diagonal(H), config.damping_min,
                                   config.damping_max)
        last = cost
        for _ in range(config.max_rejects):
            L, info = torch.linalg.cholesky_ex(
                H + torch.diag(diag_clamped / radius))
            delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
            # A failed factorization gives NaN, which the accept test rejects
            delta = torch.where(info == 0, delta, torch.nan)
            new_nodes, new_vels = _apply_delta(nodes, vels, delta)
            new_cost = torch.sum(residual_fn(new_nodes, new_vels) ** 2)
            Jd = J @ delta
            predicted = -(Jd @ (2.0 * r + Jd))
            quality = (last - new_cost) / torch.clamp(predicted, min=1e-30)
            radius = torch.where(
                quality > config.quality_factor,
                torch.clamp(radius * config.radius_up, max=config.radius_max),
                torch.clamp(radius * config.radius_down,
                            min=config.radius_min))
            if bool(new_cost <= last):  # pp.optim.LM: reject iff last < new
                nodes, vels, cost = new_nodes, new_vels, new_cost
                break
        rel_dec = (last - cost) / torch.clamp(last, min=1e-30)
        patience = patience + 1 if bool(rel_dec < config.decreasing) else 0
        step += 1
    return nodes, vels, cost, step
