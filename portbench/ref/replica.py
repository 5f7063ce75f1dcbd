"""Host-side numpy replica of the PyPose optimizer stack used by the
reference back-end (pvgo.py:169-180).

The benchmark's frozen copy of ``islam_tpu_torch/pvgo/pypose_replica.py``
(the reference's LM: it imports nothing of the program): the
*executable specification* for ``islam_tpu_torch/pvgo/lm.py``, a
plain-python, eager, numpy implementation of the documented semantics of

- ``pp.optim.LM(min=1e-4, vectorize=True)`` — Marquardt damping on the
  clamped diagonal of J^T J, Cholesky solve, reject-with-rollback loop
  (up to ``reject=16`` re-tries per step, re-solving with the updated
  damping and the SAME Jacobian);
- ``pp.optim.strategy.TrustRegion(radius=1e4)`` — quality (gain-ratio)
  driven radius adaptation: rho = (actual cost decrease) / (decrease
  predicted by the linearized model), radius *= up if rho > factor else
  radius *= down, damping = 1/radius;
- ``pp.optim.scheduler.StopOnPlateau(steps=10, patience=3,
  decreasing=1e-3)`` — stop after ``steps`` optimizer steps or after
  ``patience`` consecutive steps whose relative cost decrease stayed
  below ``decreasing``.

The SE(3) retraction used for the pose-node update (``x + delta =
Exp(delta) @ x``, pp.LieTensor's ``add``/``Retr``) is implemented here
independently of ``islam_tpu_torch.lie`` via the 4x4 matrix exponential
(``scipy.linalg.expm``) and ``scipy.spatial.transform.Rotation``, so the
parity tests exercise both the optimizer control flow AND the retraction
convention against an external library.

``tests/test_torch_pypose_replica.py`` asserts that ``lm_solve_trace``
reproduces this replica step-for-step (per-iterate cost / radius /
patience / accept-reject pattern / node values) on random PVGO problems
(``testing.pvgo_problem``), that converged solutions are insensitive to
the one undocumented constant (the TrustRegion quality threshold), and
that this copy and the JAX package's give bitwise-equal traces.
``chip_smoke.py`` (phase ``pvgo_replica``) holds the solves on the card
to it.  It needs numpy and scipy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np
from scipy.linalg import expm
from scipy.spatial.transform import Rotation


def _hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]], dtype=np.float64)


def se3_exp_matrix(xi: np.ndarray) -> np.ndarray:
    """Twist [tau(3), phi(3)] -> 4x4 homogeneous transform, via expm."""
    tau, phi = xi[:3], xi[3:]
    M = np.zeros((4, 4), dtype=np.float64)
    M[:3, :3] = _hat(phi)
    M[:3, 3] = tau
    return expm(M)


def retract_nodes(nodes: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Left-multiplicative retraction Exp(xi_i) o T_i on [t(3), q(4)] rows."""
    out = np.empty_like(nodes)
    for i in range(nodes.shape[0]):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat(nodes[i, 3:]).as_matrix()
        T[:3, 3] = nodes[i, :3]
        T2 = se3_exp_matrix(np.asarray(xi[i], np.float64)) @ T
        out[i, :3] = T2[:3, 3]
        q = Rotation.from_matrix(T2[:3, :3]).as_quat()
        # keep quaternion hemisphere continuous with the input
        if np.dot(q, nodes[i, 3:]) < 0:
            q = -q
        out[i, 3:] = q
    return out


@dataclass
class StepRecord:
    cost: float          # cost after the scheduler step
    radius: float        # trust-region radius after the step
    rejects: int         # rejected trials inside the step
    accepted: bool       # whether any trial was accepted
    patience: int        # plateau counter after the step
    nodes: np.ndarray
    vels: np.ndarray


@dataclass
class ReplicaResult:
    nodes: np.ndarray
    vels: np.ndarray
    cost: float
    steps: int
    trace: List[StepRecord] = field(default_factory=list)


def pypose_lm_replica(residual_fn: Callable[[np.ndarray, np.ndarray],
                                            np.ndarray],
                      jacobian_fn: Callable[[np.ndarray, np.ndarray],
                                            np.ndarray],
                      nodes0: np.ndarray, vels0: np.ndarray,
                      radius: float = 1e4,
                      damping_min: float = 1e-4,
                      damping_max: float = 1e32,
                      max_steps: int = 10,
                      patience: int = 3,
                      decreasing: float = 1e-3,
                      radius_up: float = 2.0,
                      radius_down: float = 0.5,
                      radius_max: float = 1e16,
                      radius_min: float = 1e-6,
                      quality_factor: float = 1e-3,
                      max_rejects: int = 16) -> ReplicaResult:
    """Run the replica optimizer loop.

    Args:
        residual_fn: (nodes (N,7), vels (N,3)) -> flat weighted residual.
        jacobian_fn: (nodes, vels) -> (R, 9N) Jacobian of the residual
            w.r.t. the tangent [xi_0..xi_{N-1}, dv_0..dv_{N-1}] at zero,
            under the same left-multiplicative retraction as
            :func:`retract_nodes`.
        nodes0 / vels0: initial SE3 rows / velocities.

    Mirrors ``while scheduler.continual(): loss = optimizer.step(...);
    scheduler.step(loss)`` (pvgo.py:177-180).
    """
    nodes = np.array(nodes0, np.float64)
    vels = np.array(vels0, np.float64)
    N = nodes.shape[0]

    def cost_of(n, v):
        r = np.asarray(residual_fn(n, v), np.float64)
        return float(r @ r)

    def apply_delta(n, v, delta):
        xi = delta[: 6 * N].reshape(N, 6)
        dv = delta[6 * N:].reshape(N, 3)
        return retract_nodes(n, xi), v + dv

    last = cost_of(nodes, vels)
    pat_count = 0
    steps = 0
    trace: List[StepRecord] = []

    while steps < max_steps and pat_count < patience:
        # ---- optimizer.step: linearize once at the current estimate ----
        J = np.asarray(jacobian_fn(nodes, vels), np.float64)
        r = np.asarray(residual_fn(nodes, vels), np.float64)
        H = J.T @ J
        g = J.T @ r
        diag_clamped = np.clip(np.diagonal(H), damping_min, damping_max)

        rejects = 0
        accepted = False
        cost = last
        while not accepted and rejects < max_rejects:
            A = H + np.diag(diag_clamped / radius)
            try:
                L = np.linalg.cholesky(A)
                y = np.linalg.solve(L, -g)
                delta = np.linalg.solve(L.T, y)
            except np.linalg.LinAlgError:
                delta = np.full_like(g, np.nan)
            new_nodes, new_vels = apply_delta(nodes, vels, delta)
            new_cost = cost_of(new_nodes, new_vels)
            # TrustRegion.update (called on every trial, before the
            # accept test): gain ratio vs the linearized model.
            Jd = J @ delta
            predicted = -(Jd @ (2.0 * r + Jd))
            with np.errstate(invalid="ignore"):
                quality = (last - new_cost) / max(predicted, 1e-30)
            if np.isfinite(quality) and quality > quality_factor:
                radius = min(radius * radius_up, radius_max)
            else:
                radius = max(radius * radius_down, radius_min)
            # pp.optim.LM: reject iff the loss got strictly worse (or NaN).
            if np.isfinite(new_cost) and new_cost <= last:
                nodes, vels, cost = new_nodes, new_vels, new_cost
                accepted = True
            else:
                rejects += 1

        # ---- scheduler.step(loss) ----
        rel_dec = (last - cost) / max(last, 1e-30)
        pat_count = pat_count + 1 if rel_dec < decreasing else 0
        last = cost
        steps += 1
        trace.append(StepRecord(cost=cost, radius=radius, rejects=rejects,
                                accepted=accepted, patience=pat_count,
                                nodes=nodes.copy(), vels=vels.copy()))

    return ReplicaResult(nodes=nodes, vels=vels, cost=last, steps=steps,
                         trace=trace)
