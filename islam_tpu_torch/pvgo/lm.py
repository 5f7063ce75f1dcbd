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
scalar from the device (``.item()``), and ``HOST_READS`` counts them.  The
graph is tiny (81 unknowns at B=8), so those reads cost little next to the
VO forward.

Two solves carry gradients through to the residual's parameters theta (the
bi-level modes): ``lm_solve_unrolled`` runs a fixed number of damped
Gauss-Newton steps, every op differentiable, and ``lm_solve_implicit`` runs
the LM above and applies the implicit function theorem at its solution.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, jacfwd, vjp

from islam_tpu_torch import lie

# Device -> host reads of the LM loop's tests, since the process started.
HOST_READS = 0


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
    global HOST_READS
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
            HOST_READS += 1
            if bool(new_cost <= last):  # pp.optim.LM: reject iff last < new
                nodes, vels, cost = new_nodes, new_vels, new_cost
                break
        rel_dec = (last - cost) / torch.clamp(last, min=1e-30)
        HOST_READS += 1
        patience = patience + 1 if bool(rel_dec < config.decreasing) else 0
        step += 1
    return nodes, vels, cost, step


def lm_solve_unrolled(residual_fn: Callable, nodes0, vels0, iters: int = 5,
                      config: LMConfig = LMConfig()):
    """``iters`` damped Gauss-Newton steps with the damping fixed at
    1/radius (islam_tpu/pvgo/lm.py:219-248).  Every op is differentiable,
    so autograd carries the upper-level gradient through the whole path to
    whatever ``residual_fn`` closes over."""
    nodes, vels = nodes0, vels0
    D = 9 * nodes.shape[0]
    zero = torch.zeros(D, dtype=vels.dtype, device=vels.device)
    eye = torch.eye(D, dtype=vels.dtype, device=vels.device)
    for _ in range(iters):
        J = jacfwd(lambda d: residual_fn(*_apply_delta(nodes, vels, d)))(zero)
        r = residual_fn(nodes, vels)
        H = J.T @ J
        diag = torch.clamp(torch.diagonal(H), config.damping_min,
                           config.damping_max)
        A = H + torch.diag(diag) / config.radius + 1e-9 * eye
        delta = -torch.linalg.solve(A, J.T @ r)
        nodes, vels = _apply_delta(nodes, vels, delta)
    return nodes, vels


def implicit_vjp(residual_theta: Callable, nodes, vels, theta, nodes_bar,
                 vels_bar):
    """The implicit function theorem's vector-Jacobian product at a solution
    x* = (``nodes``, ``vels``) of min 1/2 ||r(x, theta)||^2.

    With g = d/d delta of the cost in tangent coordinates and H = dg/d delta
    (+ 1e-6 I), the cotangent of x* is mapped to tangent coordinates by the
    VJP of the retraction at 0, lam = H^-1 of it, and the gradient of each
    tensor of the tuple ``theta`` is -(dg/d theta)^T lam.  Returns that
    tuple in the dtypes of ``theta`` (islam_tpu/pvgo/lm.py:280-310).

    It is computed in float64.  H spans ~420 (the IMU rotation factor) to
    ~1e-4 (the velocities, weighed 0.1 at dt 0.1 s), besides its gauge null
    space, so in float32 the solve loses most of lam along the velocity
    modes: the pose head's gradient then moved by 16 % between an H100 and
    a CPU.  ``residual_theta`` must compute in the dtype of its inputs."""
    dtypes = [t.dtype for t in theta]
    nodes, vels, nodes_bar, vels_bar = (
        x.to(torch.float64) for x in (nodes, vels, nodes_bar, vels_bar))
    theta = tuple(t.to(torch.float64) for t in theta)
    D = 9 * nodes.shape[0]
    zero = torch.zeros(D, dtype=vels.dtype, device=vels.device)

    def g_fn(delta, th):
        def cost(d):
            r = residual_theta(*_apply_delta(nodes, vels, d), th)
            return 0.5 * torch.sum(r * r)
        return grad(cost)(delta)

    H = jacfwd(lambda d: g_fn(d, theta))(zero)
    H = H + 1e-6 * torch.eye(D, dtype=H.dtype, device=H.device)
    _, vjp_delta = vjp(lambda d: _apply_delta(nodes, vels, d), zero)
    (delta_bar,) = vjp_delta((nodes_bar, vels_bar))
    lam = torch.linalg.solve(H, delta_bar)
    _, vjp_theta = vjp(lambda *th: g_fn(zero, th), *theta)
    return tuple(g.to(d) for g, d in zip(vjp_theta(-lam), dtypes))


class _ImplicitSolve(torch.autograd.Function):
    """Forward: ``lm_solve_manifold`` on the detached inputs.  Backward:
    ``implicit_vjp`` at its solution.  Every tensor that needs a gradient
    has to be one of the ``theta`` inputs: a tensor the residual closes
    over would get none, and nothing would say so."""

    @staticmethod
    def forward(ctx, residual_theta, config, nodes0, vels0, *theta):
        nodes, vels, _, _ = lm_solve_manifold(
            lambda n, v: residual_theta(n, v, theta), nodes0, vels0, config)
        ctx.residual_theta = residual_theta
        ctx.save_for_backward(nodes, vels, *theta)
        return nodes, vels

    @staticmethod
    def backward(ctx, nodes_bar, vels_bar):
        nodes, vels, *theta = ctx.saved_tensors
        theta_bar = implicit_vjp(ctx.residual_theta, nodes, vels,
                                 tuple(theta), nodes_bar, vels_bar)
        return (None, None, None, None,
                *(g if need else None for g, need in
                  zip(theta_bar, ctx.needs_input_grad[4:])))


def lm_solve_implicit(residual_theta: Callable, theta, nodes0, vels0,
                      config: LMConfig = LMConfig()):
    """LM solve whose solution (nodes, vels) is differentiable in the tuple
    of tensors ``theta`` by the implicit function theorem
    (islam_tpu/pvgo/lm.py:251-313).  ``residual_theta(nodes, vels, theta)``
    must reach every tensor that needs a gradient through ``theta``."""
    return _ImplicitSolve.apply(residual_theta, config, nodes0.detach(),
                                vels0.detach(), *theta)
