"""Levenberg-Marquardt on the SE(3)^N x R^{3N} product manifold.

Counterpart of ``islam_tpu/pvgo/lm.py`` (``lm_solve_manifold``,
``lm_solve_trace``), which reproduces the PyPose stack the reference uses
(pvgo.py:169-180): Cholesky solver, ``TrustRegion(radius=1e4)``,
``LM(min=1e-4, reject=16)`` and ``StopOnPlateau(steps=10, patience=3,
decreasing=1e-3)``:

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
(pose update Exp(xi) o T, velocity update additive).

The loop reads nothing back to the host, as JAX's ``lax.while_loop`` does
not.  It runs ``max_steps`` steps at a fixed trip count, and from the step
where the plateau test stops the solve the state stays frozen
(``torch.where``), as the body of JAX's ``lm_solve_trace`` does.  The reject
loop is solved in one batch, exactly: within a step J, H and g are fixed, and
a rejected trial (cost above the current one, or NaN) always has a quality
below ``quality_factor`` (>= 0), so the radius of trial k is
max(r0 * radius_down^k, radius_min).  All ``max_rejects`` damped systems
are solved (one Cholesky each, no host read), their costs are one
``torch.func.vmap`` of the residual, and the first accepted trial is picked
on the device.  With no host read in it, the whole solve can be one CUDA
graph: ``lm_solve_graphed`` captures it once per shape and replays it.

Two solves carry gradients through to the residual's parameters theta (the
bi-level modes): ``lm_solve_unrolled`` runs a fixed number of damped
Gauss-Newton steps, every op differentiable, and ``lm_solve_implicit`` runs
the LM above and applies the implicit function theorem at its solution.
Neither reads the device either (``torch.linalg.solve_ex``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, jacfwd, vjp, vmap

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


class StepState(NamedTuple):
    """The LM state after a scheduler step (JAX's ``_StepState``)."""
    nodes: torch.Tensor
    vels: torch.Tensor
    radius: torch.Tensor
    cost: torch.Tensor      # cost after this step (the last one if all rejected)
    patience: torch.Tensor  # consecutive below-threshold-decrease steps
    step: torch.Tensor      # scheduler steps taken


def _apply_delta(nodes, vels, delta):
    N = nodes.shape[0]
    xi = delta[:6 * N].reshape(N, 6)
    dv = delta[6 * N:].reshape(N, 3)
    return lie.se3_retract(nodes, xi), vels + dv


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _make_outer_step(residual_fn: Callable, config: LMConfig):
    """One scheduler step: linearize once, then all the reject loop's
    trials at once, the first accepted one kept (islam_tpu/pvgo/lm.py:97-177).
    A rejected trial shrinks the radius only where quality_factor >= 0 and
    radius_down <= 1; then trial k's radius is known before any trial
    runs."""
    if config.quality_factor < 0 or not 0 < config.radius_down <= 1:
        raise ValueError("the reject loop without host reads needs "
                         "quality_factor >= 0 and 0 < radius_down <= 1")
    R = config.max_rejects

    def costs(nodes, vels, deltas):
        """The cost at the retraction of each row of ``deltas`` (R, D): one
        batched residual, so that every cost the accept test compares
        (the start's too) is summed the same way."""
        return vmap(lambda d: torch.sum(
            residual_fn(*_apply_delta(nodes, vels, d)) ** 2))(deltas)

    def outer(state: StepState) -> StepState:
        nodes, vels, radius, last, patience, step = state
        zero = torch.zeros(9 * nodes.shape[0], dtype=vels.dtype,
                           device=vels.device)
        J = jacfwd(lambda d: residual_fn(*_apply_delta(nodes, vels, d)))(zero)
        r = residual_fn(nodes, vels)
        H = J.T @ J
        g = J.T @ r
        # pp.optim.LM: damping acts on the clamped diagonal of J^T J.
        diag_clamped = torch.clamp(torch.diagonal(H), config.damping_min,
                                   config.damping_max)
        # Trial k's radius: k rejections, each a shrink; the products are
        # exact for radius_down = 0.5 (powers of two).
        decay = torch.cat([torch.ones(1, dtype=vels.dtype, device=vels.device),
                           torch.full((R - 1,), config.radius_down,
                                      dtype=vels.dtype, device=vels.device)])
        radii = torch.clamp(radius * torch.cumprod(decay, 0),
                            min=config.radius_min)
        damped = H + torch.diag_embed(diag_clamped / radii[:, None])
        deltas = []
        for k in range(R):
            # One factorization a trial: on the card the batched routines
            # round otherwise than the single ones and the CPU's LAPACK,
            # enough to move the implicit gradient by 1.5 % of max|g|.
            L, info = torch.linalg.cholesky_ex(damped[k])
            d = -torch.cholesky_solve(g[:, None], L)[:, 0]
            # A failed factorization gives NaN, which the accept test rejects
            deltas.append(torch.where(info == 0, d, torch.nan))
        delta = torch.stack(deltas)
        new_cost = costs(nodes, vels, delta)
        Jd = delta @ J.T
        predicted = -torch.sum(Jd * (2.0 * r + Jd), dim=-1)
        quality = (last - new_cost) / torch.clamp(predicted, min=1e-30)
        accept = new_cost <= last  # pp.optim.LM: reject iff last < new
        trials = torch.arange(R, device=vels.device)
        first = torch.where(accept, trials, R).min()  # R if none accepted
        accepted = first < R
        first = torch.clamp(first, max=R - 1)
        rk = _pick(radii, first)
        radius = torch.where(
            accepted,
            torch.where(_pick(quality, first) > config.quality_factor,
                        torch.clamp(rk * config.radius_up,
                                    max=config.radius_max),
                        torch.clamp(rk * config.radius_down,
                                    min=config.radius_min)),
            torch.clamp(radii[-1] * config.radius_down,
                        min=config.radius_min))
        new_nodes, new_vels = _apply_delta(nodes, vels, _pick(delta, first))
        nodes = torch.where(accepted, new_nodes, nodes)
        vels = torch.where(accepted, new_vels, vels)
        cost = torch.where(accepted, _pick(new_cost, first), last)
        # StopOnPlateau.step: relative decrease vs the last (== best) cost.
        rel_dec = (last - cost) / torch.clamp(last, min=1e-30)
        patience = torch.where(rel_dec < config.decreasing, patience + 1,
                               torch.zeros_like(patience))
        return StepState(nodes, vels, radius, cost, patience, step + 1)

    def continual(state: StepState) -> torch.Tensor:
        return (state.step < config.max_steps) & (
            state.patience < config.patience)

    def init(nodes0, vels0) -> StepState:
        dev = vels0.device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        # the retraction at 0 is exact: this is the start's cost
        zero = torch.zeros((R, 9 * nodes0.shape[0]), dtype=vels0.dtype,
                           device=dev)
        return StepState(nodes0, vels0,
                         torch.full((), config.radius, dtype=vels0.dtype,
                                    device=dev),
                         costs(nodes0, vels0, zero)[0], count, count)

    return outer, continual, init


def _solve(residual_fn, nodes0, vels0, config, record):
    """``config.max_steps`` steps, each frozen once ``continual`` is false
    (the body of JAX's ``lm_solve_trace``).  Returns the final state and,
    with ``record``, the states after each step and the active mask."""
    outer, continual, init = _make_outer_step(residual_fn, config)
    state = init(nodes0.detach(), vels0.detach())
    trace = []
    for _ in range(config.max_steps):
        active = continual(state)
        state = StepState(*(torch.where(active, b, a)
                            for a, b in zip(state, outer(state))))
        if record:
            trace.append((state, active))
    return state, trace


def lm_solve_manifold(residual_fn: Callable, nodes0: torch.Tensor,
                      vels0: torch.Tensor, config: LMConfig = LMConfig()):
    """Minimize ||residual_fn(nodes, vels)||^2 over SE3 nodes + velocities.

    residual_fn: (nodes (N, 7), vels (N, 3)) -> flat weighted residual (R,).
    Returns (nodes, vels, final_cost, steps_taken), ``steps_taken`` a 0-d
    int32 tensor on the device; the start values are treated as constants.
    """
    state, _ = _solve(residual_fn, nodes0, vels0, config, record=False)
    return state.nodes, state.vels, state.cost, state.step


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple        # the static tensors the graph reads
    outputs: StepState   # the static tensors it writes


# (key, config, the inputs' shapes, dtypes and devices) -> _Graph
_GRAPHS = {}


def lm_solve_graphed(residual_fn: Callable, inputs: tuple,
                     nodes0: torch.Tensor, vels0: torch.Tensor,
                     config: LMConfig = LMConfig(), key=None):
    """``lm_solve_manifold`` of ``lambda n, v: residual_fn(n, v, inputs)``,
    on the card as the replay of one CUDA graph.

    The solve reads nothing back to the host, so all of it (10 steps of
    Jacobian, 16 trials, freeze) can be captured once and replayed: the
    host then launches one graph instead of ~10^4 kernels.
    ``residual_fn(nodes, vels, inputs)`` must read no tensor but
    ``inputs``, and compute the same function for every call with one
    ``key`` (a hashable summary of the Python values it closes over).  The
    first call for a key and the inputs' shapes warms the solve up and
    captures it on a side stream, with no host sync; later calls copy their
    inputs into the graph's and replay it.  CPU tensors, or no ``key``,
    run ``lm_solve_manifold``."""
    nodes0, vels0 = nodes0.detach(), vels0.detach()
    inputs = tuple(t.detach() for t in inputs)
    if key is None or not vels0.is_cuda:
        return lm_solve_manifold(lambda n, v: residual_fn(n, v, inputs),
                                 nodes0, vels0, config)
    args = (nodes0, vels0, *inputs)
    sig = (key, config, tuple((t.shape, t.dtype, t.device) for t in args))
    entry = _GRAPHS.get(sig)
    if entry is None:
        entry = _GRAPHS[sig] = _capture(residual_fn, args, config)
    for static, t in zip(entry.inputs, args):
        static.copy_(t)
    entry.graph.replay()
    out = entry.outputs
    return tuple(t.clone() for t in (out.nodes, out.vels, out.cost, out.step))


def _capture(residual_fn, args, config) -> _Graph:
    static = tuple(t.clone() for t in args)

    def solve():
        nodes0, vels0, *inputs = static
        return _solve(lambda n, v: residual_fn(n, v, tuple(inputs)), nodes0,
                      vels0, config, record=False)[0]

    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(static[0].device)
    stream.wait_stream(torch.cuda.current_stream(static[0].device))
    # cuSOLVER's factorizations can be captured; MAGMA's wait on the host
    library = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        with torch.cuda.stream(stream):
            solve()  # warm-up: library handles and workspaces
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = solve()
            finally:
                graph.capture_end()
    finally:
        torch.backends.cuda.preferred_linalg_library(library)
    torch.cuda.current_stream(static[0].device).wait_stream(stream)
    return _Graph(graph, static, outputs)


def lm_solve_trace(residual_fn: Callable, nodes0: torch.Tensor,
                   vels0: torch.Tensor, config: LMConfig = LMConfig()):
    """Like :func:`lm_solve_manifold`, recording every scheduler step
    (islam_tpu/pvgo/lm.py:192-216).  Returns (final ``StepState``, the
    ``StepState`` of each step stacked on a leading ``max_steps`` axis, the
    (max_steps,) bool mask of the steps that ran)."""
    final, trace = _solve(residual_fn, nodes0, vels0, config, record=True)
    steps = StepState(*(torch.stack(x) for x in zip(*(s for s, _ in trace))))
    return final, steps, torch.stack([a for _, a in trace])


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
        delta = -torch.linalg.solve_ex(A, J.T @ r)[0]
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
    lam = torch.linalg.solve_ex(H, delta_bar)[0]
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
