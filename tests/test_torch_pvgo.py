"""Port PVGO (residuals, LM, lm_solve_trace, run_pvgo) vs the JAX package.

The problems are tests/test_pvgo.py's: a B=8 ground-truth chain with
consistent IMU deltas, noisy VO and a perturbed start.  The LM accept /
reject branches compare costs, so the step counts are pinned equal first,
and the solutions are then compared at atol 1e-4 (float32 solves of an
81-unknown system in two orders).  ``lm_solve_trace`` is held step for step
in float64 on ``tests/test_pvgo.py::TestPyPoseParity``'s problems: the
accept decisions agree, so radius, patience and step counts agree exactly;
costs to rtol 1e-7 (measured 6e-10 and, on the saturated case, 3.5e-8;
atol 1e-12 for the noiseless problem's ~0 cost); nodes and velocities to
atol 1e-6 (measured 1.1e-8 to 2.3e-7: the gauge directions of H are damped
by only 1e-4 of its diagonal, so float64 solves that round in two orders
differ there most).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.pvgo import graph as jgraph
from islam_tpu.pvgo.lm import LMConfig as JLMConfig
from islam_tpu.pvgo.lm import lm_solve_manifold as jlm
from islam_tpu.pvgo.lm import lm_solve_trace as jtrace
from islam_tpu.pvgo.run import run_pvgo as jrun
from islam_tpu_torch.pvgo import graph as tgraph
from islam_tpu_torch.pvgo.lm import (LMConfig, lm_solve_manifold,
                                     lm_solve_trace)
from islam_tpu_torch.pvgo.run import run_pvgo

from tests.test_pvgo import (B, _jax_residual_builder, _perturbed_init,
                             make_problem)

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one host, and torch's default of a thread per core oversubscribes it.
torch.set_num_threads(1)

WEIGHTS = (1.0, 0.1, 10.0, 0.1)


def _case(seed, noise=0.02):
    p = make_problem(noise=noise, seed=seed)
    rng = np.random.default_rng(seed + 100)
    nodes = np.array(p["gt_poses"].data)
    nodes[1:, :3] += rng.normal(size=(B, 3)).astype(np.float32) * 0.05
    vels = p["gt_vels"] + rng.normal(size=(B + 1, 3)).astype(np.float32) * 0.1
    arrays = dict(init_nodes=nodes, init_vels=vels.astype(np.float32),
                  vo_motions=np.array(p["vo_motions"].data),
                  links=np.array(p["links"]), dts=np.array(p["dts"]),
                  imu_drots=np.array(p["imu_drots"]),
                  imu_dtrans=np.array(p["imu_dtrans"]),
                  imu_dvels=np.array(p["imu_dvels"]))
    return arrays


def _torch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _residual_fns(a):
    t = _torch(a)

    def jres(nodes, vels):
        blocks = jgraph.pvgo_residuals(
            nodes, vels, a["links"], a["vo_motions"], a["imu_drots"],
            a["imu_dtrans"], a["imu_dvels"], a["dts"])
        return jnp.concatenate([(b * w).reshape(-1)
                                for b, w in zip(blocks, WEIGHTS)])

    def tres(nodes, vels):
        blocks = tgraph.pvgo_residuals(
            nodes, vels, t["links"], t["vo_motions"], t["imu_drots"],
            t["imu_dtrans"], t["imu_dvels"], t["dts"])
        return torch.cat([(b * w).reshape(-1) for b, w in zip(blocks, WEIGHTS)])

    return jres, tres


@pytest.mark.parametrize("seed", [7, 11])
def test_residuals(seed):
    a = _case(seed)
    jres, tres = _residual_fns(a)
    ref = jres(a["init_nodes"], a["init_vels"])
    out = tres(torch.from_numpy(a["init_nodes"]),
               torch.from_numpy(a["init_vels"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_lm_solve_manifold(seed):
    a = _case(seed)
    jres, tres = _residual_fns(a)
    jn, jv, jcost, jsteps = jlm(jres, jnp.asarray(a["init_nodes"]),
                                jnp.asarray(a["init_vels"]), JLMConfig())
    tn, tv, tcost, tsteps = lm_solve_manifold(
        tres, torch.from_numpy(a["init_nodes"]),
        torch.from_numpy(a["init_vels"]), LMConfig())
    assert tsteps == int(jsteps)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("target", ["", "vo", "imu"])
def test_run_pvgo(target):
    """Solution, losses and (for 'vo'/'imu') the upper-level gradients."""
    a = _case(7)
    jt = "none" if not target else target

    def jloss(vo, drots, dvels):
        tl, rl, nodes, vels, _ = jrun(
            a["init_nodes"], a["init_vels"], vo, a["links"], a["dts"], drots,
            a["imu_dtrans"], dvels, loss_weight=WEIGHTS, target=jt)
        return jnp.sum(tl) + jnp.sum(rl), (tl, rl, nodes, vels)

    (jl, (jtl, jrl, jn, jv)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        a["vo_motions"], a["imu_drots"], a["imu_dvels"])

    t = _torch(a)
    for k in ("vo_motions", "imu_drots", "imu_dvels"):
        t[k].requires_grad_(True)
    tl, rl, tn, tv, covs = run_pvgo(
        t["init_nodes"], t["init_vels"], t["vo_motions"], t["links"],
        t["dts"], t["imu_drots"], t["imu_dtrans"], t["imu_dvels"],
        loss_weight=WEIGHTS, target=target)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jtl),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(rl.detach().numpy(), np.asarray(jrl),
                               rtol=1e-3, atol=1e-7)
    assert not tn.requires_grad and not tv.requires_grad
    assert set(covs) == {"vo_rot", "vo_trans", "imu_rot", "imu_vel",
                         "transvel"}
    if target:
        (tl.sum() + rl.sum()).backward()
        for k, g in zip(("vo_motions", "imu_drots", "imu_dvels"), jg):
            got = t[k].grad
            got = np.zeros_like(a[k]) if got is None else got.numpy()
            scale = np.abs(np.asarray(g)).max() + 1e-6
            np.testing.assert_allclose(got, np.asarray(g),
                                       atol=1e-3 * scale, err_msg=k)


def test_align_to():
    a = _case(11)
    target = a["vo_motions"][0]
    ref = jgraph.align_to(a["init_nodes"], a["init_vels"], target)
    out = tgraph.align_to(torch.from_numpy(a["init_nodes"]),
                          torch.from_numpy(a["init_vels"]),
                          torch.from_numpy(target))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_unknown_bilevel_mode_raises():
    """The three modes are ported (tests/test_torch_bilevel.py); any other
    name raises ValueError, as in the JAX package (run.py:145-146)."""
    t = _torch(_case(7))
    with pytest.raises(ValueError, match="unknown bilevel mode"):
        run_pvgo(t["init_nodes"], t["init_vels"], t["vo_motions"],
                 t["links"], t["dts"], t["imu_drots"], t["imu_dtrans"],
                 t["imu_dvels"], bilevel="one-step")


@functools.lru_cache(maxsize=None)
def _trace_case(noise, seed, t_noise=0.05, saturate=0.0):
    """TestPyPoseParity's problem and start for (noise, seed; the start's
    translations perturbed by ``t_noise``), solved by both
    ``lm_solve_trace``s in float64.  ``saturate`` = a > 0 solves
    atan(a r) instead of the residual r."""
    rng = np.random.default_rng(seed)
    p = make_problem(noise=noise, seed=20 + seed)
    nodes0, vels0 = _perturbed_init(p, rng, t_noise=t_noise)
    jres = _jax_residual_builder(p, WEIGHTS, jnp.float64)
    with jax.enable_x64(True):
        _, jsteps, jactive = jtrace(
            (lambda n, v: jnp.arctan(saturate * jres(n, v))) if saturate
            else jres,
            jnp.asarray(nodes0, jnp.float64), jnp.asarray(vels0, jnp.float64))
        jsteps = jax.tree_util.tree_map(np.asarray, jsteps)
        jactive = np.asarray(jactive)

    def f64(x):
        return torch.tensor(np.asarray(x), dtype=torch.float64)

    links = torch.tensor(np.asarray(p["links"]))
    data = [f64(x) for x in (p["vo_motions"].data, p["imu_drots"],
                             p["imu_dtrans"], p["imu_dvels"])]
    dts = f64(p["dts"])

    def residual(nodes, vels):
        blocks = tgraph.pvgo_residuals(nodes, vels, links, *data, dts)
        r = torch.cat([(b * w).reshape(-1) for b, w in zip(blocks, WEIGHTS)])
        return torch.atan(saturate * r) if saturate else r

    start = (torch.from_numpy(nodes0), torch.from_numpy(vels0))
    return residual, start, jsteps, jactive


# TestPyPoseParity's three problems, and the third with its start's
# translations perturbed by 0.5 and the residual saturated as atan(3 r):
# there the Gauss-Newton steps overshoot, so trials are rejected (steps 1, 3
# and 4 shrink the radius 2^8, 2^2 and 2^1 times; steps 5-6 accept a second
# trial), and the batched reject loop is held against JAX's while_loop.
TRACE_CASES = [(0.0, 0, 0.05, 0.0), (0.02, 1, 0.05, 0.0),
               (0.05, 2, 0.05, 0.0), (0.05, 2, 0.5, 3.0)]


@pytest.mark.parametrize("noise,seed,t_noise,saturate", TRACE_CASES)
def test_lm_solve_trace_matches_jax(noise, seed, t_noise, saturate):
    residual, start, jsteps, jactive = _trace_case(noise, seed, t_noise,
                                                   saturate)
    final, steps, active = lm_solve_trace(residual, *start)
    assert int(active.sum()) == int(jactive.sum())
    np.testing.assert_array_equal(active.numpy(), jactive)
    np.testing.assert_allclose(steps.cost.numpy(), jsteps.cost, rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_array_equal(steps.radius.numpy(), jsteps.radius)
    np.testing.assert_array_equal(steps.patience.numpy(), jsteps.patience)
    np.testing.assert_array_equal(steps.step.numpy(), jsteps.step)
    np.testing.assert_allclose(steps.nodes.numpy(), jsteps.nodes, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(steps.vels.numpy(), jsteps.vels, rtol=0,
                               atol=1e-6)
    if saturate:
        # rejected trials: a step shrank the radius by more than one halving
        ratios = jsteps.radius / np.concatenate([[1e4], jsteps.radius[:-1]])
        assert (ratios < 0.5).any()


@pytest.mark.parametrize("case", TRACE_CASES[2:])
def test_lm_solve_manifold_is_the_traces_final_state(case):
    residual, start, _, _ = _trace_case(*case)
    final, _, _ = lm_solve_trace(residual, *start)
    out = lm_solve_manifold(residual, *start)
    for a, b in zip(out, (final.nodes, final.vels, final.cost, final.step)):
        assert torch.equal(a, b)
