"""The port's LM against the port's PyPose replica
(``islam_tpu_torch/pvgo/pypose_replica.py``), as
``tests/test_pvgo.py::TestPyPoseParity`` holds JAX's LM to JAX's replica.

The problems are that test's (``testing.pvgo_problem``,
``pvgo_perturbed_init``, ``pvgo_np_residual``: copies of its
``make_problem``, ``_perturbed_init`` and numpy residual); the
port's residual side is ``pvgo/graph.py``'s, in float64 on the CPU.  The
tolerances are ``TestPyPoseParity``'s: per step cost rtol 1e-5 (atol 1e-12
for the noiseless problem's ~0 cost), radius rtol 1e-9, patience and step
count exact, node translations and velocities atol 5e-6, rotations
|<q, q_ref>| within 1e-9 of 1; the float32 solve at atol 2e-3 of the
replica's solution; solutions under three quality thresholds within 1e-4
of each other.  The port's copy of the replica must give the JAX
package's traces bitwise on the same numpy problem.
"""

import numpy as np
import pytest
import torch

from islam_tpu.pvgo import pypose_replica as jreplica
from islam_tpu_torch import testing
from islam_tpu_torch.pvgo import pypose_replica as replica
from islam_tpu_torch.pvgo.lm import (LMConfig, lm_solve_graphed,
                                     lm_solve_manifold, lm_solve_trace)

torch.set_num_threads(1)

# (noise, seed, t_noise, saturate): TestPyPoseParity.
# test_per_iterate_trajectory's three problems, and the third with its
# start's translations perturbed by 0.5 and the residual saturated as
# atan(3 r) (tests/test_torch_pvgo.py's fourth trace case): there the
# Gauss-Newton steps overshoot and the replica rejects trials.
CASES = [(0.0, 0, 0.05, 0.0), (0.02, 1, 0.05, 0.0), (0.05, 2, 0.05, 0.0),
         (0.05, 2, 0.5, 3.0)]
_REF = {}


def _reference(noise, seed, t_noise=0.05, saturate=0.0):
    """The problem, its start and the replica's run (tests/test_pvgo.py:
    265-275)."""
    key = (noise, seed, t_noise, saturate)
    if key not in _REF:
        rng = np.random.default_rng(seed)
        p = testing.pvgo_problem(noise=noise, seed=20 + seed)
        nodes0, vels0 = testing.pvgo_perturbed_init(p, rng, t_noise)
        _REF[key] = (p, nodes0, vels0, replica.pypose_lm_replica(
            *testing.pvgo_np_residual(p, saturate=saturate), nodes0, vels0))
    return _REF[key]


def _port_residual(p, dtype=torch.float64, saturate=0.0):
    res, inputs = testing.pvgo_residual(p, dtype=dtype, device="cpu",
                                        saturate=saturate)
    return (lambda n, v: res(n, v, inputs)), res, inputs


def _assert_state(nodes, vels, rec_nodes, rec_vels, what):
    nodes, vels = np.asarray(nodes), np.asarray(vels)
    np.testing.assert_allclose(nodes[:, :3], rec_nodes[:, :3], atol=5e-6,
                               err_msg=f"node translations {what}")
    qd = np.abs(np.sum(nodes[:, 3:] * rec_nodes[:, 3:], axis=-1))
    np.testing.assert_allclose(qd, 1.0, atol=1e-9,
                               err_msg=f"node rotations {what}")
    np.testing.assert_allclose(vels, rec_vels, atol=5e-6,
                               err_msg=f"velocities {what}")


@pytest.mark.parametrize("case", CASES)
def test_lm_solve_trace_per_iterate(case):
    """Per step: cost, radius, patience, nodes and velocities; the steps
    that ran are the replica's, and the accept pattern with them (a step
    the replica rejected wholly keeps its cost and state)."""
    p, nodes0, vels0, ref = _reference(*case)
    res, _, _ = _port_residual(p, saturate=case[3])
    _, steps, active = lm_solve_trace(res, torch.from_numpy(nodes0),
                                      torch.from_numpy(vels0))
    n_active = int(active.sum())
    assert n_active == ref.steps, (n_active, ref.steps)
    assert bool(active[:n_active].all())
    last = None
    for i in range(n_active):
        rec = ref.trace[i]
        np.testing.assert_allclose(float(steps.cost[i]), rec.cost, rtol=1e-5,
                                   atol=1e-12, err_msg=f"cost at step {i}")
        np.testing.assert_allclose(float(steps.radius[i]), rec.radius,
                                   rtol=1e-9, err_msg=f"radius at step {i}")
        assert int(steps.patience[i]) == rec.patience, f"patience at {i}"
        _assert_state(steps.nodes[i], steps.vels[i], rec.nodes, rec.vels,
                      f"at step {i}")
        if last is not None and not rec.accepted:
            assert float(steps.cost[i]) == last, f"rejected step {i} moved"
        last = float(steps.cost[i])
    if case[3]:  # the saturated problem's steps reject trials
        assert sum(r.rejects for r in ref.trace) > 0


@pytest.mark.parametrize("case", CASES)
def test_lm_solve_manifold_lands_on_the_replica(case):
    """The solve without a record, and ``lm_solve_graphed`` (on the CPU
    the same solve), end where the replica ends, after its step count."""
    p, nodes0, vels0, ref = _reference(*case)
    res, res_inputs, inputs = _port_residual(p, saturate=case[3])
    n0, v0 = torch.from_numpy(nodes0), torch.from_numpy(vels0)
    nodes, vels, cost, steps = lm_solve_manifold(res, n0, v0)
    assert int(steps) == ref.steps
    np.testing.assert_allclose(float(cost), ref.cost, rtol=1e-5, atol=1e-12)
    _assert_state(nodes, vels, ref.nodes, ref.vels, "at the solution")
    g_nodes, g_vels, _, g_steps = lm_solve_graphed(
        res_inputs, inputs, n0, v0, key=("replica", case[3]))
    assert int(g_steps) == ref.steps
    assert torch.equal(g_nodes, nodes) and torch.equal(g_vels, vels)


def test_converged_solution_f32():
    """The production float32 path lands on the replica's solution
    (TestPyPoseParity.test_converged_solution_f32)."""
    rng = np.random.default_rng(3)
    p = testing.pvgo_problem(noise=0.02)
    nodes0, vels0 = testing.pvgo_perturbed_init(p, rng)
    ref = replica.pypose_lm_replica(*testing.pvgo_np_residual(p), nodes0,
                                    vels0)
    res, _, _ = _port_residual(p, torch.float32)
    nodes, vels, _, _ = lm_solve_manifold(
        res, torch.tensor(nodes0, dtype=torch.float32),
        torch.tensor(vels0, dtype=torch.float32))
    np.testing.assert_allclose(nodes[:, :3].numpy(), ref.nodes[:, :3],
                               atol=2e-3)
    np.testing.assert_allclose(vels.numpy(), ref.vels, atol=2e-3)


def test_quality_threshold_insensitive():
    """The converged solution is stable across the one undocumented
    constant, the TrustRegion quality threshold
    (TestPyPoseParity.test_quality_threshold_insensitive)."""
    rng = np.random.default_rng(4)
    p = testing.pvgo_problem(noise=0.02)
    nodes0, vels0 = testing.pvgo_perturbed_init(p, rng)
    res, _, _ = _port_residual(p, torch.float32)
    sols = []
    for qf in (1e-4, 1e-3, 1e-2):
        nodes, vels, _, _ = lm_solve_manifold(
            res, torch.tensor(nodes0, dtype=torch.float32),
            torch.tensor(vels0, dtype=torch.float32),
            LMConfig(quality_factor=qf))
        sols.append((nodes.numpy(), vels.numpy()))
    for n, v in sols[1:]:
        np.testing.assert_allclose(n[:, :3], sols[0][0][:, :3], atol=1e-4)
        np.testing.assert_allclose(v, sols[0][1], atol=1e-4)


@pytest.mark.parametrize("case", CASES[1:])
def test_copy_equals_the_jax_packages_replica_bitwise(case):
    """The port's copy and ``islam_tpu/pvgo/pypose_replica.py`` on the same
    numpy problem: every step record and the result bitwise equal."""
    p, nodes0, vels0, ref = _reference(*case)
    jref = jreplica.pypose_lm_replica(
        *testing.pvgo_np_residual(p, saturate=case[3]), nodes0, vels0)
    assert (ref.steps, ref.cost) == (jref.steps, jref.cost)
    assert np.array_equal(ref.nodes, jref.nodes)
    assert np.array_equal(ref.vels, jref.vels)
    assert len(ref.trace) == len(jref.trace)
    for a, b in zip(ref.trace, jref.trace):
        assert (a.cost, a.radius, a.rejects, a.accepted, a.patience) == (
            b.cost, b.radius, b.rejects, b.accepted, b.patience)
        assert np.array_equal(a.nodes, b.nodes)
        assert np.array_equal(a.vels, b.vels)
    xi = np.random.default_rng(case[1]).normal(size=(nodes0.shape[0], 6))
    assert np.array_equal(replica.retract_nodes(nodes0, xi),
                          jreplica.retract_nodes(nodes0, xi))


@pytest.mark.parametrize("noise,seed", [(0.0, 7), (0.02, 21)])
def test_problem_generator_matches_the_jax_tests(noise, seed):
    """``testing.pvgo_problem`` against tests/test_pvgo.py's generator,
    rebuilt here from the JAX package's Lie functions (the test module
    itself is not imported): float32, so within 1e-6."""
    import jax.numpy as jnp

    from islam_tpu import lie as jlie
    from islam_tpu.lie import SE3
    from islam_tpu.transformation import motion2pose as jmotion2pose

    p = testing.pvgo_problem(noise=noise, seed=seed)
    rng = np.random.default_rng(seed)
    xi = np.tile(np.asarray([[0.5, 0.02, -0.01, 0.01, 0.03, 0.005]]), (8, 1))
    xi += rng.normal(size=(8, 6)) * 0.01
    gt_motions = jlie.se3_exp(jnp.asarray(xi, jnp.float32))
    gt_poses = np.asarray(jmotion2pose(SE3(gt_motions)).data)
    vo = np.asarray(jlie.se3_mul(gt_motions, jlie.se3_exp(jnp.asarray(
        rng.normal(size=(8, 6)) * noise, jnp.float32))))
    np.testing.assert_allclose(p["gt_poses"], gt_poses, atol=1e-6)
    np.testing.assert_allclose(p["vo_motions"], vo, atol=1e-6)
    drots = np.asarray(jlie.quat_mul(jlie.quat_conj(gt_poses[:-1, 3:]),
                                     gt_poses[1:, 3:]))
    np.testing.assert_allclose(p["imu_drots"], drots, atol=1e-6)
