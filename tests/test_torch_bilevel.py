"""The port's bi-level couplings through the PVGO solve (``--bilevel
detached|implicit|unrolled``) with and without the reprojection factor, vs
the JAX package.

PVGO problems are tests/test_pvgo.py's (B = 8, through
tests/test_torch_pvgo.py's ``_case``), with the reprojection losses of
tests/test_torch_dense_ba.py as the fifth factor.  The window-level step is
in tests/test_torch_bilevel_step.py.

Tolerances.  The implicit backward alone, on the same x*, theta and
cotangent (a 'vo' loss's): the port computes it in float64 (its Hessian
spans ~420 to ~1e-4 besides the gauge's null space, and in float32 the
solve loses most of lam along the velocity modes), and so does the JAX
reference here, under ``jax.enable_x64``; the gradients agree to the
float32 rounding of the result: atol 1e-6 x each gradient's max.  The
whole implicit solves are held against JAX in float64 too.

Whole solves: nodes 1e-4, velocities 2e-3 (an LM trial along a velocity is
decided on a cost tie, tests/test_torch_slice.py), losses rtol 1e-3, and
the gradients of the VO motions atol 2e-3 x max|g|: they pass through the
solution, whose float32 velocities carry that tie.  With the dense factor,
whose Jacobian is a sum of sign(e) de/dx over the pixels and changes with
every sign that flips, the two packages' float32 solves end 1.4e-4-3.3e-4
apart and their gradients up to 4.7e-3 x max|g| (measured on three
geometries; the unrolled mode, which rejects no step, up to 1.1e-3 and
1.2e-2 on the worst): nodes 1e-3, gradients 2e-2 x max|g|.  The implicit
and unrolled gradients differ by the unrolled solve's truncation: < 0.15
of max|g|, as tests/test_bilevel.py holds the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu.ops import dense_ba as jdba
from islam_tpu.pvgo import graph as jgraph
from islam_tpu.pvgo.lm import LMConfig as JLMConfig
from islam_tpu.pvgo.lm import lm_solve_implicit as jlm_implicit
from islam_tpu.pvgo.lm import lm_solve_unrolled as jlm_unrolled
from islam_tpu.pvgo.run import run_pvgo as jrun
from islam_tpu_torch.ops import dense_ba as tdba
from islam_tpu_torch.pvgo import graph as tgraph
from islam_tpu_torch.pvgo.lm import (LMConfig, implicit_vjp, lm_solve_implicit,
                                     lm_solve_manifold, lm_solve_unrolled)
from islam_tpu_torch.pvgo.run import run_pvgo

from tests.test_torch_dense_ba import (CX, CY, RGB2IMU, _dense_inputs,
                                       _sparse_pair)
from tests.test_torch_pvgo import _case, _torch

torch.set_num_threads(1)

W5 = (1.0, 0.1, 10.0, 0.1, 0.5)


def _dense_for_pvgo():
    """The dense factor for the PVGO problems: every pixel in front of the
    camera and, at fx = fy = 20, inside |uv| <= 0.85 under the problems'
    motions, so that no pixel crosses a mask edge between two float32
    solves (a crossing moves the L1 mean by a step)."""
    _, flow, mask = _dense_inputs(1)
    depth = np.random.default_rng(2).uniform(2, 6, mask.shape).astype(
        np.float32)
    f = 20.0
    j = jdba.DenseReprojectionLoss(depth, flow, f, f, CX, CY, mask, RGB2IMU)
    t = tdba.DenseReprojectionLoss(torch.from_numpy(depth),
                                   torch.from_numpy(flow), f, f, CX, CY,
                                   torch.from_numpy(mask),
                                   torch.from_numpy(RGB2IMU))
    return j, t


REPROJ = {"none": lambda: (None, None), "sparse": lambda: _sparse_pair(1),
          "dense": _dense_for_pvgo}


def _gclose(port, ref, rel, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, atol=rel * np.abs(ref).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# PVGO: run_pvgo in the three modes, the solves, the implicit backward
# ---------------------------------------------------------------------------

def _jax_run(a, mode, jreproj, target="vo", loss_weight=W5):
    if mode == "implicit":
        # the port computes the implicit backward in float64; so does JAX
        # here (the whole run, since its custom VJP runs in the inputs')
        with jax.enable_x64(True):
            out = _jax_run({k: v.astype(np.float64) if v.dtype == np.float32
                            else v for k, v in a.items()}, "implicit64",
                           jreproj, target, loss_weight)
        return out[0], *(np.asarray(x, np.float32) for x in out[1:3]), [
            np.asarray(g, np.float32) for g in out[3]]
    mode = "implicit" if mode == "implicit64" else mode

    def loss(vo, drots, dvels):
        tl, rl, n, v, _ = jrun(a["init_nodes"], a["init_vels"], vo,
                               a["links"], a["dts"], drots, a["imu_dtrans"],
                               dvels, loss_weight=loss_weight, reproj=jreproj,
                               target=target, bilevel=mode)
        return jnp.sum(tl) + jnp.sum(rl), (n, v)
    (l, (n, v)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                        has_aux=True)(
        a["vo_motions"], a["imu_drots"], a["imu_dvels"])
    return float(l), np.asarray(n), np.asarray(v), [np.asarray(x) for x in g]


def _port_run(a, mode, treproj, target="vo", loss_weight=W5):
    t = _torch(a)
    for k in ("vo_motions", "imu_drots", "imu_dvels"):
        t[k].requires_grad_(True)
    tl, rl, n, v, covs = run_pvgo(
        t["init_nodes"], t["init_vels"], t["vo_motions"], t["links"],
        t["dts"], t["imu_drots"], t["imu_dtrans"], t["imu_dvels"],
        loss_weight=loss_weight, reproj=treproj, target=target,
        bilevel=mode)
    loss = tl.sum() + rl.sum()
    loss.backward()
    grads = [np.zeros_like(a[k]) if t[k].grad is None else t[k].grad.numpy()
             for k in ("vo_motions", "imu_drots", "imu_dvels")]
    return float(loss.detach()), n.numpy(), v.numpy(), grads, covs


@pytest.mark.parametrize("reproj", ["none", "sparse", "dense"])
@pytest.mark.parametrize("mode", ["detached", "implicit", "unrolled"])
def test_run_pvgo_matches_jax(mode, reproj):
    """Solution, loss and the VO-motion gradient of the 'vo' target."""
    a = _case(7)
    jreproj, treproj = REPROJ[reproj]()
    jl, jn, jv, jg = _jax_run(a, mode, jreproj)
    tl, tn, tv, tg, covs = _port_run(a, mode, treproj)
    dense = reproj == "dense"
    np.testing.assert_allclose(tn, jn, atol=1e-3 if dense else 1e-4)
    np.testing.assert_allclose(tv, jv, atol=2e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert np.abs(tg[0]).max() > 0
    _gclose(tg[0], jg[0], 2e-2 if dense else 2e-3, f"{mode} {reproj}")
    if reproj == "none":
        assert "reproj" not in covs
    else:
        n = 1 if reproj == "dense" else treproj.N
        np.testing.assert_allclose(covs["reproj"].numpy(),
                                   np.full(8, (W5[4] / n) ** 2), rtol=1e-6)


@pytest.mark.parametrize("mode", ["implicit", "unrolled"])
def test_run_pvgo_imu_target_matches_jax(mode):
    """The 'imu' loss holds the solution constant in every mode: gradients
    reach the IMU rotations and velocity deltas directly."""
    a = _case(11)
    jl, jn, jv, jg = _jax_run(a, mode, None, target="imu")
    tl, tn, tv, tg, _ = _port_run(a, mode, None, target="imu")
    np.testing.assert_allclose(tn, jn, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert not np.any(tg[0])
    for got, ref in zip(tg[1:], jg[1:]):
        assert np.abs(got).max() > 0
        _gclose(got, ref, 2e-3, mode)


def test_unrolled_solve_matches_jax():
    """``lm_solve_unrolled`` alone: nodes and velocities after 5 steps, and
    the gradient of a fixed linear read-out of them in the VO motions."""
    a = _case(23, noise=0.05)
    t = _torch(a)
    rng = np.random.default_rng(0)
    cn = rng.normal(size=a["init_nodes"].shape).astype(np.float32)
    cv = rng.normal(size=a["init_vels"].shape).astype(np.float32)

    def jout(vo):
        def res(n, v):
            blocks = jgraph.pvgo_residuals(
                n, v, a["links"], vo, a["imu_drots"], a["imu_dtrans"],
                a["imu_dvels"], a["dts"])
            return jnp.concatenate([(b * w).reshape(-1)
                                    for b, w in zip(blocks, W5)])
        n, v = jlm_unrolled(res, a["init_nodes"], a["init_vels"])
        return jnp.sum(n * cn) + jnp.sum(v * cv), (n, v)

    (_, (jn, jv)), jg = jax.value_and_grad(jout, has_aux=True)(
        a["vo_motions"])
    vo = t["vo_motions"].requires_grad_(True)

    def tres(n, v):
        blocks = tgraph.pvgo_residuals(n, v, t["links"], vo, t["imu_drots"],
                                       t["imu_dtrans"], t["imu_dvels"],
                                       t["dts"])
        return torch.cat([(b * w).reshape(-1) for b, w in zip(blocks, W5)])

    tn, tv = lm_solve_unrolled(tres, t["init_nodes"], t["init_vels"])
    (torch.sum(tn * torch.from_numpy(cn))
     + torch.sum(tv * torch.from_numpy(cv))).backward()
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=2e-3)
    _gclose(vo.grad.numpy(), jg, 2e-3)


def _theta_residuals(a, jreproj):
    """The JAX and port residual functions of theta, as ``run_pvgo`` builds
    them for the implicit mode, and both thetas."""
    t = _torch(a)

    def jres(n, v, th):
        blocks = jgraph.pvgo_residuals(n, v, a["links"], th["poses"],
                                       th["drots"], a["imu_dtrans"],
                                       th["dvels"], a["dts"])
        out = [(b * w).reshape(-1) for b, w in zip(blocks, W5)]
        if jreproj is not None:
            rerr = jgraph.reproj_residual(n, th["reproj"])
            out.append((rerr * (W5[4] / max(rerr.shape[1] // 2, 1)))
                       .reshape(-1))
        return jnp.concatenate(out)

    jth = {"poses": jnp.asarray(a["vo_motions"]),
           "drots": jnp.asarray(a["imu_drots"]),
           "dvels": jnp.asarray(a["imu_dvels"]), "reproj": jreproj}
    return jres, jth, t


@pytest.mark.parametrize("reproj", ["none", "sparse", "dense"])
def test_implicit_backward_matches_jax(reproj):
    """The implicit VJP alone: the same converged x*, theta and cotangent
    go into JAX's custom VJP (an LM of 0 steps from x*) and the port's
    ``implicit_vjp``, and through ``lm_solve_implicit`` with autograd."""
    a = _case(7)
    jreproj, treproj = REPROJ[reproj]()
    jres, jth, t = _theta_residuals(a, jreproj)

    def tres(n, v, th):
        poses, drots, dvels, *rt = th
        blocks = tgraph.pvgo_residuals(n, v, t["links"], poses, drots,
                                       t["imu_dtrans"], dvels, t["dts"])
        out = [(b * w).reshape(-1) for b, w in zip(blocks, W5)]
        if treproj is not None:
            rerr = tgraph.reproj_residual(n, treproj.replace(rt))
            out.append((rerr * (W5[4] / max(rerr.shape[1] // 2, 1)))
                       .reshape(-1))
        return torch.cat(out)

    theta = (t["vo_motions"], t["imu_drots"], t["imu_dvels"],
             *(() if treproj is None else treproj.tensors()))

    # x*: the port's converged detached solution, unanchored
    xn, xv, _, _ = lm_solve_manifold(
        lambda n, v: tres(n, v, theta), t["init_nodes"], t["init_vels"])
    xn, xv = xn.numpy(), xv.numpy()
    # The cotangent of a randomly weighted 'vo' loss, as a 'vo' step feeds
    # the backward (the velocities get none)
    cw = np.random.default_rng(1).uniform(0.5, 1.5, 8).astype(np.float32)

    def readout(n):
        tl, rl = jgraph.vo_loss(n, jnp.asarray(a["links"]),
                                jnp.asarray(a["vo_motions"]),
                                detach_nodes=False)
        return jnp.sum(cw * (0.1 * tl + rl))

    nbar = np.asarray(jax.grad(readout)(jnp.asarray(xn)))
    vbar = np.zeros_like(xv)
    zero_steps = JLMConfig(max_steps=0)
    with jax.enable_x64(True):  # the port's backward runs in float64
        f64 = {k: jnp.asarray(v, jnp.float64) for k, v in jth.items()
               if k != "reproj"}
        f64["reproj"] = None if jreproj is None else (
            jax.tree_util.tree_map(lambda x: jnp.asarray(
                x, jnp.float64 if x.dtype == jnp.float32 else x.dtype),
                jreproj))
        x64 = [np.asarray(x, np.float64) for x in (xn, xv, nbar, vbar)]
        (jbar,) = jax.jit(lambda th, nb, vb: jax.vjp(
            lambda th: jlm_implicit(jres, th, x64[0], x64[1], zero_steps),
            th)[1]((nb, vb)))(f64, x64[2], x64[3])
        jbar = jax.device_get(jbar)
    jbar = [jbar["poses"], jbar["drots"], jbar["dvels"]] + (
        [] if treproj is None else
        [getattr(jbar["reproj"], f) for f in treproj.FIELDS])

    tbar = implicit_vjp(tres, torch.from_numpy(xn), torch.from_numpy(xv),
                        theta, torch.from_numpy(nbar), torch.from_numpy(vbar))
    leaves = tuple(x.detach().clone().requires_grad_(True) for x in theta)
    n, v = lm_solve_implicit(tres, leaves, torch.from_numpy(xn),
                             torch.from_numpy(xv), LMConfig(max_steps=0))
    assert torch.equal(n, torch.from_numpy(xn))
    torch.autograd.backward((n, v), (torch.from_numpy(nbar),
                                     torch.from_numpy(vbar)))
    assert len(tbar) == len(jbar)
    refs = [np.asarray(getattr(r, "data", r)) for r in jbar]  # SE3 -> data
    for i, (got, leaf, ref) in enumerate(zip(tbar, leaves, refs)):
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"theta[{i}]")
        assert torch.equal(leaf.grad, got), i
    assert np.abs(tbar[0].numpy()).max() > 0


def _vo_grad(mode, a, treproj=None):
    return _port_run(a, mode, treproj)[3][0]


def test_implicit_gradient_is_close_to_unrolled():
    """At a converged solution the implicit gradient approximates the
    unrolled one (tests/test_bilevel.py:48-57)."""
    a = _case(7)
    g_imp, g_unr = _vo_grad("implicit", a), _vo_grad("unrolled", a)
    assert np.abs(g_imp - g_unr).max() / np.abs(g_unr).max() < 0.15


@pytest.mark.parametrize("reproj", ["none", "dense"])
def test_implicit_gradient_differs_from_detached(reproj):
    """The implicit gradient includes the solution's dependence on the VO
    motions, so it is nonzero and not the detached one."""
    a = _case(7, noise=0.05)
    _, treproj = REPROJ[reproj]()
    g_det = _vo_grad("detached", a, treproj)
    g_imp = _vo_grad("implicit", a, treproj)
    assert np.isfinite(g_imp).all() and np.abs(g_imp).max() > 0
    assert np.abs(g_imp - g_det).max() > 1e-3 * np.abs(g_det).max()
