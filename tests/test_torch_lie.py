"""Port Lie-group functions vs the JAX package: values and gradients, at the
identity and on random batches.

float32 on both sides; the formulas are the same, so values agree to a few
ulp (atol 1e-6 on unit-scale outputs).  Gradients of sum(sin(f(x))) come
from torch.autograd and jax.grad (atol 1e-5: a few float32 ulp of the
derivative chain).  At the identity the Taylor branches must give finite,
equal gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from islam_tpu import lie as jl
from islam_tpu_torch import lie as tl

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-lie")


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(kind, n, identity):
    if kind == "quat":
        q = np.tile([0, 0, 0, 1.0], (n, 1)) if identity else _unit(
            RNG.normal(size=(n, 4)))
        return q.astype(np.float32)
    if kind == "vec3":
        return (np.zeros((n, 3)) if identity
                else RNG.normal(size=(n, 3))).astype(np.float32)
    if kind == "twist":
        return (np.zeros((n, 6)) if identity
                else 0.7 * RNG.normal(size=(n, 6))).astype(np.float32)
    if kind == "se3":
        t = np.zeros((n, 3)) if identity else RNG.normal(size=(n, 3))
        return np.concatenate([t, _inputs("quat", n, identity)],
                              axis=1).astype(np.float32)
    if kind == "mat":
        return np.array(jl.quat_to_matrix(_inputs("quat", n, identity)))
    if kind == "mat4":
        return np.array(jl.se3_to_matrix(_inputs("se3", n, identity)))
    raise ValueError(kind)


# name -> argument kinds
FUNCS = {
    "quat_mul": ("quat", "quat"),
    "quat_conj": ("quat",),
    "quat_rotate": ("quat", "vec3"),
    "quat_to_matrix": ("quat",),
    "matrix_to_quat": ("mat",),
    "so3_exp": ("vec3",),
    "so3_log": ("quat",),
    "so3_hat": ("vec3",),
    "so3_left_jacobian": ("vec3",),
    "so3_left_jacobian_inv": ("vec3",),
    "se3_exp": ("twist",),
    "se3_log": ("se3",),
    "se3_mul": ("se3", "se3"),
    "se3_inv": ("se3",),
    "se3_act": ("se3", "vec3"),
    "se3_to_matrix": ("se3",),
    "se3_from_matrix": ("mat4",),
    "se3_adjoint": ("se3",),
    "se3_retract": ("se3", "twist"),
    "so3_retract": ("quat", "vec3"),
}
# Functions whose gradients are compared (smooth in their inputs).
GRAD_FUNCS = ["quat_mul", "quat_rotate", "so3_exp", "so3_log",
              "so3_left_jacobian", "so3_left_jacobian_inv", "se3_exp",
              "se3_log", "se3_mul", "se3_inv", "se3_retract"]


@pytest.mark.parametrize("identity", [False, True], ids=["random", "identity"])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_values(name, identity):
    args = [_inputs(k, 5, identity) for k in FUNCS[name]]
    ref = np.asarray(getattr(jl, name)(*(jnp.asarray(a) for a in args)))
    out = getattr(tl, name)(*(torch.from_numpy(a) for a in args)).numpy()
    if name in ("matrix_to_quat", "se3_from_matrix"):
        # q and -q are one rotation: compare up to sign
        sign = np.sign(np.sum(out[..., -4:] * ref[..., -4:], axis=-1,
                              keepdims=True))
        out = np.concatenate([out[..., :-4], out[..., -4:] * sign], axis=-1)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("identity", [False, True], ids=["random", "identity"])
@pytest.mark.parametrize("name", GRAD_FUNCS)
def test_gradients(name, identity):
    args = [_inputs(k, 4, identity) for k in FUNCS[name]]
    jf, tf = getattr(jl, name), getattr(tl, name)
    argnums = tuple(range(len(args)))
    ref = jax.grad(lambda *a: jnp.sum(jnp.sin(jf(*a))), argnums=argnums)(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    torch.sum(torch.sin(tf(*targs))).backward()
    for t, r in zip(targs, ref):
        g = t.grad.numpy()
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-4)


def test_wrappers():
    a, b = _inputs("se3", 3, False), _inputs("se3", 3, False)
    p = _inputs("vec3", 3, False)
    A, Bt = tl.SE3(torch.from_numpy(a)), tl.SE3(torch.from_numpy(b))
    ja, jb = jl.SE3(jnp.asarray(a)), jl.SE3(jnp.asarray(b))
    np.testing.assert_allclose((A @ Bt.Inv()).data.numpy(),
                               np.asarray((ja @ jb.Inv()).data), atol=1e-6)
    np.testing.assert_allclose((A @ torch.from_numpy(p)).numpy(),
                               np.asarray(ja @ jnp.asarray(p)), atol=1e-6)
    np.testing.assert_allclose(A.rotation().Log().numpy(),
                               np.asarray(ja.rotation().Log()), atol=1e-6)
