"""Quaternion-backed SO(3)/SE(3) Lie-group functions on torch tensors, for
the plain reference.

A frozen copy of the port's ``islam_tpu_torch/lie.py`` functions (the
wrapper classes left out), so that the reference imports nothing of the
program.  The storage conventions are PyPose's:

- SO3: ``[..., 4]`` quaternion (x, y, z, w), Hamilton, unit norm.
- SE3: ``[..., 7]`` as ``[tx, ty, tz, qx, qy, qz, qw]``.
- so3: ``[..., 3]`` rotation vector; se3: ``[..., 6]`` as ``[tau, phi]``.

Every trig path keeps the JAX package's Taylor guards with the double-where
trick, so values and ``torch.autograd`` gradients are finite at the identity.
"""

from __future__ import annotations

import torch

# Small-angle threshold: below this, use Taylor expansions. float32-safe.
_EPS = 1e-6


def constant(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device`` by a copy that does not block
    the host: a window on the card reads nothing back and waits for
    nothing (``torch.cuda.set_sync_debug_mode`` finds no sync in it)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Quaternion primitives (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions stored as (x, y, z, w)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` by unit quaternions ``q`` (active rotation R v)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    # v' = v + 2 qw (qv x v) + 2 qv x (qv x v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix ``[..., 3, 3]``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion (x, y, z, w), by
    branch-free Shepperd's method (the four candidates, picked per element)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1) \
        / (2.0 * safe_sqrt(1.0 + tr))[..., None]
    q1 = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12],
                     dim=-1) \
        / (2.0 * safe_sqrt(1.0 + m00 - m11 - m22))[..., None]
    q2 = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20],
                     dim=-1) \
        / (2.0 * safe_sqrt(1.0 - m00 + m11 - m22))[..., None]
    q3 = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01],
                     dim=-1) \
        / (2.0 * safe_sqrt(1.0 - m00 - m11 + m22))[..., None]

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# so(3) <-> SO(3)
# ---------------------------------------------------------------------------

def prefix_product(mul, x: torch.Tensor) -> torch.Tensor:
    """out[k] = x[0] * x[1] * ... * x[k] along dim 0 for an associative
    ``mul`` (quat_mul, se3_mul): a log-depth (Hillis-Steele) scan, the
    counterpart of ``jax.lax.associative_scan``."""
    out, shift = x, 1
    while shift < out.shape[0]:
        out = torch.cat([out[:shift], mul(out[:-shift], out[shift:])])
        shift *= 2
    return out


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector ``[..., 3]`` -> unit quaternion (x, y, z, w)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _EPS
    # Safe theta: 1.0 in the small branch so the exact branch never sees 0.
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    # sin(t/2)/t: Taylor 1/2 - t^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector with angle in [0, pi]."""
    # Force positive scalar part so the returned angle is minimal.
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    qv = q[..., :3]
    qw = q[..., 3:4]
    nv2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = nv2 < _EPS * _EPS
    nv_safe = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    qw_safe = torch.where(torch.abs(qw) < 1e-12, torch.ones_like(qw), qw)
    # angle/nv ~ 2/qw * (1 - nv^2/(3 qw^2)) for small nv
    scale = torch.where(
        small,
        2.0 / qw_safe * (1.0 - nv2 / (3.0 * qw_safe * qw_safe)),
        2.0 * torch.atan2(nv_safe, qw) / nv_safe,
    )
    return qv * scale


def so3_hat(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> skew-symmetric matrix ``[..., 3, 3]``."""
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _so3_left_jacobian_coeffs(phi: torch.Tensor):
    """Returns (A, B) with V = I + A [phi]x + B [phi]x^2. Double-where safe."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(t2_safe)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / t2_safe)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta_safe - torch.sin(theta_safe))
                    / (t2_safe * theta_safe))
    return a, b


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    a, b = _so3_left_jacobian_coeffs(phi)
    k = so3_hat(phi)
    return _eye3(phi) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(t2_safe)
    half = 0.5 * theta_safe
    # c = 1/theta^2 - (1 + cos t) / (2 t sin t) = 1/t^2 - cot(t/2)/(2t)
    sin_half = torch.sin(half)
    sin_safe = torch.where(torch.abs(sin_half) < 1e-12,
                           torch.ones_like(sin_half), sin_half)
    cot_half = torch.cos(half) / sin_safe
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2_safe - cot_half / (2.0 * theta_safe))
    k = so3_hat(phi)
    return _eye3(phi) - 0.5 * k + c[..., None, None] * (k @ k)


# ---------------------------------------------------------------------------
# se(3) <-> SE(3)   (storage: [t(3), q(4)]; tangent: [tau(3), phi(3)])
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` = [tau, phi] -> SE3 ``[..., 7]``."""
    tau, phi = xi[..., :3], xi[..., 3:]
    q = so3_exp(phi)
    t = (so3_left_jacobian(phi) @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 ``[..., 7]`` -> twist ``[..., 6]`` = [tau, phi]."""
    t, q = T[..., :3], T[..., 3:]
    phi = so3_log(q)
    tau = (so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def se3_mul(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    t1, q1 = T1[..., :3], T1[..., 3:]
    t2, q2 = T2[..., :3], T2[..., 3:]
    return torch.cat([t1 + quat_rotate(q1, t2), quat_mul(q1, q2)], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    t, q = T[..., :3], T[..., 3:]
    qinv = quat_conj(q)
    return torch.cat([-quat_rotate(qinv, t), qinv], dim=-1)


def se3_act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply transform to points ``[..., 3]``."""
    return quat_rotate(T[..., 3:], p) + T[..., :3]


def se3_to_matrix(T: torch.Tensor) -> torch.Tensor:
    R = quat_to_matrix(T[..., 3:])
    top = torch.cat([R, T[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], dim=-1)


def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,))


def so3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    base = torch.tensor([0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (4,))


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint ``[..., 6, 6]`` in [tau, phi] order: [[R, [t]x R], [0, R]]."""
    R = quat_to_matrix(T[..., 3:])
    tx = so3_hat(T[..., :3])
    top = torch.cat([R, tx @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Retractions (for manifold optimization, cf. the PVGO back-end)
# ---------------------------------------------------------------------------

def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: Exp(xi) o T."""
    return se3_mul(se3_exp(xi), T)


def so3_retract(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    return quat_mul(so3_exp(phi), q)


