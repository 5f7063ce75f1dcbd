"""IMU preintegration over a window of samples, without a sequential loop.

Counterpart of ``islam_tpu/imu/preintegrator.py`` (PyPose's Euler
zero-order-hold preintegration):

    a_w(k)    = R_k @ acc_k + g_w            g_w = (0, 0, -gravity)
    pos_{k+1} = pos_k + vel_k dt + 0.5 a_w dt^2
    vel_{k+1} = vel_k + a_w dt
    q_{k+1}   = q_k * Exp(gyro_k dt)

The quaternion prefix product is a log-depth (Hillis-Steele) scan, the rest
cumulative sums.  Padded samples (``valid`` False) are dt = 0 no-ops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from islam_tpu_torch import lie


class IMUState(NamedTuple):
    pos: torch.Tensor  # (..., 3) world position
    rot: torch.Tensor  # (..., 4) world quaternion (x, y, z, w)
    vel: torch.Tensor  # (..., 3) world velocity


def preintegrate(dts: torch.Tensor, gyros: torch.Tensor, accels: torch.Tensor,
                 init: IMUState, gravity, valid=None) -> IMUState:
    """Integrate S samples; returns the state AFTER each sample, (S, 3/4/3).

    dts (S,) or (S, 1); gyros / accels (S, 3) body-frame rate / specific
    force; ``gravity`` the magnitude; ``valid`` optional (S,) bool.
    """
    dts = dts.reshape(-1, 1).to(accels.dtype)
    if valid is not None:
        dts = dts * valid.reshape(-1, 1).to(dts.dtype)
    g_w = lie.constant([0.0, 0.0, -1.0], accels.dtype,
                       accels.device) * gravity

    dq = lie.so3_exp(gyros * dts)
    qs = lie.quat_mul(init.rot[None], lie.prefix_product(lie.quat_mul, dq))
    q_before = torch.cat([init.rot[None], qs[:-1]])

    a_w = lie.quat_rotate(q_before, accels) + g_w
    vels = init.vel[None] + torch.cumsum(a_w * dts, dim=0)
    vel_before = torch.cat([init.vel[None], vels[:-1]])
    dp = vel_before * dts + 0.5 * a_w * dts * dts
    poss = init.pos[None] + torch.cumsum(dp, dim=0)

    # Renormalize quaternions (prefix products accumulate rounding).
    qs = qs / torch.linalg.norm(qs, dim=-1, keepdim=True)
    return IMUState(pos=poss, rot=qs, vel=vels)


def frame_states(states: IMUState, init: IMUState,
                 frame_ends: torch.Tensor) -> IMUState:
    """The states at each frame's last sample (preintegrator.py:87-101):
    ``frame_ends[i]`` indexes the window's samples, and -1 (a frame with no
    samples) selects ``init``."""
    idx = frame_ends + 1
    return IMUState(*(torch.cat([i[None], s])[idx]
                      for s, i in zip(states, init)))
