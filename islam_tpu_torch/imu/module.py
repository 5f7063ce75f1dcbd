"""IMU integration over RGB-aligned windows: bias handling + preintegration.

Counterpart of ``islam_tpu/imu/module.py``.  One preintegration pass over the
window gives both output modes:

- world mode:  absolute (pos, rot, vel) at each frame end, init state first.
- motion mode: per-frame-pair deltas
    drot[i] = rot[i]^-1 * rot[i+1]
    dvel[i] = vel[i+1] - vel[i]
    dpos[i] = pos[i+1] - pos[i] - vel[i] * T_i

Frames with no IMU samples get zero world velocity; their deltas are zero.
With a learned denoiser (``imu/denoiser.py``) its correction replaces the
bias subtraction; without one the bias-subtraction path is active.
"""

from __future__ import annotations

import numpy as np
import torch

from islam_tpu_torch import lie
from islam_tpu_torch.imu.denoiser import TOKEN, denoise
from islam_tpu_torch.imu.preintegrator import IMUState, preintegrate


def integrate_window(denoise_params, dts, gyros, accels, n_valid, frame_ends,
                     has_frame, init: IMUState, gravity, accel_bias,
                     gyro_bias, subtract_bias, denoise_accel: bool = True,
                     denoise_gyro: bool = True):
    """Integrate one padded window.

    ``denoise_params``: an ``IMUDenoiser`` or None (bias subtraction).
    dts/gyros/accels (S,)/(S, 3)/(S, 3), zero past ``n_valid``;
    ``frame_ends`` (B+1,) index of each frame's last sample (-1 selects the
    init state); ``has_frame`` (B,) bool; ``subtract_bias`` bool tensor.
    Returns world-mode (pos, rot, vel) of shape (B+1, .) and motion-mode
    (dpos, drot, dvel) of shape (B, .).
    """
    valid = torch.arange(dts.shape[0], device=dts.device) < n_valid
    vf = valid[:, None].to(accels.dtype)

    sb = subtract_bias.to(accels.dtype)
    if denoise_accel:
        accels = accels - sb * accel_bias[None, :]
    if denoise_gyro:
        gyros = gyros - sb * gyro_bias[None, :]
    accels = accels * vf
    gyros = gyros * vf

    if denoise_params is not None:
        d_acc, d_gyro = denoise(denoise_params, accels, gyros, n_valid)
        if denoise_accel:
            accels = d_acc * vf
        if denoise_gyro:
            gyros = d_gyro * vf

    states = preintegrate(dts, gyros, accels, init, gravity, valid=valid)

    idx = (frame_ends + 1).long()  # -1 -> 0 (init)
    pos = torch.cat([init.pos[None], states.pos])[idx]  # (B+1, 3)
    rot = torch.cat([init.rot[None], states.rot])[idx]
    vel = torch.cat([init.vel[None], states.vel])[idx]

    cum_t = torch.cat([torch.zeros_like(dts[:1]),
                       torch.cumsum(dts * valid.to(dts.dtype), dim=0)])
    t_bound = cum_t[idx]
    frame_T = t_bound[1:] - t_bound[:-1]

    drot = lie.quat_mul(lie.quat_conj(rot[:-1]), rot[1:])
    dvel = vel[1:] - vel[:-1]
    dpos = pos[1:] - pos[:-1] - vel[:-1] * frame_T[:, None]

    hf = has_frame.to(vel.dtype)[:, None]
    vel = torch.cat([vel[:1], vel[1:] * hf])
    return {"pos": pos, "rot": rot, "vel": vel,
            "dpos": dpos, "drot": drot, "dvel": dvel}


class IMUModule:
    """Holds the full-sequence IMU samples on the host and builds each
    window's padded device inputs."""

    def __init__(self, accels, gyros, dts, accel_bias=None, gyro_bias=None,
                 gravity=9.81007, rgb2imu_sync=None, denoise_params=None,
                 denoise_accel=True, denoise_gyro=True, batch_frames=8,
                 device="cuda"):
        self.device = torch.device(device)
        self._accels_np = np.asarray(accels, np.float32)
        self._gyros_np = np.asarray(gyros, np.float32)
        dts = np.asarray(dts, np.float32).reshape(-1)
        # dts may be one shorter than samples (np.diff); pad with last value.
        if dts.shape[0] < self._accels_np.shape[0]:
            dts = np.concatenate([dts, dts[-1:]])
        self._dts_np = dts
        self.gravity = torch.tensor(float(gravity), device=self.device)

        n = self._accels_np.shape[0]
        self.rgb2imu_sync = (np.arange(n) if rgb2imu_sync is None
                             else np.asarray(rgb2imu_sync))

        def vec3(v):
            return torch.tensor(np.zeros(3) if v is None else np.asarray(v),
                                dtype=torch.float32, device=self.device)

        self.accel_bias = vec3(accel_bias)
        self.gyro_bias = vec3(gyro_bias)
        # Without a denoiser the optm_bias path is active
        # (imu_integrator.py:52): (not use_denoise_model) and (denoise_accel
        # or denoise_gyro), islam_tpu/imu/module.py:150-154.
        self.optm_bias = denoise_params is None and (
            denoise_accel or denoise_gyro)

        # Static padded window size: the most samples any window spans.
        sync = self.rgb2imu_sync
        spans = [sync[min(i + batch_frames, len(sync) - 1)] - sync[i]
                 for i in range(0, max(1, len(sync) - 1))]
        max_window_samples = int(max(spans)) + 1 if spans else 16
        self.S = int(-(-max_window_samples // TOKEN) * TOKEN)

    def window_inputs(self, st: int, end: int):
        """Fixed-shape padded inputs for frames [st, end]:
        (dts, gyros, accels, n_valid, frame_ends, has_frame)."""
        sync = self.rgb2imu_sync
        i0, i1 = int(sync[st]), int(sync[end])
        n_valid = i1 - i0
        S = self.S
        if n_valid > S:
            raise ValueError(f"window of {n_valid} samples exceeds {S}")

        def pad(x):
            out = np.zeros((S,) + x.shape[1:], np.float32)
            out[:n_valid] = x[:n_valid]
            return torch.from_numpy(out).to(self.device)

        frame_ends = np.asarray(
            [int(sync[i]) - i0 - 1 for i in range(st, end + 1)], np.int64)
        has_frame = frame_ends[1:] > frame_ends[:-1]
        return (pad(self._dts_np[i0:i1]), pad(self._gyros_np[i0:i1]),
                pad(self._accels_np[i0:i1]),
                torch.tensor(n_valid, device=self.device),
                torch.from_numpy(frame_ends).to(self.device),
                torch.from_numpy(has_frame).to(self.device))
