"""The IMU side of the plain reference: the window's samples, the denoiser
and PyPose's Euler preintegration, sample by sample in float64.

- ``window_samples``: the samples of frames [st, st + B] of a drive, as the
  reference's IMU integrator cuts them (imu_integrator.py: from the IMU
  index synced to frame st to the one synced to frame st + B).
- ``Denoiser``: IMUCorrector_CNN_GRU_WO_COV (Network/IMUDenoiseNet.py):
  Conv1d(6 -> 64, k = s = 10) + GELU, a GRU of 128 written out gate by
  gate, Linear 128 -> 64 + GELU, Linear 64 -> 6 + GELU; each token's
  correction repeats over its ten samples, the last whole token's over a
  partial one, and a window of fewer than ten samples gets none.
- ``integrate``: a_w = R_k acc_k - (0, 0, g), pos += vel dt + a_w dt^2 / 2,
  vel += a_w dt, q <- q Exp(gyro dt), one sample at a time; the states at
  each frame's last sample, and the per-pair deltas the pose graph takes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.ref import lie

TOKEN = 10


def window_samples(seq, st: int, B: int):
    """(dts (n,), gyros (n, 3), accels (n, 3), frame_ends (B + 1,)) of
    frames [st, st + B] of the parsed drive ``seq``: float64 arrays;
    ``frame_ends[j]`` is the index of frame st + j's last sample, -1 for the
    window's start."""
    sync = np.asarray(seq.rgb2imu_sync)
    dts = np.asarray(seq.imu_dts, np.float32).reshape(-1)
    if dts.shape[0] < len(seq.accels):
        dts = np.concatenate([dts, dts[-1:]])
    i0, i1 = int(sync[st]), int(sync[st + B])
    ends = np.array([int(sync[st + j]) - i0 - 1 for j in range(B + 1)])
    return (dts[i0:i1].astype(np.float64),
            np.asarray(seq.gyros[i0:i1], np.float64),
            np.asarray(seq.accels[i0:i1], np.float64), ends)


class Denoiser:
    """The denoiser's forward from its state dict, on ``device`` in
    ``dtype`` (float32; the control's bfloat16)."""

    def __init__(self, state_dict, device, dtype=torch.float32):
        self.p = {k: v.detach().to(device, dtype)
                  for k, v in state_dict.items()}
        self.device, self.dtype = device, dtype

    def corrections(self, acc, gyro):
        """(n, 3) x2 samples -> (n, 6) float64 corrections, per the rule
        above."""
        n = acc.shape[0]
        tokens = n // TOKEN
        if tokens < 1:
            return torch.zeros(n, 6, dtype=torch.float64)
        p = self.p
        x = torch.cat([acc, gyro], dim=1)[:tokens * TOKEN].to(
            self.device, self.dtype)
        tok = F.gelu(F.conv1d(x.T[None], p["conv1.weight"], p["conv1.bias"],
                              stride=TOKEN))[0].T           # (T, 64)
        wi, wh = p["gru.weight_ih_l0"], p["gru.weight_hh_l0"]
        bi, bh = p["gru.bias_ih_l0"], p["gru.bias_hh_l0"]
        H = wh.shape[1]
        h = torch.zeros(H, dtype=self.dtype, device=self.device)
        hs = []
        for t in range(tokens):
            gi = wi @ tok[t] + bi
            gh = wh @ h + bh
            r = torch.sigmoid(gi[:H] + gh[:H])
            z = torch.sigmoid(gi[H:2 * H] + gh[H:2 * H])
            c = torch.tanh(gi[2 * H:] + r * gh[2 * H:])
            h = (1 - z) * c + z * h
            hs.append(h)
        hs = torch.stack(hs)
        y = F.gelu(hs @ p["pose_decoder.0.weight"].T + p["pose_decoder.0.bias"])
        y = F.gelu(y @ p["pose_decoder.2.weight"].T + p["pose_decoder.2.bias"])
        k = np.minimum(np.arange(n) // TOKEN, tokens - 1)
        return y.double().cpu()[torch.as_tensor(k)]


def integrate(dts, gyros, accels, frame_ends, init, gravity, denoiser=None,
              denoise_accel=True, denoise_gyro=True, accel_bias=None,
              gyro_bias=None, dtype=torch.float64):
    """One window on the CPU in ``dtype`` (float64; the control's
    bfloat16), returned in float64.  ``init`` = (pos, quat xyzw, vel);
    with no denoiser the biases are subtracted from the streams the
    configuration denoises.  Returns {'pos', 'rot', 'vel'} (B + 1, .) at the
    frames (the init first; a frame with no samples gets zero velocity
    after the first) and {'dpos', 'drot', 'dvel'} (B, .)."""
    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dtype)

    dts, gyros, accels = t64(dts), t64(gyros), t64(accels)
    if denoiser is None:
        if denoise_accel and accel_bias is not None:
            accels = accels - t64(accel_bias)
        if denoise_gyro and gyro_bias is not None:
            gyros = gyros - t64(gyro_bias)
    else:
        corr = denoiser.corrections(accels, gyros).to(dtype)
        if denoise_accel:
            accels = accels + corr[:, :3]
        if denoise_gyro:
            gyros = gyros + corr[:, 3:]
    pos, q, vel = (t64(x) for x in init)
    g = torch.tensor([0.0, 0.0, -float(gravity)], dtype=dtype)
    states = [(pos, q, vel)]
    for k in range(dts.shape[0]):
        dt = dts[k]
        a_w = lie.quat_rotate(q, accels[k]) + g
        pos = pos + vel * dt + 0.5 * a_w * dt * dt
        vel = vel + a_w * dt
        q = lie.quat_mul(q, lie.so3_exp(gyros[k] * dt))
        q = q / torch.linalg.norm(q)
        states.append((pos, q, vel))
    idx = [int(e) + 1 for e in frame_ends]
    cum = torch.cat([torch.zeros(1, dtype=dtype), torch.cumsum(dts, 0)])
    P = torch.stack([states[i][0] for i in idx])
    Q = torch.stack([states[i][1] for i in idx])
    V = torch.stack([states[i][2] for i in idx])
    T = cum[idx]
    frame_T = T[1:] - T[:-1]
    out = {"drot": lie.quat_mul(lie.quat_conj(Q[:-1]), Q[1:]),
           "dvel": V[1:] - V[:-1],
           "dpos": P[1:] - P[:-1] - V[:-1] * frame_T[:, None]}
    has = torch.tensor([idx[j + 1] > idx[j] for j in range(len(idx) - 1)],
                       dtype=dtype)
    out.update(pos=P, rot=Q, vel=torch.cat([V[:1], V[1:] * has[:, None]]))
    return {k: v.double() for k, v in out.items()}
