"""IMU denoising network (Conv1d tokenizer -> GRU -> MLP correction).

Counterpart of ``islam_tpu/imu/denoiser.py`` (reference
``IMUCorrector_CNN_GRU_WO_COV``, Network/IMUDenoiseNet.py:9-62):
Conv1d(6->64, k=10, s=10) + GELU, GRU(64->128), then Linear 128->64 and
64->6, with exact (erf) GELU after each of them, the last one included.  The
6-channel correction of each token is repeated back to the sample rate and
added to (acc, gyro).

The state_dict keys are the reference's (``conv1.*``,
``gru.{weight,bias}_{ih,hh}_l0``, ``pose_decoder.{0,2}.*``), so a reference
``.pkl`` loads as it is.  The JAX package runs the GRU as a ``lax.scan``;
here it is ``nn.GRU``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from islam_tpu_torch.imu.preintegrator import preintegrate

TOKEN = 10  # conv kernel == stride == 10 samples per token


class IMUDenoiser(nn.Module):
    def __init__(self, in_channel: int = 6, out_channel: int = 64,
                 hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv1d(in_channel, out_channel, TOKEN, TOKEN)
        self.gelu = nn.GELU()
        self.gru = nn.GRU(out_channel, hidden)
        self.pose_decoder = nn.Sequential(nn.Linear(hidden, 64), nn.GELU(),
                                          nn.Linear(64, 6), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, 6) samples -> (S // 10, 6) corrections, one per token."""
        tok = self.gelu(self.conv1(x.T[None]))[0].T      # (T, 64)
        hs, _ = self.gru(tok[:, None])                    # (T, 1, 128)
        return self.pose_decoder(hs[:, 0])


@torch.no_grad()
def init_denoiser(seed: int = 1, device="cuda") -> IMUDenoiser:
    """A denoiser with the JAX package's initialiser (uniform in
    +-1/sqrt(fan), decoder biases 0), drawn from ``seed``."""
    model = IMUDenoiser()
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith("pose_decoder") and name.endswith("bias"):
            p.zero_()
            continue
        fan = {"conv1": 6 * TOKEN, "gru": 128,
               "pose_decoder.0": 128, "pose_decoder.2": 64}[
                   name.rsplit(".", 1)[0]]
        p.uniform_(-1.0, 1.0, generator=gen).div_(math.sqrt(fan))
    return model.to(device)


def denoise(model: IMUDenoiser, acc: torch.Tensor, gyro: torch.Tensor,
            n_valid: torch.Tensor):
    """Correct (S, 3) acc/gyro given the true sample count ``n_valid`` (a
    device tensor; it is never read on the host).

    Samples past ``n_valid`` must be zero on input; their outputs are
    unspecified (masked downstream).  Sample k takes the correction of token
    min(k // 10, max(n_valid // 10, 1) - 1), the reference's
    repeat_interleave pattern at a static padded length, and no correction
    applies when n_valid < 10 (imu_integrator.py:107).  The GRU is causal, so
    the padded tokens change none of the valid ones.
    """
    S = acc.shape[0]
    out = model(torch.cat([acc, gyro], dim=-1))          # (S // 10, 6)
    t_valid = torch.clamp(n_valid // TOKEN, min=1)
    k = torch.arange(S, device=acc.device)
    corr = out[torch.minimum(k // TOKEN, t_valid - 1)]   # (S, 6)
    corr = torch.where(n_valid >= TOKEN, corr, torch.zeros_like(corr))
    return acc + corr[:, :3], gyro + corr[:, 3:]


def denoise_and_integrate(model: IMUDenoiser, acc, gyro, dts, init, gravity,
                          n_valid=None):
    """Denoise, then preintegrate the corrected stream (the reference's
    supervised ``IMUCorrector_CNN_GRU``, islam_tpu/imu/denoiser.py:111-123):
    per-sample world states.  ``n_valid`` defaults to every sample."""
    S = acc.shape[0]
    if n_valid is None:
        n_valid = torch.tensor(S, device=acc.device)
    d_acc, d_gyro = denoise(model, acc, gyro, n_valid)
    valid = torch.arange(S, device=acc.device) < n_valid
    return preintegrate(dts, d_gyro, d_acc, init, gravity, valid=valid)
