"""IMU bias calibration: constant accelerometer and gyro biases learned by
preintegrating the whole IMU stream against anchor poses.

Counterpart of ``islam_tpu/imu/bias.py`` (reference ``IMUFwd``/``optm_bias``,
imu_integrator.py:167-237): Adam with optax's rule (``optim.adam``) and
ReduceLROnPlateau(factor=0.2, patience=2), which starts Adam afresh at the
lower rate.  It is the path for sequences without a denoiser; no trainer
epoch calls it, in the JAX package either.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from islam_tpu_torch import lie, optim
from islam_tpu_torch.imu.preintegrator import IMUState, preintegrate


def bias_objective(biases: Dict[str, torch.Tensor], accels, gyros, dts,
                   poses, sync, init: IMUState, gravity):
    """The rotation and translation error of the preintegrated trajectory
    at the synced frames (imu_integrator.py:186-196): the norm of the
    stacked rotation Logs plus the translation MSE.  ``biases`` holds
    'accel' and 'gyro' (3,), ``poses`` (F, 7) anchor poses and ``sync``
    (F,) the IMU sample count at each frame."""
    states = preintegrate(dts, gyros - biases["gyro"][None],
                          accels - biases["accel"][None], init, gravity)
    # full[j] is the state after j samples, so full[sync[i]] is frame i's
    pos = torch.cat([init.pos[None], states.pos])[sync]
    rot = torch.cat([init.rot[None], states.rot])[sync]
    roterr = lie.so3_log(lie.quat_mul(lie.quat_conj(poses[:, 3:]), rot))
    return (torch.linalg.norm(roterr.reshape(-1))
            + torch.mean((poses[:, :3] - pos) ** 2))


def optimize_bias(lr: float, epochs: int, poses, sync, accels, gyros,
                  accel_bias, gyro_bias, dts, init, gravity,
                  verbose: bool = False, device="cuda"):
    """``epochs`` Adam steps on ``bias_objective`` from the given biases,
    with ReduceLROnPlateau(factor=0.2, patience=2) (imu_integrator.py:
    212-237).  Array inputs are numpy; ``init`` is a dict of 'pos', 'rot',
    'vel'.  Returns (accel_bias, gyro_bias, per-epoch losses)."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    accels, gyros, poses = f32(accels), f32(gyros), f32(poses)
    dts = np.asarray(dts, np.float32).reshape(-1)
    if dts.shape[0] < accels.shape[0]:
        dts = np.concatenate([dts, np.zeros(1, np.float32)])
    dts = f32(dts)
    sync = torch.tensor(np.asarray(sync), dtype=torch.int64, device=device)
    init = IMUState(*(f32(init[k]) for k in ("pos", "rot", "vel")))
    gravity = torch.tensor(float(gravity), device=device)
    biases = {"accel": f32(accel_bias), "gyro": f32(gyro_bias)}

    cur_lr = lr
    opt = optim.adam(cur_lr)
    state = opt.init(biases)
    best, plateau, history = np.inf, 0, []
    for _ in range(epochs):
        leaves = {k: v.requires_grad_(True) for k, v in biases.items()}
        loss = bias_objective(leaves, accels, gyros, dts, poses, sync, init,
                              gravity)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        loss = float(loss.detach())
        history.append(loss)
        updates, state = opt.update(grads, state)
        biases = {k: (v + updates[k]).detach() for k, v in biases.items()}
        if loss < best - 1e-8:
            best, plateau = loss, 0
        else:
            plateau += 1
            if plateau > 2:
                cur_lr *= 0.2
                opt = optim.adam(cur_lr)
                state = opt.init(biases)
                plateau = 0
        if verbose:
            print(f"IMU bias loss: {loss:.6f}\tlr={cur_lr:g}")
    return biases["accel"], biases["gyro"], history
