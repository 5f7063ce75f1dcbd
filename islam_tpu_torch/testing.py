"""Shared fixtures: synthetic sequences and window inputs for tests,
benchmarks and dry runs.

Counterpart of ``islam_tpu/testing.py``.  The transform and the window copy
are the training path's own (``train.make_transform``,
``train.device_batch``).  Tensors go to ``device`` (default ``cuda``).
"""

from __future__ import annotations

import numpy as np
import torch

from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.module import IMUModule
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.train import device_batch, make_transform

__all__ = ["make_transform", "make_dataset", "make_imu_module",
           "make_step_inputs", "device_batch", "init_state",
           "make_sequences", "SEQ1_CALIB", "unequal_paths"]

# Sequence 1's calibration in the multi-sequence sets (the JAX package's
# tests/test_parallel.py:229-232): another T_BS, gravity and accelerometer
# bias, as KITTI drives of other dates have.
SEQ1_CALIB = {"rgb2imu_pose": np.asarray(
    [0.1, -0.05, 0.2, 0.0, 0.0, 0.1736482, 0.9848078], np.float32),
    "gravity": 9.5,
    "accel_bias": np.asarray([0.05, -0.02, 0.01], np.float32)}


def make_dataset(num_frames: int = 17, height: int = 448, width: int = 640,
                 seed: int = 0) -> SyntheticTrajDataset:
    return SyntheticTrajDataset(
        num_frames=num_frames, height=height, width=width, seed=seed,
        transform=make_transform(height, width))


def make_sequences(seeds, num_frames: int = 17, height: int = 448,
                   width: int = 640):
    """One synthetic sequence per seed (``make_dataset``), the seed-1 one
    on ``SEQ1_CALIB``."""
    datasets = [make_dataset(num_frames, height, width, seed=s)
                for s in seeds]
    for s, ds in zip(seeds, datasets):
        if s == 1:
            for k, v in SEQ1_CALIB.items():
                setattr(ds, k, v)
    return datasets


def make_imu_module(dataset, batch_frames: int = 8, denoise_params=None,
                    device="cuda") -> IMUModule:
    return IMUModule(
        dataset.accels, dataset.gyros, dataset.imu_dts,
        dataset.accel_bias, dataset.gyro_bias, gravity=dataset.gravity,
        rgb2imu_sync=dataset.rgb2imu_sync, denoise_params=denoise_params,
        denoise_accel=True, denoise_gyro=(dataset.datatype != "kitti"),
        batch_frames=batch_frames, device=device)


def init_state(dataset, device="cuda") -> IMUState:
    """The dataset's initial IMU state as float32 tensors on ``device``."""
    init = dataset.imu_init
    return IMUState(*(torch.tensor(np.asarray(init[k]), dtype=torch.float32,
                                   device=device)
                      for k in ("pos", "rot", "vel")))


def make_step_inputs(dataset, imu_module, start: int = 0, B: int = 8,
                     device="cuda"):
    """(batch, imu_win, init_state) for a window of B frame-pairs."""
    sample = collate([dataset[i] for i in range(start, start + B)])
    batch = device_batch(sample, start, device)
    imu_win = imu_module.window_inputs(start, start + B)
    return batch, imu_win, init_state(dataset, device)


def unequal_paths(a, b, path=""):
    """The paths at which two nested states (dicts, lists, tensors,
    numbers) differ bitwise, or []."""
    if torch.is_tensor(a):
        return [] if (torch.is_tensor(b) and a.dtype == b.dtype
                      and a.shape == b.shape
                      and torch.equal(a.cpu(), b.cpu())) else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path + "/keys"]
        return [p for k in a for p in unequal_paths(a[k], b[k],
                                                    f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path + "/len"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in unequal_paths(x, y, f"{path}/{i}")]
    return [] if a == b else [path]
