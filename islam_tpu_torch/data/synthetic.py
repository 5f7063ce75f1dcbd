"""Synthetic trajectory dataset: known GT motions + consistent IMU + images.

A copy of ``islam_tpu/data/synthetic.py`` (same seed, same numbers): a smooth
random trajectory with exactly consistent 100 Hz IMU (so preintegration
reproduces GT), textured random stereo images, and the attribute surface of
the reference's TrajFolderDataset.  It stands in for KITTI/EuRoC folders.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation as R

from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.transforms import make_intrinsics_layer
from islam_tpu_torch.transformation import relative_twists


class SyntheticTrajDataset:
    """Duck-typed TrajFolderDataset over generated data."""

    def __init__(self, num_frames: int = 33, height: int = 448,
                 width: int = 640, imu_per_frame: int = 10,
                 gravity: float = 9.81, seed: int = 0,
                 datatype: str = "kitti", transform=None):
        rng = np.random.default_rng(seed)
        self.datatype = datatype
        self.transform = transform
        self.num_img = num_frames
        N = num_frames

        dt_frame = 0.1
        S = (N - 1) * imu_per_frame + 1
        dt_imu = dt_frame / imu_per_frame

        # --- build a smooth GT trajectory by integrating smooth body rates
        gyro = np.zeros((S, 3), np.float32)
        acc_w = np.zeros((S, 3), np.float32)  # world linear acceleration
        t_axis = np.arange(S) * dt_imu
        for k in range(3):
            gyro[:, k] = 0.05 * np.sin(0.5 * t_axis + rng.uniform(0, 6)) \
                + 0.02 * rng.standard_normal()
            acc_w[:, k] = 0.4 * np.sin(0.8 * t_axis + rng.uniform(0, 6))
        acc_w[:, 0] += 0.5  # mostly-forward push

        qs = np.zeros((S, 4), np.float32)
        qs[0] = [0, 0, 0, 1]
        vels = np.zeros((S, 3), np.float32)
        vels[0] = [1.0, 0.0, 0.0]
        poss = np.zeros((S, 3), np.float32)
        for i in range(S - 1):
            rot = R.from_quat(qs[i])
            poss[i + 1] = poss[i] + vels[i] * dt_imu \
                + 0.5 * acc_w[i] * dt_imu ** 2
            vels[i + 1] = vels[i] + acc_w[i] * dt_imu
            dq = R.from_rotvec(gyro[i] * dt_imu)
            qs[i + 1] = (rot * dq).as_quat()

        # accelerometer measures specific force: R^T (a_w - g_w)
        g_w = np.array([0, 0, -gravity], np.float32)
        accels = np.stack([
            R.from_quat(qs[i]).inv().apply(acc_w[i] - g_w)
            for i in range(S)]).astype(np.float32)

        self.accels = accels
        self.gyros = gyro
        self.imu_dts = np.full(S - 1, dt_imu, np.float32)
        self.imu_ts = t_axis
        self.rgb2imu_sync = np.arange(N) * imu_per_frame
        self.rgb2imu_pose = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
        self.gravity = gravity
        self.accel_bias = np.zeros(3, np.float32)
        self.gyro_bias = np.zeros(3, np.float32)
        self.has_imu = True

        frame_idx = self.rgb2imu_sync
        self.poses = np.concatenate(
            [poss[frame_idx], qs[frame_idx]], axis=1).astype(np.float32)
        self.vels = vels[frame_idx]
        self.rgb_dts = np.full(N - 1, dt_frame, np.float32)
        self.rgb_ts = np.arange(N, dtype=np.float64) * dt_frame
        self.imu_init = {'rot': self.poses[0, 3:], 'pos': self.poses[0, :3],
                         'vel': self.vels[0]}

        self.intrinsic = np.array(
            [width * 0.6, width * 0.6, width / 2, height / 2], np.float32)
        self.right2left_pose = np.array([0.5, 0, 0, 0, 0, 0, 1], np.float32)

        self.height = height
        self.width = width
        self._rng = rng
        # One shared texture; per-frame crops emulate camera motion cheaply.
        self._tex = (rng.uniform(
            0, 255, (height + 64, width + 64, 3))).astype(np.uint8)

        self.links = [[i, i + 1] for i in range(N - 1)]
        self.num_link = len(self.links)
        self.motions = relative_twists(
            self.poses, links=self.links).astype(np.float32)

    def __len__(self):
        return self.num_link

    def _frame_image(self, i):
        ox = (i * 7) % 64
        oy = (i * 3) % 64
        return self._tex[oy:oy + self.height, ox:ox + self.width].copy()

    def window(self, start, B, tally=None):
        """Window [start, start+B): the collate of its pairs
        (``TrajFolderDataset.window``'s interface): rendered, no image
        decoded, so ``tally`` is left as it is."""
        return collate([self[i] for i in range(start, start + B)])

    def __getitem__(self, idx):
        i, j = self.links[idx]
        res: Dict = {
            'img0': [self._frame_image(i).astype(np.float32)],
            'img1': [self._frame_image(j).astype(np.float32)],
            'img0_r': [self._frame_image(i + 1000).astype(np.float32)],
            'img1_r': [self._frame_image(j + 1000).astype(np.float32)],
            'intrinsic': [make_intrinsics_layer(
                self.width, self.height, *self.intrinsic)],
            'intrinsic_calib': self.intrinsic.copy(),
        }
        if self.transform:
            res = self.transform(res)
        res['link'] = np.array([i, j])
        res['dt'] = np.sum(self.rgb_dts[i:j])
        res['datatype'] = self.datatype

        Ti = np.eye(4)
        Ti[:3, :3] = R.from_quat(self.poses[i, 3:]).as_matrix()
        Ti[:3, 3] = self.poses[i, :3]
        Tj = np.eye(4)
        Tj[:3, :3] = R.from_quat(self.poses[j, 3:]).as_matrix()
        Tj[:3, 3] = self.poses[j, :3]
        M = np.linalg.inv(Ti) @ Tj
        q = R.from_matrix(M[:3, :3]).as_quat()
        res['motion'] = np.concatenate([M[:3, 3], q]).astype(np.float32)
        res['extrinsic'] = self.right2left_pose.copy()
        return res
