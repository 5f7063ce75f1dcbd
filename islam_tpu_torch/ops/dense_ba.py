"""Dense and sparse differentiable reprojection losses: the optional fifth
PVGO factor (``--reproj-points``).

Counterpart of ``islam_tpu/ops/dense_ba.py`` (reference dense_ba.py:179-305).
Each loss holds its tensors and maps the SE3 motions (B, 7) of the graph's
consecutive nodes, in the IMU frame, to an error that is differentiable in
the motions.  The implicit bi-level mode needs every tensor that may carry a
gradient as a formal input of its ``torch.autograd.Function``, so a loss
lists them (``tensors``) and is rebuilt around new ones (``replace``), as the
JAX package flattens its losses as pytrees.  The keypoint picker
(``detect_keypoints``) and ``SparseReprojectionLoss.debug`` need cv2, and are
not ported.
"""

from __future__ import annotations

import copy

import torch

from islam_tpu_torch import lie
from islam_tpu_torch.ops.geometry import (intrinsics_matrix, pixel2point,
                                          reprojerr)


def _proj_with_mask(x):
    """Perspective divide where z > 0.1 and |uv| <= 1 (dense_ba.py:74-85).
    The divisor is itself masked, so masked pixels give 0 and not 0 * inf
    in the gradient."""
    z = x[..., -1:]
    mask = z > 0.1
    p = torch.where(mask, x / torch.where(mask, z, torch.ones_like(z)), 0.0)
    inb = ((p[..., 0:1] >= -1) & (p[..., 0:1] <= 1)
           & (p[..., 1:2] >= -1) & (p[..., 1:2] <= 1))
    mask = mask & inb
    return torch.where(mask, p, 0.0), mask[..., 0]


def _intrinsics(fx, fy, cx, cy, like):
    return intrinsics_matrix(*(torch.as_tensor(v, dtype=like.dtype,
                                               device=like.device)
                               for v in (fx, fy, cx, cy)))


class _Loss:
    FIELDS = ()

    def tensors(self):
        """The floating-point tensors, in ``FIELDS`` order."""
        return tuple(getattr(self, f) for f in self.FIELDS)

    def replace(self, tensors):
        """A copy of the loss holding ``tensors`` in place of its own."""
        out = copy.copy(self)
        for f, t in zip(self.FIELDS, tensors):
            setattr(out, f, t)
        return out

    def _camera_motion(self, motion):
        """IMU-frame motions -> camera-frame ones: (T_IL^-1 m) T_IL.  The
        products are grouped as the JAX package groups them: off unit norm
        the two groupings differ, and so do their quaternion gradients."""
        return lie.se3_mul(lie.se3_mul(lie.se3_inv(self.rgb2imu_pose),
                                       motion), self.rgb2imu_pose)


class DenseReprojectionLoss(_Loss):
    """dense_ba.py:179-273.  depth (B, H, W), flow (B, 2, H, W) in pixels,
    mask (B, H, W), scalar intrinsics, ``rgb2imu_pose`` (7,).  Called with
    the motions (B, 7), it returns the per-frame masked mean L1 error (B,)
    between the flow target and the reprojection of every pixel."""

    FIELDS = ("z", "flow", "rgb2imu_pose", "uv", "uv1", "K", "K_inv")

    def __init__(self, depth, flow, fx, fy, cx, cy, mask, rgb2imu_pose):
        self.z, self.flow = depth, flow
        self.mask = mask > 0
        self.rgb2imu_pose = rgb2imu_pose
        _, H, W = depth.shape
        v, u = torch.meshgrid(
            torch.arange(H, dtype=depth.dtype, device=depth.device),
            torch.arange(W, dtype=depth.dtype, device=depth.device),
            indexing="ij")
        self.uv = torch.stack([u, v])[None]                      # (1, 2, H, W)
        self.uv1 = torch.stack([u, v, torch.ones_like(u)], -1)  # (H, W, 3)
        self.K = _intrinsics(fx, fy, cx, cy, depth)
        self.K_inv = torch.linalg.inv_ex(self.K).inverse

    def __call__(self, motion):
        T = self._camera_motion(motion)
        P = self.z[..., None] * torch.einsum("ij,hwj->hwi", self.K_inv,
                                             self.uv1)[None]
        P = lie.se3_act(lie.se3_inv(T)[:, None, None, :], P)
        p, reproj_mask = _proj_with_mask(P)
        mf = (self.mask & reproj_mask).to(P.dtype)
        reproj = torch.einsum("ij,bhwj->bihw", self.K, p)[:, :2]
        l1 = torch.sum(torch.abs(reproj - (self.flow + self.uv)), dim=1)
        return torch.sum(l1 * mf, dim=(1, 2)) / torch.clamp(
            torch.sum(mf, dim=(1, 2)), min=1.0)


class SparseReprojectionLoss(_Loss):
    """dense_ba.py:276-305.  points2d (B, N, 2) pixel positions, depth
    (B, H, W), flow (B, 2, H, W), scalar intrinsics, ``rgb2imu_pose`` (7,).
    Called with the motions (B, 7), it returns the error (B, N, 2) of each
    keypoint's reprojection against its flow target."""

    FIELDS = ("K", "point3d", "target", "rgb2imu_pose")

    def __init__(self, points2d, depth, flow, fx, fy, cx, cy, rgb2imu_pose):
        B, self.N = points2d.shape[:2]
        self.K = _intrinsics(fx, fy, cx, cy, depth)
        iy = points2d[..., 1].to(torch.int64)
        ix = points2d[..., 0].to(torch.int64)
        bidx = torch.arange(B, device=depth.device)[:, None]
        self.point3d = pixel2point(points2d, depth[bidx, iy, ix], self.K)
        self.target = flow.permute(0, 2, 3, 1)[bidx, iy, ix] + points2d
        self.rgb2imu_pose = rgb2imu_pose

    def __call__(self, motion):
        T = self._camera_motion(motion)
        return reprojerr(self.point3d, self.target, self.K,
                         lie.se3_inv(T)[:, None, :])
