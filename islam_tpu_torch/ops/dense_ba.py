"""Dense and sparse differentiable reprojection losses: the optional fifth
PVGO factor (``--reproj-points``).

Counterpart of ``islam_tpu/ops/dense_ba.py`` (reference dense_ba.py:179-305).
Each loss holds its tensors and maps the SE3 motions (B, 7) of the graph's
consecutive nodes, in the IMU frame, to an error that is differentiable in
the motions.  The implicit bi-level mode needs every tensor that may carry a
gradient as a formal input of its ``torch.autograd.Function``, so a loss
lists them (``tensors``) and is rebuilt around new ones (``replace``), as the
JAX package flattens its losses as pytrees.  ``detect_keypoints`` picks a
sparse loss's points with the port's SIFT (``ops/sift.py``), and
``SparseReprojectionLoss.debug`` draws its keypoint overlays; neither needs
cv2.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from islam_tpu_torch import lie
from islam_tpu_torch.data.image_io import write_png
from islam_tpu_torch.ops.geometry import (intrinsics_matrix, pixel2point,
                                          point2pixel, reprojerr)
from islam_tpu_torch.ops.sift import sift_keypoints
from islam_tpu_torch.utils.visualization import (draw_circle, draw_line,
                                                 resize_u8)


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

    def debug(self, motion, img0, img1, width: int, height: int,
              scale: int = 4, out_dir: str = "temp"):
        """The keypoint overlay (dense_ba.py:308-344): both frames resized
        to ``scale`` x (``width``, ``height``) side by side, a circle at
        each tracked point, a blue line to its reprojection under
        ``motion`` (zeroed where it leaves the image) and a green one from
        the flow target, written as ``{out_dir}/{i}_reproj.png`` per batch
        element.  ``img0``/``img1`` are (B, H, W, 3) floats in [0, 1]; the
        colours are cv2's BGR tuples drawn into the unswapped RGB bytes, as
        the JAX package draws them.  The geometry and the resize run on the
        loss's device, the drawing and the PNG on the host."""
        os.makedirs(out_dir, exist_ok=True)
        img0, img1 = ((np.asarray(x.cpu() if torch.is_tensor(x) else x)
                       * 255).astype(np.uint8) for x in (img0, img1))
        T = lie.se3_inv(self._camera_motion(motion))[:, None, :]
        pts0 = point2pixel(self.point3d, self.K).cpu().numpy()
        pts1 = point2pixel(self.point3d, self.K, T).cpu().numpy()
        inside = ((pts1[..., 0] >= 0) & (pts1[..., 0] < width)
                  & (pts1[..., 1] >= 0) & (pts1[..., 1] < height))
        pts1 = np.where(inside[..., None], pts1, 0.0)
        target = self.target.cpu().numpy()

        def px(p):
            return np.round(p * scale).astype(int)

        for i, (il, ir, pl, pr, tar) in enumerate(
                zip(img0, img1, pts0, pts1, target)):
            il, ir = (resize_u8(torch.from_numpy(x).to(self.K.device),
                                width * scale / x.shape[1],
                                height * scale / x.shape[0]).cpu().numpy()
                      for x in (il, ir))
            for p in pl:
                draw_circle(il, px(p), 2, (0, 0, 255))
            for p in pr:
                draw_circle(ir, px(p), 2, (0, 0, 255))
            ilr = np.concatenate([il, ir], axis=1)
            for st, end, t in zip(pl, pr, tar):
                end, t = end.copy(), t.copy()
                end[0] += width
                t[0] += width
                draw_line(ilr, px(st), px(end), (255, 0, 0))
                draw_line(ilr, px(t), px(end), (0, 255, 0))
            write_png(os.path.join(out_dir, f"{i}_reproj.png"), ilr)


def bgr2gray_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of uint8 (..., 3), channel 0
    taking the blue weight: the 15-bit fixed point (0.114, 0.587, 0.299 x
    2^15, rounded) of cv2 5.0's vector loop, which also serves its tail
    (the 14-bit 1868 / 9617 / 4899 of older versions differs in ~0.3 % of
    pixels)."""
    c = img.to(torch.int32)
    return ((c[..., 0] * 3735 + c[..., 1] * 19235 + c[..., 2] * 9798
             + (1 << 14)) >> 15).to(torch.uint8)


def detect_keypoints(image_np: np.ndarray, width: int, height: int,
                     N: int = 100, mask: Optional[np.ndarray] = None,
                     seed: int = 0, device="cuda",
                     detector: Optional[Callable[[torch.Tensor],
                                                 List[np.ndarray]]] = None
                     ) -> np.ndarray:
    """The sparse loss's keypoint picker (dense_ba.py:347-375): SIFT
    keypoints of each frame, grayscaled as cv2's BGR2GRAY sees the RGB
    bytes and resized to (``width``, ``height``), floored, kept where
    ``mask`` (B, height, width) is set, topped up to ``N`` with points drawn
    from ``default_rng(seed)`` (one generator for the batch), shuffled, and
    cut to ``N``.  ``image_np``: (B, H0, W0, 3) floats in [0, 1]; returns
    (B, N, 2) float32.  The grayscale, the resize and the detector run on
    ``device``; ``detector`` maps the (B, height, width) uint8 batch to one
    (K, 2) float32 array of (x, y) per frame (the port's SIFT by default)."""
    rng = np.random.default_rng(seed)
    image = torch.as_tensor((np.asarray(image_np) * 255).astype(np.uint8),
                            device=device)
    gray = bgr2gray_u8(image).permute(1, 2, 0)               # (H0, W0, B)
    gray = resize_u8(gray, width / gray.shape[1], height / gray.shape[0])
    gray = gray.permute(2, 0, 1).reshape(-1, height, width)
    found = (detector or (lambda g: sift_keypoints(g, device)))(gray)
    out = []
    for i, kps in enumerate(found):
        pts = np.floor(np.asarray(kps, np.float32).reshape(-1, 2))
        if mask is not None and len(pts):
            idx = pts[:, (1, 0)].astype(int)
            pts = pts[mask[i, idx[:, 0], idx[:, 1]]]
        while len(pts) < N:
            cand = np.array([rng.integers(width), rng.integers(height)],
                            dtype=np.float32)
            if mask is None or mask[i, int(cand[1]), int(cand[0])]:
                pts = np.concatenate([pts, cand.reshape(1, 2)], axis=0)
        rng.shuffle(pts)
        out.append(pts[:N])
    return np.stack(out)
