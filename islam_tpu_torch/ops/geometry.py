"""Projective geometry for the VO front-end: ray maps, the edge mask and the
metric-scale least squares.

Counterpart of ``islam_tpu/ops/geometry.py``.  ``scale_from_disp_flow_batch``
is written batched (the JAX package vmaps the single-frame function); the
masks are where-masks, so no shape depends on the data.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from islam_tpu_torch import lie
from islam_tpu_torch.transformation import cvt_se3


def make_intrinsics_layer(w: int, h: int, fx, fy, ox, oy,
                          device=None) -> torch.Tensor:
    """Per-pixel normalized-ray map (2, h, w)."""
    ww, hh = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                            torch.arange(h, dtype=torch.float32, device=device),
                            indexing="xy")
    return torch.stack([(ww - ox + 0.5) / fx, (hh - oy + 0.5) / fy])


def intrinsics_matrix(fx, fy, cx, cy) -> torch.Tensor:
    """Batched 3x3 camera matrices from (...,) tensors."""
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, cx], dim=-1),
        torch.stack([z, fy, cy], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def pixel2point(pixels, depth, intrinsics):
    """Pixels (..., N, 2) + depth (..., N) -> camera-frame points (..., N, 3)
    (dense_ba.py:9-62, the reference's copy of PyPose's function)."""
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    x = (pixels[..., 0] - cx) * depth / fx
    y = (pixels[..., 1] - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def point2pixel(points, intrinsics, extrinsics=None):
    """Points (..., N, 3) -> pixels (..., N, 2), first moved by the SE3 rows
    ``extrinsics`` when given (PyPose's point2pixel)."""
    if extrinsics is not None:
        points = lie.se3_act(extrinsics, points)
    uv1 = points / torch.clamp(points[..., 2:3], min=1e-6)
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    return torch.stack([uv1[..., 0] * fx + cx, uv1[..., 1] * fy + cy], dim=-1)


def reprojerr(points, pixels, intrinsics, extrinsics=None):
    """Per-point reprojection error (..., N, 2), PyPose's reprojerr with
    reduction='none'."""
    return point2pixel(points, intrinsics, extrinsics) - pixels


def edge_mask(img: torch.Tensor, low: float = 50.0,
              dilate: int = 5) -> torch.Tensor:
    """Sobel-magnitude edges above ``low``, dilated by a ``dilate`` square.

    ``img``: (B, 3, H, W) in [0, 1], BGR as cv2 loads it.  Returns a bool
    (B, H, W) mask, the JAX package's on-device stand-in for the reference's
    cv2.Canny(50, 100) + dilate(5x5).
    """
    gray = (0.114 * img[:, 0] + 0.587 * img[:, 1]
            + 0.299 * img[:, 2]) * 255.0
    kx = lie.constant([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], gray.dtype,
                      gray.device)
    k = torch.stack([kx, kx.T])[:, None]  # (2, 1, 3, 3)
    g = F.conv2d(gray[:, None], k, padding=1)
    mag = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
    edges = (mag > low).to(gray.dtype)
    dil = F.max_pool2d(edges[:, None], dilate, stride=1, padding=dilate // 2)
    return dil[:, 0] > 0


def _is_inside_1d(u, width):
    return (u >= 0) & (u <= width)


def scale_from_disp_flow_batch(disp, flow, motion, intrinsic_calib, baseline,
                               mask=None, disp_th: float = 1.0):
    """Per-frame translation scale from stereo disparity and flow.

    disp (B, H, W) or (B, 1, H, W), flow (B, 2, H, W), ``motion`` SE3 (B, 7)
    camera motion in ENU coords, ``intrinsic_calib`` (B, 4) [fx, fy, cx, cy]
    at the working resolution, ``baseline`` (B,), ``mask`` bool (B, H, W).
    The 2N x 1 system M s = w is solved with masked reductions:
    s = sum(mask M w) / sum(mask M^2).  Returns (s (B,), z, m, depth_mask).
    """
    disp = disp if disp.dim() == 3 else disp[:, 0]
    T = cvt_se3(motion).data
    B, _, height, width = flow.shape
    dtype, device = flow.dtype, flow.device
    fx, fy, cx, cy = intrinsic_calib.unbind(-1)

    v, u = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    uv = torch.stack([u, v])

    flow_norm = torch.linalg.norm(flow, dim=1)
    warped = flow + uv
    m = (_is_inside_1d(warped[:, 0], width) & _is_inside_1d(warped[:, 1], height)
         & (flow_norm > 0))
    if mask is not None:
        m = m & mask

    disp_mask = _is_inside_1d(u - disp, width) & (disp >= disp_th)
    m = m & disp_mask
    z = torch.where(disp_mask,
                    fx[:, None, None] * baseline[:, None, None]
                    / torch.clamp(disp, min=1e-6),
                    torch.zeros_like(disp))
    depth_mask = disp_mask

    K = intrinsics_matrix(fx, fy, cx, cy)
    K_inv = torch.linalg.inv_ex(K).inverse

    # Back-project each pixel: P = z * K^-1 [u, v, 1]
    uv1 = torch.stack([u, v, torch.ones_like(u)], dim=-1)  # (H, W, 3)
    P = z[..., None] * torch.einsum("bij,hwj->bhwi", K_inv, uv1)

    Tinv = lie.se3_inv(T)
    t = Tinv[:, :3]
    t_norm = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                             min=1e-12)
    a = torch.einsum("bij,bj->bi", K, t_norm)  # (B, 3)
    RP = lie.quat_rotate(Tinv[:, None, None, 3:], P)
    b = torch.einsum("bij,bhwj->bhwi", K, RP)
    f = (flow + uv).permute(0, 2, 3, 1)  # (B, H, W, 2)

    a0, a1, a2 = (a[:, i, None, None] for i in range(3))
    M1 = a2 * f[..., 0] - a0
    w1 = b[..., 0] - b[..., 2] * f[..., 0]
    M2 = a2 * f[..., 1] - a1
    w2 = b[..., 1] - b[..., 2] * f[..., 1]

    mf = m.to(dtype)
    num = torch.sum(mf * (M1 * w1 + M2 * w2), dim=(1, 2))
    den = torch.sum(mf * (M1 * M1 + M2 * M2), dim=(1, 2))
    s = num / torch.clamp(den, min=1e-12)
    return s, z, m, depth_mask


def scale_from_disp_flow(disp, flow, motion, fx, fy, cx, cy, baseline,
                         mask=None, disp_th: float = 1.0):
    """Single-frame form: disp (H, W), flow (2, H, W), motion (7,) or (6,),
    scalar intrinsics and baseline.  Returns (s, z, m, depth_mask)."""
    motion = cvt_se3(motion).data
    intr = torch.stack([torch.as_tensor(v, dtype=flow.dtype, device=flow.device)
                        for v in (fx, fy, cx, cy)])
    bl = torch.as_tensor(baseline, dtype=flow.dtype, device=flow.device)
    out = scale_from_disp_flow_batch(
        disp[None], flow[None], motion[None], intr[None], bl.reshape(1),
        mask=None if mask is None else mask[None], disp_th=disp_th)
    return tuple(o[0] for o in out)
