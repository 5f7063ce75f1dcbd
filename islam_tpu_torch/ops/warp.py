"""Bilinear sampling and flow warping.

Counterpart of ``islam_tpu/ops/warp.py`` (``grid_sample``, ``flow_warp``),
the warp layer of the reference's PWC-Net.  Sampling is
``F.grid_sample`` with zero padding; the in-bounds bilinear weight sum that
the warp thresholds (the reference samples a ones image for it) is computed
analytically, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _coverage(fx: torch.Tensor, fy: torch.Tensor, H: int, W: int):
    """Sum of the bilinear weights whose taps fall inside the image."""
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = fx - x0, fy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def inb(ix, iy):
        return ((ix >= 0) & (ix <= W - 1) & (iy >= 0)
                & (iy <= H - 1)).to(fx.dtype)

    return (inb(x0, y0) * (wx0 * wy0) + inb(x1, y0) * (wx1 * wy0)
            + inb(x0, y1) * (wx0 * wy1) + inb(x1, y1) * (wx1 * wy1))


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True, return_coverage: bool = False):
    """Bilinear sample ``img`` (B, C, H, W) at ``grid`` (B, H', W', 2) in
    [-1, 1] (x first), zero padding.  ``return_coverage`` also returns the
    in-bounds weight sum (B, H', W')."""
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)
    if not return_coverage:
        return out
    H, W = img.shape[-2:]
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    return out, _coverage(fx, fy, H, W)


def flow_warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """Warp ``x`` (B, C, H, W) backward by flow ``flo`` (B, 2, H, W); pixels
    whose bilinear support leaves the image (coverage < 0.9999) are zeroed,
    as PWCDCNet.warp does."""
    B, C, H, W = x.shape
    xx = torch.arange(W, dtype=x.dtype, device=x.device).expand(H, W)
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[:, None].expand(H, W)
    vgrid = torch.stack([xx, yy])[None] + flo
    gx = 2.0 * vgrid[:, 0] / max(W - 1, 1) - 1.0
    gy = 2.0 * vgrid[:, 1] / max(H - 1, 1) - 1.0
    out, coverage = grid_sample(x, torch.stack([gx, gy], dim=-1),
                                align_corners=True, return_coverage=True)
    return out * (coverage >= 0.9999).to(x.dtype)[:, None]
