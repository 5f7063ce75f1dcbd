"""Bilinear sampling, flow warping and flow chaining.

Counterpart of ``islam_tpu/ops/warp.py`` (``grid_sample``, ``flow_warp``,
``join_flow``): the warp layer of the reference's PWC-Net and
TartanVO.join_flow.  Sampling is
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


def join_flow(flow_list, height: int, width: int) -> torch.Tensor:
    """Chain (2, H, W) pixel flows into one composite flow (TartanVO.py:
    219-239, islam_tpu/ops/warp.py:97-118): an identity coordinate map is
    resampled through each flow, last first.  As the reference does, the
    grid is normalised by the size, without the half-pixel offset, so each
    hop shifts the interior by -0.5 px; where both coordinates come out
    exactly 0 the result is -1 before the identity is subtracted."""
    dev = flow_list[0].device
    u = torch.arange(width, dtype=torch.float32, device=dev).expand(
        height, width)
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(
        height, width)
    uv = torch.stack([u, v])                        # (2, H, W)
    x = uv[None]
    for f in reversed(list(flow_list)):
        g = (f + uv).permute(1, 2, 0)[None]         # (1, H, W, 2)
        grid = torch.stack([g[..., 0] / width * 2.0 - 1.0,
                            g[..., 1] / height * 2.0 - 1.0], dim=-1)
        x = grid_sample(x, grid, align_corners=False)
    x = x[0]
    zero = (x[0] == 0) & (x[1] == 0)
    return torch.where(zero[None], torch.full_like(x, -1.0), x) - uv
