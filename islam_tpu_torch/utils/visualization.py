"""Flow, depth and image renders, and warp debugging, without cv2.

Counterpart of ``islam_tpu/utils/visualization.py`` (the reference's
Datasets/utils.py:259-371).  The arithmetic runs in torch on the device of
the tensor it is given, or, for a numpy array, on ``device`` (the card by
default); the renders come back as uint8 numpy images, as the JAX
package's do.  Where the JAX package calls cv2:

- ``cv2.cvtColor(COLOR_HSV2BGR)`` on uint8 (hue 0-179): ``hsv_to_bgr``,
  cv2's float formula;
- ``cv2.resize`` (INTER_LINEAR): ``resize_u8``, cv2's 11-bit fixed point;
- ``cv2.remap`` (INTER_LINEAR, constant 0 border): ``remap_u8``;
- ``cv2.circle`` and ``cv2.line`` at their defaults (thickness 1, LINE_8,
  no shift): ``draw_circle`` and ``draw_line``, in numpy on the host;
- ``cv2.imwrite``: ``data.image_io.write_png``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from islam_tpu_torch.data.image_io import write_png


def _tensor(x, device) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x),
                                                        device=device)


def calculate_angle_distance_from_du_dv(du, dv, flag_degree=False):
    """(angle of (du, dv) in radians, or degrees; its length; the angle's
    half turn)."""
    a = torch.atan2(dv, du)
    angle_shift = math.pi
    if flag_degree:
        a = a / math.pi * 180
        angle_shift = 180
    return a, torch.sqrt(du * du + dv * dv), angle_shift


def visrgb(img, mean=None, std=None, device="cuda") -> np.ndarray:
    """(H, W, 3) floats in [0, 1], de-normalised by ``mean``/``std`` where
    given, as uint8 (truncated)."""
    img = _tensor(img, device).clone()
    if mean is not None and std is not None:
        for k in range(3):
            img[..., k] = img[..., k] * std[k] + mean[k]
    return (img * 255).to(torch.uint8).cpu().numpy()


# cv2's HSV2RGB: per hue sector, the tab entries of (b, g, r)
_SECTOR = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) for uint8 (H, W, 3), hue 0-179:
    cv2's float formula, truncated to uint8 as its vectorised loop does
    (cv2 rounds in the scalar tail of a row, so a few pixels there may
    differ by one level)."""
    h = hsv[..., 0].float() * (6.0 / 180.0)
    s = hsv[..., 1].float() * (1.0 / 255.0)
    v = hsv[..., 2].float() * (1.0 / 255.0)
    sector = torch.floor(h)
    h = h - sector
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * h),
                       v * (1.0 - s * (1.0 - h))], dim=-1)
    idx = torch.tensor(_SECTOR, device=hsv.device)[
        sector.long().clamp(0, 5)]
    bgr = torch.gather(tab, -1, idx)
    return torch.floor(bgr * 255.0).clamp(0, 255).to(torch.uint8)


def visflow(flownp, maxF=500.0, n=8, mask=None, hueMax=179, angShift=0.0,
            device="cuda") -> np.ndarray:
    """KITTI-style HSV rendering of an (H, W, 2) flow as uint8 BGR
    (Datasets/utils.py:276-296): hue from the direction, saturation from the
    length up to ``maxF / n``; pixels where ``mask`` != 255 are black."""
    f = _tensor(flownp, device)
    ang, mag, _ = calculate_angle_distance_from_du_dv(f[..., 0], f[..., 1])
    ang = torch.where(ang < 0, ang + math.pi * 2, ang)
    hue = torch.remainder((ang + angShift) / (2 * math.pi), 1)
    sat = mag / maxF * n
    val = (n - sat) / n
    hsv = torch.stack([torch.clamp(hue, 0, 1) * hueMax,
                       torch.clamp(sat, 0, 1) * 255,
                       torch.clamp(val, 0, 1) * 255], dim=-1)
    bgr = hsv_to_bgr(hsv.to(torch.uint8))
    if mask is not None:
        bgr[_tensor(mask, bgr.device) != 255] = 0
    return bgr.cpu().numpy()


def visdepth(disp, scale=3, device="cuda") -> np.ndarray:
    """A disparity or depth map stretched to 0-255 as uint8."""
    disp = _tensor(disp, device).float()
    lo, hi = disp.min(), disp.max()
    res = (disp - lo) / torch.clamp(hi - lo, min=1e-12) * 255
    return res.to(torch.uint8).cpu().numpy()


def _linear_taps(n_src: int, n_dst: int, scale: float, clamp_edges: bool,
                 device):
    """cv2's INTER_LINEAR taps: source position (i + 0.5) scale - 0.5 in
    float32, its floor, and 11-bit weights rounded half to even."""
    f = ((torch.arange(n_dst, dtype=torch.float64, device=device) + 0.5)
         * scale - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    if clamp_edges:
        f = torch.where((s < 0) | (s >= n_src - 1), torch.zeros_like(f), f)
        s = s.clamp(0, n_src - 1)
    return (s, torch.round((1.0 - f) * 2048.0).long(),
            torch.round(f * 2048.0).long())


def resize_u8(img: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """cv2.resize(img, None, fx=fx, fy=fy) (INTER_LINEAR) of a uint8 (H, W)
    or (H, W, C) tensor, cv2's fixed point (as ``data/native.py``'s
    ``resize_linear_u8_reference``): the size rounded, the grid of the
    factors, 11-bit taps, the horizontal pass in integers, then cv2's
    vertical step.  The same size is a copy, as in cv2."""
    h, w = img.shape[:2]
    th, tw = round(h * fy), round(w * fx)
    if (th, tw) == (h, w):
        return img.clone()
    src = img.reshape(h, w, -1).long()
    sx, a0, a1 = _linear_taps(w, tw, 1.0 / fx, True, img.device)
    hor = (src[:, sx] * a0[None, :, None]
           + src[:, (sx + 1).clamp(max=w - 1)] * a1[None, :, None])
    sy, b0, b1 = _linear_taps(h, th, 1.0 / fy, False, img.device)
    s0 = hor[sy.clamp(0, h - 1)] >> 4
    s1 = hor[(sy + 1).clamp(0, h - 1)] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out.reshape((th, tw) + tuple(img.shape[2:]))


def remap_u8(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, map_xy, None, INTER_LINEAR) of a uint8 (H, W, C)
    tensor with a float32 (h, w, 2) map, constant 0 border: float32 lerps
    along x, then y, taps outside the image read 0, rounded half to even
    (as ``data/native.py``'s ``remap_linear_u8_reference``)."""
    H, W = img.shape[:2]
    src = img.float()
    mx, my = map_xy[..., 0].float(), map_xy[..., 1].float()
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = (mx - x0)[..., None], (my - y0)[..., None]
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = src[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return torch.where(inside[..., None], v, torch.zeros_like(v))

    a = tap(y0, x0) + fx * (tap(y0, x0 + 1) - tap(y0, x0))
    b = tap(y0 + 1, x0) + fx * (tap(y0 + 1, x0 + 1) - tap(y0 + 1, x0))
    return torch.round(a + fy * (b - a)).clamp(0, 255).to(torch.uint8)


def save_images(directory, data, prefix='', suffix='', mean=None, std=None,
                fx=1, fy=1, device="cuda"):
    """(B, H, W, C) (or NCHW) floats -> ``{prefix}{i}{suffix}.png``:
    C = 3 as RGB renders, 2 as flow renders, 1 as depth renders, each
    resized by (fx, fy) (Datasets/utils.py:307-332)."""
    data = _tensor(data, device)
    if data.dim() == 4 and data.shape[1] in (1, 2, 3) and (
            data.shape[-1] not in (1, 2, 3)):
        data = data.permute(0, 2, 3, 1)  # NCHW too
    for i in range(data.shape[0]):
        if data.shape[-1] == 3:
            img = visrgb(data[i], mean=mean, std=std)
        elif data.shape[-1] == 2:
            img = visflow(data[i])
        else:
            img = visdepth(data[i][..., 0])
        img = resize_u8(torch.from_numpy(img), fx, fy).numpy()
        write_png(f'{directory}/{prefix}{i}{suffix}.png', img)


def warp_images(directory, data, flow, mean=None, std=None, device="cuda"):
    """Backward-warp debug renders (Datasets/utils.py:335-371): each image,
    rendered and resized x1/4, sampled at pixel + flow; written as
    ``{i}_warp.png`` and returned as a uint8 (B, h, w, 3) array."""
    data = _tensor(data, device)
    if data.dim() == 4 and data.shape[-1] not in (1, 2, 3):
        data = data.permute(0, 2, 3, 1)
    flow = _tensor(flow, data.device)
    if flow.dim() == 4 and flow.shape[-1] != 2:
        flow = flow.permute(0, 2, 3, 1)
    res = []
    for i in range(flow.shape[0]):
        rgb = torch.from_numpy(visrgb(data[i], mean=mean, std=std))
        rgb = resize_u8(rgb.to(data.device), 0.25, 0.25)
        f = flow[i]
        h, w = f.shape[:2]
        gy, gx = torch.meshgrid(
            torch.linspace(0, h - 1, h, dtype=torch.float64, device=f.device),
            torch.linspace(0, w - 1, w, dtype=torch.float64, device=f.device),
            indexing="ij")
        uv = torch.stack([gx, gy], dim=-1)
        warp = remap_u8(rgb, (f + uv).to(torch.float32)).cpu().numpy()
        res.append(warp)
        write_png(f'{directory}/{i}_warp.png', warp)
    return np.stack(res)


def _circle_offsets(radius: int):
    """The (dx, dy) offsets cv2's Bresenham circle of ``radius`` visits."""
    out = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        out += [(-dx, -dy), (-dx, dy), (dx, -dy), (dx, dy),
                (-dy, -dx), (-dy, dx), (dy, -dx), (dy, dx)]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array(out, np.int64)


def draw_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color) in place on an (H, W, C)
    uint8 array: the 1-pixel outline, clipped to the image."""
    h, w = img.shape[:2]
    p = _circle_offsets(int(radius)) + np.asarray(center, np.int64)
    p = p[(p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)]
    img[p[:, 1], p[:, 0]] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine: the segment's ends moved onto the image, in cv2's
    order and integer truncation; None where it misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def draw_line(img: np.ndarray, p, q, color) -> None:
    """cv2.line(img, p, q, color) in place on an (H, W, C) uint8 array:
    cv2's LineIterator (8-connected, drawn left to right) over the segment
    clipped to the image."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in (p[0], p[1], q[0], q[1]))
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ends = _clip_line(w, h, x1, y1, x2, y2)
        if ends is None:
            return
        x1, y1, x2, y2 = ends
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # the minor axis steps where Bresenham's error went negative
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if dy > dx:
        xs, ys = x1 + m, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * m
    img[ys, xs] = color
