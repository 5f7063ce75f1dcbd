"""Lowe's SIFT keypoint detector, batched in torch, as OpenCV builds it.

The port's stand-in for ``cv2.SIFT_create().detect`` at its defaults (three
layers an octave, contrast threshold 0.04, edge threshold 10, sigma 1.6, no
cap on the count, the first octave at twice the image's size), which the JAX
package's ``detect_keypoints`` calls on the host.  Every stage runs on one
device over the whole batch: the scale space by separable convolutions, the
extrema by 3-D max pooling, and each keypoint's refinement and orientation
histogram by gathers and ``scatter_add``.  Only the final point lists go to
the host.  The steps and constants are OpenCV's (``sift.dispatch.cpp``,
``sift.simd.hpp``): reflect-101 borders, incremental layer sigmas, the
nearest-pixel halving between octaves, the 5-pixel border, up to 5
quadratic refinement steps solved by Cramer's rule, the contrast and edge
tests, the 36-bin orientation histogram with its [1 4 6 4 1] smoothing and
``fastAtan2``, one keypoint per orientation peak of at least 0.8 of the
highest, and the sort and de-duplication of ``removeDuplicatedSorted``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

N_LAYERS = 3
CONTRAST = 0.04
EDGE = 10.0
SIGMA = 1.6
BORDER = 5                 # SIFT_IMG_BORDER
MAX_STEPS = 5              # SIFT_MAX_INTERP_STEPS
N_BINS = 36                # SIFT_ORI_HIST_BINS
ORI_SIG = 1.5              # SIFT_ORI_SIG_FCTR
ORI_RADIUS = 3 * ORI_SIG   # SIFT_ORI_RADIUS
PEAK_RATIO = 0.8           # SIFT_ORI_PEAK_RATIO
# the orientation window's largest radius: layer + offset below 3.5
MAX_RADIUS = round(ORI_RADIUS * SIGMA * 2 ** (3.5 / N_LAYERS))


def _gaussian_taps(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma) for float
    images: exp(-d^2 / (2 sigma^2)) normalised in float64, then float32."""
    n = int(round(sigma * 8 + 1)) | 1
    d = np.arange(n) - (n - 1) / 2
    k = np.exp(-d * d / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """cv2's BORDER_REFLECT_101 indices of -pad .. n + pad - 1, for any n."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(x, (0, 0), sigma) of float32 images (B, H, W): the
    row pass, then the column pass, reflect-101 borders.  The convolutions
    run in full float32 (no TF32) on the card."""
    taps = torch.as_tensor(_gaussian_taps(sigma), device=x.device)
    taps = taps.view(1, 1, -1)
    pad = taps.numel() // 2
    B, H, W = x.shape
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        rows = x[:, :, _reflect101(W, pad, x.device)].reshape(B * H, 1, -1)
        x = F.conv1d(rows, taps).reshape(B, H, W)
        cols = x[:, _reflect101(H, pad, x.device)].transpose(1, 2)
        x = F.conv1d(cols.reshape(B * W, 1, -1), taps)
    return x.reshape(B, W, H).transpose(1, 2).contiguous()


def _layer_sigmas() -> List[float]:
    """The blur that takes layer i - 1 of an octave to layer i."""
    k = 2.0 ** (1.0 / N_LAYERS)
    return [SIGMA] + [math.sqrt((k ** i * SIGMA) ** 2
                                - (k ** (i - 1) * SIGMA) ** 2)
                      for i in range(1, N_LAYERS + 3)]


def gaussian_pyramid(gray: torch.Tensor) -> List[torch.Tensor]:
    """The octaves (B, L + 3, H_o, W_o) of a uint8 batch (B, h, w): the base
    is the image doubled (bilinear) and blurred to sigma from an assumed
    0.5 (doubled: 1.0); each octave after the first starts from layer L of
    the one before, taken every second pixel."""
    x = gray.to(torch.float32)[:, None]
    base = F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)[:, 0]
    base = gaussian_blur(base, math.sqrt(max(SIGMA ** 2 - 4 * 0.25, 0.01)))
    n_oct = round(math.log2(min(base.shape[1:])) - 2) + 1
    sig = _layer_sigmas()
    octaves = []
    for o in range(n_oct):
        if o:
            prev = octaves[-1][:, N_LAYERS]
            h, w = prev.shape[1] // 2, prev.shape[2] // 2
            base = prev[:, :2 * h:2, :2 * w:2]
        layers = [base]
        for i in range(1, N_LAYERS + 3):
            layers.append(gaussian_blur(layers[-1], sig[i]))
        octaves.append(torch.stack(layers, 1))
    return octaves


def _fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv2.fastAtan2 in degrees, [0, 360): its degree-7 polynomial."""
    p1, p3, p5, p7 = (np.float32(c * 180 / math.pi) for c in (
        0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
        -0.04432655554792128))
    ax, ay = x.abs(), y.abs()
    eps = np.float32(np.finfo(np.float64).eps)
    c = torch.where(ax >= ay, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _refine(dog: torch.Tensor, b, layer, r, c):
    """adjustLocalExtrema on every candidate at once: up to MAX_STEPS
    Newton steps on the DoG's quadratic fit, then the contrast and edge
    tests.  Returns (kept, layer, r, c, offsets (K, 3) as x, y, layer)."""
    _, L, H, W = dog.shape
    img_scale = 1.0 / 255
    ds, d2s, dxs = img_scale * 0.5, img_scale, img_scale * 0.25

    def at(dl, dr, dc):
        return dog[b, layer + dl, r + dr, c + dc]

    def derivs():
        v2 = at(0, 0, 0) * 2
        g = torch.stack([(at(0, 0, 1) - at(0, 0, -1)) * ds,
                         (at(0, 1, 0) - at(0, -1, 0)) * ds,
                         (at(1, 0, 0) - at(-1, 0, 0)) * ds], -1)
        dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * d2s
        dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * d2s
        dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * d2s
        dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1)
               + at(0, -1, -1)) * dxs
        dxs_ = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1)
                + at(-1, 0, -1)) * dxs
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0)
               + at(-1, -1, 0)) * dxs
        return g, (dxx, dyy, dss, dxy, dxs_, dys)

    K = b.numel()
    dev = dog.device
    X = torch.zeros(K, 3, device=dev)
    active = torch.ones(K, dtype=torch.bool, device=dev)
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    for _ in range(MAX_STEPS):
        g, (a00, a11, a22, a01, a02, a12) = derivs()
        # Matx<float, 3, 3>::solve: Cramer's rule, zeros when singular
        b0, b1, b2 = g.unbind(-1)
        det = (a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a02 * a12)
               + a02 * (a01 * a12 - a02 * a11))
        inv = torch.where(det == 0, torch.zeros_like(det), 1 / det)
        x0 = inv * (b0 * (a11 * a22 - a12 * a12) - a01 * (b1 * a22 - a12 * b2)
                    + a02 * (b1 * a12 - a11 * b2))
        x1 = inv * (a00 * (b1 * a22 - a12 * b2) - b0 * (a01 * a22 - a12 * a02)
                    + a02 * (a01 * b2 - b1 * a02))
        x2 = inv * (a00 * (a11 * b2 - b1 * a12) - a01 * (a01 * b2 - b1 * a02)
                    + b0 * (a01 * a12 - a11 * a02))
        step = -torch.stack([x0, x1, x2], -1)
        small = (step.abs() < 0.5).all(-1)
        X = torch.where((active & small)[:, None], step, X)
        done = done | (active & small)
        move = active & ~small
        huge = (step.abs() > float(2 ** 31 // 3)).any(-1)
        rs = torch.round(step).clamp(-2 ** 20, 2 ** 20).long()
        c = torch.where(move, c + rs[:, 0], c)
        r = torch.where(move, r + rs[:, 1], r)
        layer = torch.where(move, layer + rs[:, 2], layer)
        out = ((layer < 1) | (layer > L - 2) | (c < BORDER) | (c >= W - BORDER)
               | (r < BORDER) | (r >= H - BORDER))
        active = move & ~huge & ~out
        # keep the gathers in range for the candidates that dropped out
        layer = torch.where(active | done, layer, torch.ones_like(layer))
        r = torch.where(active | done, r, torch.full_like(r, BORDER))
        c = torch.where(active | done, c, torch.full_like(c, BORDER))
    g, (dxx, dyy, _, dxy, _, _) = derivs()
    contr = at(0, 0, 0) * img_scale + (g * X).sum(-1) * 0.5
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    kept = (done & (contr.abs() * N_LAYERS >= CONTRAST) & (det > 0)
            & (tr * tr * EDGE < (EDGE + 1) ** 2 * det))
    return kept, layer, r, c, X


def _orientations(gauss: torch.Tensor, b, layer, r, c, scl):
    """calcOrientationHist for every keypoint: the (K, 36) smoothed
    histograms of Gaussian-weighted gradient magnitudes in a window of
    radius round(4.5 scl) around (r, c) of its layer."""
    _, _, H, W = gauss.shape
    dev = gauss.device
    radius = torch.round(ORI_RADIUS * scl).long()
    sig = ORI_SIG * scl
    expf = -1.0 / (2.0 * sig * sig)
    off = torch.arange(-MAX_RADIUS, MAX_RADIUS + 1, device=dev)
    di, dj = torch.meshgrid(off, off, indexing="ij")
    di, dj = di.reshape(-1), dj.reshape(-1)
    y = r[:, None] + di[None]
    x = c[:, None] + dj[None]
    ok = ((di.abs()[None] <= radius[:, None])
          & (dj.abs()[None] <= radius[:, None])
          & (y > 0) & (y < H - 1) & (x > 0) & (x < W - 1))
    y, x = y.clamp(1, H - 2), x.clamp(1, W - 2)

    def at(yy, xx):
        return gauss[b[:, None], layer[:, None], yy, xx]

    dx = at(y, x + 1) - at(y, x - 1)
    dy = at(y - 1, x) - at(y + 1, x)
    w = torch.exp((di * di + dj * dj).float()[None] * expf[:, None])
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = _fast_atan2(dy, dx)
    bins = torch.round(ori * np.float32(N_BINS / 360.0)).long()
    bins = torch.remainder(bins, N_BINS)
    K = b.numel()
    hist = torch.zeros(K * N_BINS, device=dev)
    idx = (torch.arange(K, device=dev)[:, None] * N_BINS + bins)[ok]
    hist.index_add_(0, idx, (w * mag)[ok])
    t = hist.view(K, N_BINS)
    return ((torch.roll(t, 2, 1) + torch.roll(t, -2, 1)) * (1.0 / 16.0)
            + (torch.roll(t, 1, 1) + torch.roll(t, -1, 1)) * (4.0 / 16.0)
            + t * (6.0 / 16.0))


def _octave_keypoints(o: int, gauss: torch.Tensor):
    """(b, x, y, size, angle) of the keypoints of octave ``o`` (o = 0 is the
    doubled image), in the doubled image's pixels, as OpenCV has them
    before its first-octave rescale."""
    dog = gauss[:, 1:] - gauss[:, :-1]                       # (B, L+2, H, W)
    H, W = dog.shape[-2:]
    v = dog[:, 1:-1]
    hi = F.max_pool3d(dog[:, None], 3, 1, (0, 1, 1))[:, 0]
    lo = -F.max_pool3d(-dog[:, None], 3, 1, (0, 1, 1))[:, 0]
    cand = (((v > 0) & (v >= hi)) | ((v < 0) & (v <= lo))) & (v.abs() > 1)
    cand[..., :BORDER, :] = False
    cand[..., H - BORDER:, :] = False
    cand[..., :BORDER] = False
    cand[..., W - BORDER:] = False
    b, layer, r, c = cand.nonzero(as_tuple=True)
    layer = layer + 1
    kept, layer, r, c, X = _refine(dog, b, layer, r, c)
    b, layer, r, c, X = b[kept], layer[kept], r[kept], c[kept], X[kept]
    xc, xr, xi = X.unbind(-1)
    scale = float(1 << o)
    size = (torch.pow(2.0, (layer.float() + xi) / N_LAYERS)
            * np.float32(SIGMA)) * scale * 2
    scl = size * 0.5 / scale
    hist = _orientations(gauss, b, layer, r, c, scl)
    left, right = torch.roll(hist, 1, 1), torch.roll(hist, -1, 1)
    peak = ((hist > left) & (hist > right)
            & (hist >= hist.max(1, keepdim=True).values
               * np.float32(PEAK_RATIO)))
    k, j = peak.nonzero(as_tuple=True)
    hl, hj, hr = left[k, j], hist[k, j], right[k, j]
    binf = j.float() + 0.5 * (hl - hr) / (hl - 2 * hj + hr)
    binf = torch.where(binf < 0, N_BINS + binf,
                       torch.where(binf >= N_BINS, binf - N_BINS, binf))
    angle = 360.0 - binf * np.float32(360.0 / N_BINS)
    angle = torch.where((angle - 360.0).abs() < np.finfo(np.float32).eps,
                        torch.zeros_like(angle), angle)
    x = (c[k].float() + xc[k]) * scale
    y = (r[k].float() + xr[k]) * scale
    return b[k], x, y, size[k], angle


def sift_keypoints(gray_u8, device="cuda") -> List[np.ndarray]:
    """cv2.SIFT_create().detect on each image of a uint8 batch (B, h, w)
    (a tensor or an array), run on ``device``: per image a (K, 2) float32
    array of (x, y) positions, in OpenCV's order (sorted by x, y, size
    descending, angle, exact repeats dropped).  A position comes out once
    for each orientation peak it has."""
    gray = torch.as_tensor(gray_u8, device=device)
    B = gray.shape[0]
    parts = [_octave_keypoints(o, g)
             for o, g in enumerate(gaussian_pyramid(gray))]
    b, x, y, size, angle = (torch.cat(p) for p in zip(*parts))
    order = torch.arange(b.numel(), device=gray.device)
    for key in (angle, -size, y, x, b):
        order = order[torch.sort(key[order], stable=True).indices]
    b, x, y, size, angle = (t[order] for t in (b, x, y, size, angle))
    keys = torch.stack([b.float(), x, y, size, angle], 1)
    first = torch.ones_like(b, dtype=torch.bool)
    first[1:] = (keys[1:] != keys[:-1]).any(1)
    pts = (torch.stack([x, y], 1)[first] * 0.5).cpu().numpy()
    counts = torch.bincount(b[first], minlength=B).cpu().tolist()
    return list(np.split(pts.astype(np.float32),
                         np.cumsum(counts)[:-1]))
