"""Host-side sample transforms ending in NHWC numpy arrays.

Counterpart of ``islam_tpu/data/transforms.py`` (reference
Datasets/utils.py): dict-of-lists samples keyed by KEY2DIM, with the same
crop / resize / normalize / downscale semantics.  No image library is
needed: uint8 images are resized by ``native.resize_linear_u8`` (cv2's
fixed-point INTER_LINEAR, bit for bit), float arrays by ``F.interpolate``
on the CPU, and the x1/4 nearest downscale is the index rule of cv2's
INTER_NEAREST.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch
import torch.nn.functional as F

from islam_tpu_torch.data import native

KEY2DIM = {
    'img0': 3, 'img1': 3, 'img0_norm': 3, 'img1_norm': 3,
    'intrinsic': 3, 'flow': 3, 'fmask': 2,
    'disp0': 2, 'disp1': 2, 'depth0': 2, 'depth1': 2,
    'flow_unc': 2, 'depth0_unc': 2,
    'img0_r': 3, 'img1_r': 3, 'img0_r_norm': 3, 'img1_r_norm': 3,
}


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def get_sample_dimension(sample):
    for kk in sample.keys():
        if kk in KEY2DIM:
            return sample[kk][0].shape[0], sample[kk][0].shape[1]
    raise ValueError(f"No image type in {sample.keys()}")


def _resize_linear(d: np.ndarray, th: int, tw: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of an (H, W) or (H, W, C) array: uint8
    stays uint8, rounded as cv2 rounds (``native.resize_linear_u8``, bit
    for bit); other types are resized in float32."""
    if d.dtype == np.uint8:
        return native.resize_linear_u8(d, th, tw)
    t = torch.from_numpy(np.ascontiguousarray(d, np.float32))
    t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(th, tw), mode="bilinear",
                        align_corners=False)[0]
    return (out[0] if d.ndim == 2 else out.permute(1, 2, 0)).numpy()


class ResizeData:
    """Datasets/utils.py:104-156."""

    def __init__(self, size, scale_disp=False):
        self.size = (int(size), int(size)) if isinstance(
            size, numbers.Number) else size
        self.scale_disp = scale_disp

    def __call__(self, sample):
        th, tw = self.size
        h, w = get_sample_dimension(sample)
        if w == tw and h == th:
            return sample
        scale_w = float(tw) / w
        scale_h = float(th) / h
        for kk in sample.keys():
            if sample[kk] is None or kk not in KEY2DIM:
                continue
            sample[kk] = [_resize_linear(d, th, tw) for d in sample[kk]]
        if 'flow' in sample:
            for k in range(len(sample['flow'])):
                sample['flow'][k][..., 0] *= scale_w
                sample['flow'][k][..., 1] *= scale_h
        if self.scale_disp:
            for key in ('disp0', 'disp1'):
                if key in sample:
                    sample[key] = [d * scale_w for d in sample[key]]
        else:
            sample['scale_w'] = np.array([scale_w], dtype=np.float32)
        if 'intrinsic_calib' in sample:
            sample['intrinsic_calib'][0] *= scale_w
            sample['intrinsic_calib'][2] *= scale_w
            sample['intrinsic_calib'][1] *= scale_h
            sample['intrinsic_calib'][3] *= scale_h
        return sample


class CropCenter:
    """Datasets/utils.py:49-101: resize-if-small then center crop; adjusts
    the intrinsic_calib principal point."""

    def __init__(self, size, fix_ratio=True, scale_w=1.0, scale_disp=False):
        self.size = (int(size), int(size)) if isinstance(
            size, numbers.Number) else size
        self.fix_ratio = fix_ratio
        self.scale_w = scale_w
        self.scale_disp = scale_disp

    def __call__(self, sample):
        th, tw = self.size
        hh, ww = get_sample_dimension(sample)
        if ww == tw and hh == th:
            return sample
        scale_h = max(1, float(th) / hh)
        scale_w = max(1, float(tw) / ww)
        if scale_h > 1 or scale_w > 1:
            if self.fix_ratio:
                scale_h = scale_w = max(scale_h, scale_w)
            w = int(round(ww * scale_w))
            h = int(round(hh * scale_h))
        else:
            w, h = ww, hh
        if self.scale_w != 1.0:
            scale_w = self.scale_w
            w = int(round(ww * scale_w))
        if scale_h != 1.0 or scale_w != 1.0:
            sample = ResizeData((h, w), self.scale_disp)(sample)
        x1 = int((w - tw) / 2)
        y1 = int((h - th) / 2)
        for kk in sample.keys():
            if sample[kk] is None or kk not in KEY2DIM:
                continue
            sample[kk] = [d[y1:y1 + th, x1:x1 + tw, ...] for d in sample[kk]]
        if 'intrinsic_calib' in sample:
            sample['intrinsic_calib'][2] -= x1
            sample['intrinsic_calib'][3] -= y1
        return sample


class Normalize:
    """Datasets/utils.py:190-228: /255 then per-channel (x - mean) / std;
    ``keep_old`` keeps the /255 image and stores the normalized copy under
    ``<key>_norm``.

    uint8 3-channel images (the folder datasets') go through the native
    fused pass (``native.preproc_batch``) in float32, as the JAX package's
    do; float images (the synthetic dataset's) through numpy."""

    def __init__(self, mean=None, std=None, rgbbgr=False, keep_old=False):
        self.mean = mean
        self.std = std
        self.rgbbgr = rgbbgr
        self.keep_old = keep_old

    def _native(self, sample, kk) -> bool:
        ds = sample[kk]
        if self.rgbbgr or not all(
                d.dtype == np.uint8 and d.ndim == 3 and d.shape[-1] == 3
                and d.shape == ds[0].shape for d in ds):
            return False
        want_norm = self.mean is not None and self.std is not None
        raw, norm = native.preproc_batch(
            np.stack(ds), ds[0].shape[:2],
            self.mean if want_norm else (0.0, 0.0, 0.0),
            self.std if want_norm else (1.0, 1.0, 1.0), want_norm=want_norm)
        out = list(norm) if want_norm else list(raw)
        if self.keep_old:
            sample[kk] = list(raw)
            sample[kk + '_norm'] = out
        else:
            sample[kk] = out
        return True

    def __call__(self, sample):
        for kk in list(sample.keys()):
            if not (kk.startswith('img0') or kk.startswith('img1')):
                continue
            if self._native(sample, kk):
                continue
            datalist = []
            for s in range(len(sample[kk])):
                sample[kk][s] = sample[kk][s] / 255.0
                img = sample[kk][s]
                if self.rgbbgr:
                    img = img[..., [2, 1, 0]]
                if self.mean is not None and self.std is not None:
                    img = (img - np.asarray(self.mean)) / np.asarray(self.std)
                datalist.append(img.astype(np.float32))
            if self.keep_old:
                sample[kk + '_norm'] = datalist
            else:
                sample[kk] = datalist
        return sample


def _downscale_nearest(d: np.ndarray, f: float) -> np.ndarray:
    """cv2.resize(d, (0, 0), fx=f, fy=f, INTER_NEAREST): output size
    round(n * f), source index floor(i / f)."""
    h, w = d.shape[:2]
    ys = np.minimum(np.floor(np.arange(round(h * f)) / f).astype(int), h - 1)
    xs = np.minimum(np.floor(np.arange(round(w * f)) / f).astype(int), w - 1)
    return d[ys][:, xs]


class DownscaleFlow:
    """Datasets/utils.py:233-256: 1/4 nearest on flow/intrinsic/disp/depth
    (values unchanged)."""

    def __init__(self, scale=4):
        self.downscale = 1.0 / scale

    def __call__(self, sample):
        if self.downscale == 1:
            return sample
        for key in ('flow', 'intrinsic', 'fmask', 'disp0', 'depth0'):
            if key in sample:
                sample[key] = [_downscale_nearest(d, self.downscale)
                               for d in sample[key]]
        return sample


class ToNHWCTensor:
    """Terminal transform: stack lists to float32 NHWC numpy arrays and
    squeeze the per-sample sequence dim (Datasets/utils.py:159-187, NHWC)."""

    def __call__(self, sample):
        for kk in list(sample.keys()):
            if kk not in KEY2DIM:
                continue
            data = np.stack(sample[kk], axis=0).astype(np.float32)
            if KEY2DIM[kk] == 2:
                data = data[..., np.newaxis]  # (seq, h, w, 1)
            sample[kk] = np.ascontiguousarray(data[0])  # seq len is 1
        return sample


def make_intrinsics_layer(w, h, fx, fy, ox, oy):
    """Datasets/utils.py:376-381 (host-side numpy variant, HWC)."""
    ww, hh = np.meshgrid(range(w), range(h))
    ww = (ww.astype(np.float32) - ox + 0.5) / fx
    hh = (hh.astype(np.float32) - oy + 0.5) / fy
    return np.stack((ww, hh), axis=-1)
