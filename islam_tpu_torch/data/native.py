"""ctypes binding of the host preparation library (``csrc/host_preproc.cpp``)
and the numpy versions its functions are held to.

Counterpart of ``islam_tpu/data/native.py``, with PNG un-filtering and
cv2's bilinear resize and remap added.  The library is compiled with the
host C++ compiler at first use into ``islam_tpu_torch/_build/`` (once per
source content) and loaded with ``ctypes``; importing this module compiles
nothing.  A failed build raises: there is no silent numpy fallback.  The
numpy versions (``*_reference``) are what the tests compare against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host_preproc.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
          "-ffp-contract=off")
_LOCK = threading.Lock()
_LIB = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "preproc_batch": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I],
    "png_unfilter": [_P, _P, _I, _I, _I],
    "resize_linear_u8": [_P, _I, _I, _P, _I, _I, _I],
    "remap_linear_u8": [_P, _I, _I, _I, _P, _P, _P, _I, _I],
}
_RESTYPES = {"png_unfilter": ctypes.c_int}


def build() -> Path:
    """Compile the library (once per source content); returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libhost_preproc_{digest}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) to build "
                           f"{SOURCE.name}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name)
            _LIB = lib
    return _LIB


def _u8(a: np.ndarray, ndim: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype != np.uint8 or a.ndim != ndim:
        raise ValueError(f"{what}: need a {ndim}-d uint8 array, got "
                         f"{a.dtype} {a.shape}")
    return a


# ---- fused crop, /255 and normalise ----

def preproc_batch(images: np.ndarray, crop_hw: Tuple[int, int], mean, std,
                  num_threads: int = 4, want_norm: bool = True):
    """Center crop + /255 (+ normalise) of a uint8 NHWC batch of 3-channel
    images.  Returns (raw, norm) float32 NHWC arrays (norm None unless
    ``want_norm``)."""
    images = _u8(images, 4, "preproc_batch")
    n, sh, sw, c = images.shape
    th, tw = crop_hw
    if c != 3 or not (0 < th <= sh and 0 < tw <= sw):
        raise ValueError(f"preproc_batch: {images.shape} -> crop {crop_hw}")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    raw = np.empty((n, th, tw, 3), np.float32)
    norm = np.empty((n, th, tw, 3), np.float32) if want_norm else None
    load().preproc_batch(images.ctypes.data, n, sh, sw, th, tw,
                         mean.ctypes.data, std.ctypes.data, raw.ctypes.data,
                         None if norm is None else norm.ctypes.data,
                         num_threads)
    return raw, norm


def preproc_batch_reference(images, crop_hw, mean, std, want_norm=True):
    """numpy version of ``preproc_batch`` (Datasets/utils.py:88-101,206-228),
    in float32 with the library's reciprocals."""
    n, sh, sw, _ = images.shape
    th, tw = crop_hw
    y0, x0 = (sh - th) // 2, (sw - tw) // 2
    crop = images[:, y0:y0 + th, x0:x0 + tw].astype(np.float32) * (
        np.float32(1) / np.float32(255))
    if not want_norm:
        return crop, None
    inv_std = np.float32(1) / np.asarray(std, np.float32)
    return crop, (crop - np.asarray(mean, np.float32)) * inv_std


# ---- PNG un-filtering ----

def png_unfilter(data: bytes, height: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """Undo PNG's row filters.  ``data`` is the inflated IDAT stream:
    ``height`` rows of a filter byte and ``row_bytes`` bytes.  Returns
    (height, row_bytes) uint8."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, want "
                         f"{height} x (1 + {row_bytes})")
    out = np.empty((height, row_bytes), np.uint8)
    rc = load().png_unfilter(src.ctypes.data, out.ctypes.data, height,
                             row_bytes, bpp)
    if rc:
        raise ValueError(f"PNG row {rc - 1}: unknown filter type "
                         f"{src[(rc - 1) * (row_bytes + 1)]}")
    return out


def png_unfilter_reference(data: bytes, height: int, row_bytes: int,
                           bpp: int) -> np.ndarray:
    """numpy version of ``png_unfilter``: a loop over rows, and for Average
    and Paeth over pixels (about a second for a 1226x370 RGB image)."""
    rows = np.frombuffer(data, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.int32)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        cur = out[y]
        if ftype == 0:
            cur[:] = line
        elif ftype == 2:
            cur[:] = (line + prev) & 255
        elif ftype == 1:
            # each lane of bpp bytes is a running sum mod 256
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp]) & 255
        elif ftype in (3, 4):
            for x in range(0, row_bytes, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        prev = cur
    return out.astype(np.uint8)


# ---- cv2.resize(INTER_LINEAR) of uint8 images ----

def resize_linear_u8(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """cv2.resize(img, (tw, th), interpolation=INTER_LINEAR), bit for bit,
    for an (H, W) or (H, W, C) uint8 image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or min(
            img.shape[:2]) < 1 or th < 1 or tw < 1:
        raise ValueError(f"resize_linear_u8: {img.dtype} {img.shape} -> "
                         f"({th}, {tw})")
    sh, sw = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((th, tw) + img.shape[2:], np.uint8)
    load().resize_linear_u8(img.ctypes.data, sh, sw, out.ctypes.data, th, tw,
                            cn)
    return out


def _linear_taps(src_size: int, dst_size: int, clamp_edges: bool):
    f = ((np.arange(dst_size) + 0.5) * (src_size / dst_size) - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_edges:
        edge = (s < 0) | (s >= src_size - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, src_size - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s, w0, w1


def resize_linear_u8_reference(img: np.ndarray, th: int,
                               tw: int) -> np.ndarray:
    """numpy version of ``resize_linear_u8``: 11-bit taps (float position,
    floor, weights rounded half to even), the horizontal pass in int32,
    and cv2's vertical step ((S >> 4) * b >> 16 for each row, then
    (sum + 2) >> 2)."""
    sh, sw = img.shape[:2]
    src = img.reshape(sh, sw, -1).astype(np.int64)
    sx, a0, a1 = _linear_taps(sw, tw, True)
    hor = (src[:, sx] * a0[None, :, None]
           + src[:, np.minimum(sx + 1, sw - 1)] * a1[None, :, None])
    sy, b0, b1 = _linear_taps(sh, th, False)
    s0 = hor[np.clip(sy, 0, sh - 1)] >> 4
    s1 = hor[np.clip(sy + 1, 0, sh - 1)] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((th, tw) + img.shape[2:])


# ---- cv2.remap(INTER_LINEAR) of uint8 images by float maps ----

def remap_linear_u8(img: np.ndarray, map_x: np.ndarray,
                    map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) with a constant 0 border,
    bit for bit, for an (H, W) or (H, W, C) uint8 image and float32 maps
    of the output's (h, w)."""
    img = np.ascontiguousarray(img)
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            map_x.ndim != 2 or map_x.shape != map_y.shape):
        raise ValueError(f"remap_linear_u8: {img.dtype} {img.shape}, maps "
                         f"{map_x.shape} {map_y.shape}")
    sh, sw = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    th, tw = map_x.shape
    out = np.empty((th, tw) + img.shape[2:], np.uint8)
    load().remap_linear_u8(img.ctypes.data, sh, sw, cn, map_x.ctypes.data,
                           map_y.ctypes.data, out.ctypes.data, th, tw)
    return out


def remap_linear_u8_reference(img: np.ndarray, map_x: np.ndarray,
                              map_y: np.ndarray) -> np.ndarray:
    """numpy version of ``remap_linear_u8``: float32 lerps along x, then y,
    taps outside the image read 0, rounded half to even."""
    sh, sw = img.shape[:2]
    src = img.reshape(sh, sw, -1).astype(np.float32)
    map_x = np.asarray(map_x, np.float32)
    map_y = np.asarray(map_y, np.float32)
    x0, y0 = np.floor(map_x), np.floor(map_y)
    fx, fy = (map_x - x0)[..., None], (map_y - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
        v = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    a = p00 + fx * (p01 - p00)
    b = p10 + fx * (p11 - p10)
    out = np.clip(np.rint(a + fy * (b - a)), 0, 255).astype(np.uint8)
    return out.reshape(map_x.shape + img.shape[2:])
