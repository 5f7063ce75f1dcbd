"""The image side of the plain reference: PNG decoding, cv2's uint8
INTER_LINEAR resize and remap, the centre crop and normalisation, and the
ray map, in numpy (reference Datasets/utils.py and TrajFolderDataset.py).

The resize and remap follow OpenCV's fixed-point and float rules bit for
bit; they are frozen copies of the numpy versions the port's
``data/native.py`` holds its C++ to (``*_reference``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _unfilter(data: bytes, height: int, row_bytes: int, bpp: int):
    rows = np.frombuffer(data, np.uint8).reshape(height, row_bytes + 1)
    if not rows[:, 0].any():               # every row unfiltered
        return np.ascontiguousarray(rows[:, 1:])
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
            raise ValueError(f"PNG row {y}: filter type {ftype}")
        prev = cur
    return out.astype(np.uint8)


def read_image(path: str) -> np.ndarray:
    """An 8-bit grey or RGB PNG as cv2.imread(IMREAD_COLOR) gives it:
    uint8 (H, W, 3) BGR, grey replicated to three channels."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit grey or RGB PNGs are read")
    ch = 1 if ctype == 0 else 3
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch,
                   ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., ::-1])


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


def resize_linear_u8(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """cv2.resize(img, (tw, th), INTER_LINEAR) of a uint8 image: 11-bit
    taps, the horizontal pass in integers, cv2's vertical step."""
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


def remap_linear_u8(img: np.ndarray, map_x: np.ndarray,
                    map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR), constant 0 border:
    float32 lerps along x then y, rounded half to even."""
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


def ray_map(w: int, h: int, fx, fy, ox, oy) -> np.ndarray:
    """Datasets/utils.py make_intrinsics_layer: (h, w, 2) float32."""
    ww, hh = np.meshgrid(range(w), range(h))
    return np.stack(((ww.astype(np.float32) - ox + 0.5) / fx,
                     (hh.astype(np.float32) - oy + 0.5) / fy), axis=-1)


def crop_plan(h: int, w: int, th: int, tw: int):
    """CropCenter(fix_ratio=True): the size to resize to (only ever up),
    and the crop's corner.  Returns ((rh, rw) or None, y1, x1)."""
    s = max(max(1.0, th / h), max(1.0, tw / w))
    if s > 1.0:
        rh, rw = int(round(h * s)), int(round(w * s))
        return (rh, rw), int((rh - th) / 2), int((rw - tw) / 2)
    return None, int((h - th) / 2), int((w - tw) / 2)
