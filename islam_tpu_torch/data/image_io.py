"""Image files without an image library: PNG decoding and writing.

``read_image(path)`` is the counterpart of ``cv2.imread(path,
cv2.IMREAD_COLOR)`` as the JAX package's dataset uses it
(``islam_tpu/data/dataset.py:112-121``): uint8 (H, W, 3) in BGR order.  A
grayscale PNG (EuRoC's) is replicated to three channels and an alpha
channel is dropped, as ``IMREAD_COLOR`` does.  Decoding is ``zlib`` plus
the native row un-filter (``native.png_unfilter``); 8-bit, non-interlaced
PNGs of every colour type are read, anything else raises.

``write_png(path, img)`` writes a uint8 (H, W) or BGR (H, W, 3) image, as
``cv2.imwrite`` would, for test fixtures and ``chip_smoke.py``.  Its rows
cycle through the five filter types, so a reader of its files meets every
filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from islam_tpu_torch.data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3) BGR."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (only PNG is decoded)")
    return decode_png(data, path)


def _chunks(data: bytes, what: str):
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{what}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{what}: no IEND chunk")


def decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) BGR, as cv2.IMREAD_COLOR decodes."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, what):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{what}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{what}: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit, non-interlaced "
                         "PNGs are decoded")
    ch = _CHANNELS[ctype]
    px = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch,
                             ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{what}: palette image without PLTE")
        px = palette[px[..., 0]]
    elif ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter (h, row_bytes) uint8 rows, row y with filter y % 5;
    returns (h, 1 + row_bytes) uint8 with the filter byte first."""
    x = rows.astype(np.int32)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (0, left, up, (left + up) >> 1, paeth)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    for y in range(x.shape[0]):
        ftype = y % 5
        out[y, 0] = ftype
        pred = preds[ftype]
        out[y, 1:] = (x[y] - (pred[y] if ftype else 0)) & 255
    return out


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 (H, W) grayscale or (H, W, 3) BGR image as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: need uint8 (H, W) or (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if img.ndim == 2:
        ctype, rows, bpp = 0, img, 1
    else:
        ctype, rows, bpp = 2, img[..., ::-1].reshape(h, w * 3), 3
    raw = filter_rows(np.ascontiguousarray(rows), bpp)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))
