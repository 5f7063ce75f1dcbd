"""The port's PNG decoder and writer against cv2, and the native row
un-filter against its numpy version.

All comparisons are bitwise: decoding is exact integer arithmetic, so the
decoder must give what ``cv2.imread(path, cv2.IMREAD_COLOR)`` gives (BGR,
grayscale replicated to three channels, alpha dropped).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from islam_tpu_torch.data import image_io, native

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-image-io")
SHAPES = [(37, 53), (1, 1), (64, 128), (5, 200)]


def _image(shape, channels):
    full = shape + ((channels,) if channels > 1 else ())
    # a smooth ramp plus noise: every filter type has work to do
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 256
    noise = RNG.integers(0, 40, full)
    if channels > 1:
        ramp = ramp[..., None]
    return ((ramp + noise) % 256).astype(np.uint8)


def _cv2_color(img):
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "bgr", "bgra"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decoder_equals_cv2_on_cv2_written_pngs(tmp_path, shape, channels,
                                                level):
    img = _image(shape, channels)
    path = str(tmp_path / "im.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    out = image_io.read_image(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _cv2_color(img))


def _filter_types(path):
    with open(path, "rb") as f:
        data = f.read()
    (w, h, _, ctype) = struct.unpack(">IIBB", data[16:26])
    ch = {0: 1, 2: 3}[ctype]
    idat = b"".join(body for kind, body in image_io._chunks(data, path)
                    if kind == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "bgr"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 128)], ids=str)
def test_write_png_cycles_filters_and_cv2_reads_it(tmp_path, shape,
                                                   channels):
    img = _image(shape, channels)
    path = str(tmp_path / "im.png")
    image_io.write_png(path, img)
    assert _filter_types(path) == {0, 1, 2, 3, 4}
    ref = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ref, _cv2_color(img))
    np.testing.assert_array_equal(image_io.read_image(path), ref)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_numpy(bpp):
    h, w = 23, 31
    rows = RNG.integers(0, 256, (h, 1 + w * bpp)).astype(np.uint8)
    rows[:, 0] = RNG.integers(0, 5, h)
    rows[:5, 0] = np.arange(5)   # every filter, on the first row too
    data = rows.tobytes()
    out = native.png_unfilter(data, h, w * bpp, bpp)
    np.testing.assert_array_equal(
        out, native.png_unfilter_reference(data, h, w * bpp, bpp))


def test_unfilter_inverts_filter_rows():
    raw = RNG.integers(0, 256, (17, 3 * 19)).astype(np.uint8)
    filtered = image_io.filter_rows(raw, 3).tobytes()
    np.testing.assert_array_equal(native.png_unfilter(filtered, 17, 57, 3),
                                  raw)


def test_unfilter_rejects_unknown_filter():
    rows = np.zeros((3, 5), np.uint8)
    rows[2, 0] = 7
    with pytest.raises(ValueError, match="row 2: unknown filter type 7"):
        native.png_unfilter(rows.tobytes(), 3, 4, 1)


def test_read_image_rejects_what_it_cannot_decode(tmp_path):
    path = tmp_path / "im.jpg"
    assert cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_image(str(path))
    path = str(tmp_path / "im16.png")
    assert cv2.imwrite(path, np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.read_image(path)
    png = bytearray(open(str(tmp_path / "im16.png"), "rb").read())
    png[20] ^= 1  # inside IHDR: its CRC no longer holds
    with pytest.raises(ValueError, match="corrupt"):
        image_io.decode_png(bytes(png))
