"""The cv2-free visualization against the JAX package's cv2 renders.

The port computes in torch (here on the CPU) and writes PNGs with
``image_io.write_png``; the JAX package calls cv2 (``cvtColor``,
``resize``, ``remap``, ``imwrite``).  Images are compared after both are
read back (cv2.imread for JAX's files, ``image_io.read_image`` for the
port's).

Tolerance for uint8 renders: at most one level, with at least 99 % of the
pixels equal.  One exception, cv2's own: its vectorised HSV-to-BGR loop
truncates and its scalar tail of each row rounds, so the share of equal
pixels of ``visflow`` depends on the row width cv2's vector loop leaves
over; the flows here are 160 wide, the width of the VO's 1/4-scale flow at
448x640 (at 53 columns, 87 % of the pixels are equal).  Angles and lengths
1e-5.
"""

import cv2
import numpy as np
import pytest
import torch

from islam_tpu.utils import visualization as jvis
from islam_tpu_torch.data.image_io import read_image
from islam_tpu_torch.utils import visualization as vis

torch.set_num_threads(1)


def _u8_close(out, ref):
    out, ref = np.asarray(out).astype(int), np.asarray(ref).astype(int)
    assert out.shape == ref.shape
    d = np.abs(out - ref)
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(),
                                                      (d == 0).mean())


def _flow(seed, h=112, w=160, scale=30.0):
    return (np.random.default_rng(seed).normal(size=(h, w, 2)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("degree", [False, True])
def test_angle_distance(degree):
    f = _flow(0)
    ref = jvis.calculate_angle_distance_from_du_dv(f[..., 0], f[..., 1],
                                                   degree)
    out = vis.calculate_angle_distance_from_du_dv(
        torch.from_numpy(f[..., 0]), torch.from_numpy(f[..., 1]), degree)
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5)
    assert out[2] == ref[2]


@pytest.mark.parametrize("masked", [False, True])
def test_visflow(masked):
    f = _flow(1)
    mask = ((np.random.default_rng(2).uniform(size=f.shape[:2]) > 0.3)
            * 255).astype(np.uint8) if masked else None
    _u8_close(vis.visflow(f, mask=mask, device="cpu"),
              jvis.visflow(f.copy(), mask=mask))


def test_hsv_to_bgr_against_cv2():
    """Every (hue, saturation, value) in 64-wide rows, as cv2 converts
    them."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(0, 256, 5),
                          np.arange(0, 256, 5), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 64, 3).astype(np.uint8)
    _u8_close(vis.hsv_to_bgr(torch.from_numpy(hsv)).numpy(),
              cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_visdepth_and_visrgb():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(60, 80)).astype(np.float32)
    _u8_close(vis.visdepth(d, device="cpu"), jvis.visdepth(d))
    img = rng.normal(size=(60, 80, 3)).astype(np.float32) * 0.2
    _u8_close(vis.visrgb(img, mean=[0.485, 0.456, 0.406],
                         std=[0.229, 0.224, 0.225], device="cpu"),
              jvis.visrgb(img, mean=[0.485, 0.456, 0.406],
                          std=[0.229, 0.224, 0.225]))


@pytest.mark.parametrize("kind", ["rgb", "flow", "depth"])
@pytest.mark.parametrize("fx", [1, 2, 0.3])
def test_save_images(tmp_path, kind, fx):
    rng = np.random.default_rng(4)
    data = {"rgb": rng.uniform(size=(2, 48, 160, 3)),
            "flow": rng.normal(size=(2, 48, 160, 2)) * 20,
            "depth": rng.normal(size=(2, 1, 48, 160))}[kind]
    data = data.astype(np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jvis.save_images(str(tmp_path / "j"), data, prefix="x", suffix="_y",
                     fx=fx, fy=fx)
    vis.save_images(str(tmp_path / "p"), data, prefix="x", suffix="_y",
                    fx=fx, fy=fx, device="cpu")
    for i in range(2):
        name = f"x{i}_y.png"
        _u8_close(read_image(str(tmp_path / "p" / name)),
                  cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_COLOR))


def test_warp_images(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.uniform(size=(2, 3, 64, 128)).astype(np.float32)  # NCHW
    flow = (rng.normal(size=(2, 16, 32, 2)) * 3).astype(np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    ref = jvis.warp_images(str(tmp_path / "j"), data, flow)
    out = vis.warp_images(str(tmp_path / "p"), data, flow, device="cpu")
    assert out.dtype == np.uint8 and out.shape == (2, 16, 32, 3)
    _u8_close(out, ref)
    for i in range(2):
        _u8_close(read_image(str(tmp_path / "p" / f"{i}_warp.png")),
                  cv2.imread(str(tmp_path / "j" / f"{i}_warp.png")))
