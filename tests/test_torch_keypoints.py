"""The port's keypoint picker, its SIFT, and the sparse loss's overlay,
against the JAX package and cv2 on the CPU.

- ``detect_keypoints`` handed cv2's detections is bitwise the JAX
  package's (which calls cv2 itself): the grayscale, the resize, the floor,
  the mask, the seeded fill and the shuffle.
- ``ops/sift.py`` against ``cv2.SIFT_create().detect`` on the same gray
  images: precision and recall of the floored positions within 1 px, and
  the count of keypoints (a position counts once per orientation).  The
  port sums in another order than cv2, so a DoG value on a tie could flip
  an extremum; the bounds are 0.8 and 15 %.
- ``SparseReprojectionLoss.debug``'s PNGs are pixel for pixel the JAX
  package's, and ``draw_circle``/``draw_line`` are cv2's rasterisers.

No JAX graph is compiled here: the JAX side is cv2 and a few eager ops.
"""

import cv2
import numpy as np
import pytest
import torch

from islam_tpu.lie import SE3
from islam_tpu.ops import dense_ba as jdba
from islam_tpu_torch import lie
from islam_tpu_torch.data.image_io import read_image
from islam_tpu_torch.ops import dense_ba as tdba
from islam_tpu_torch.ops import geometry as tgeo
from islam_tpu_torch.ops import sift
from islam_tpu_torch.testing import make_dataset
from islam_tpu_torch.utils.visualization import draw_circle, draw_line

torch.set_num_threads(1)


def _frames(B, h, w, seed=0):
    """(B, h, w, 3) floats in [0, 1]: consecutive frames of the synthetic
    sequence's random texture."""
    ds = make_dataset(B + 1, h, w, seed=seed)
    return np.stack([np.asarray(ds[i]["img0"]).reshape(h, w, 3)
                     for i in range(B)])


def _scene(h, w, seed):
    """A uint8 gray image of smooth blobs, boxes and light noise: keypoints
    on the coarser octaves too."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 90.0)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(300):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s, a = rng.uniform(1.5, 12), rng.uniform(-80, 80)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    for _ in range(20):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(5, 40), x0:x0 + rng.integers(5, 40)] += (
            rng.uniform(-60, 60))
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_detector(gray):
    det = cv2.SIFT_create()
    return [np.array([kp.pt for kp in det.detect(g, None)],
                     np.float32).reshape(-1, 2)
            for g in gray.cpu().numpy()]


def test_gray_is_cv2_bgr2gray_bitwise():
    img = np.random.default_rng(0).integers(0, 256, (2, 37, 53, 3), np.uint8)
    ours = tdba.bgr2gray_u8(torch.from_numpy(img)).numpy()
    ref = np.stack([cv2.cvtColor(x, cv2.COLOR_BGR2GRAY) for x in img])
    np.testing.assert_array_equal(ours, ref)


# (B, image h, w, target height, width, N, mask, seed): no fill, a mask,
# a frame with fewer than N detections (the fill runs), a resize
CASES = {"plain": (2, 192, 256, 192, 256, 100, False, 0),
         "mask": (2, 192, 256, 192, 256, 100, True, 3),
         "fill": (1, 64, 128, 64, 128, 100, False, 3),
         "resize-mask": (2, 96, 160, 80, 120, 60, True, 0)}


@pytest.mark.parametrize("case", list(CASES))
def test_detect_keypoints_equals_jax_given_cv2_detections(case):
    B, h, w, th, tw, N, masked, seed = CASES[case]
    img = _frames(B, h, w)
    mask = None
    if masked:
        mask = np.random.default_rng(seed + 1).uniform(size=(B, th, tw)) > 0.4
    ref = jdba.detect_keypoints(img, tw, th, N=N, mask=mask, seed=seed)
    ours = tdba.detect_keypoints(img, tw, th, N=N, mask=mask, seed=seed,
                                 device="cpu", detector=_cv2_detector)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape == (B, N, 2)
    np.testing.assert_array_equal(ours, ref)
    if case == "fill":
        gray = cv2.cvtColor((img[0] * 255).astype(np.uint8),
                            cv2.COLOR_BGR2GRAY)
        assert len(cv2.SIFT_create().detect(gray, None)) < N


def _rates(ours, ref):
    """Precision and recall of the distinct floored positions, a match
    within 1 px in x and y."""
    a = np.unique(np.floor(ours), axis=0)
    b = np.unique(np.floor(ref), axis=0)
    d = np.abs(a[:, None] - b[None]).max(-1)
    return (d.min(1) <= 1).mean(), (d.min(0) <= 1).mean()


@pytest.mark.parametrize("kind", ["texture", "scene"])
def test_sift_matches_cv2(kind):
    if kind == "texture":
        gray = np.stack([cv2.cvtColor((x * 255).astype(np.uint8),
                                      cv2.COLOR_BGR2GRAY)
                         for x in _frames(2, 192, 256)])
    else:
        gray = np.stack([_scene(240, 320, s) for s in (0, 1)])
    ours = sift.sift_keypoints(gray, "cpu")
    ref = _cv2_detector(torch.from_numpy(gray))
    for o, r in zip(ours, ref):
        assert len(r) >= 100 and o.dtype == np.float32
        precision, recall = _rates(o, r)
        assert precision >= 0.8 and recall >= 0.8, (precision, recall)
        assert abs(len(o) - len(r)) <= 0.15 * len(r), (len(o), len(r))


def test_sift_finds_every_octave_and_repeats_a_position_per_orientation():
    gray = _scene(240, 320, 0)[None]
    pts = sift.sift_keypoints(gray, "cpu")[0]
    kps = cv2.SIFT_create().detect(gray[0], None)
    octaves = {kp.octave & 255 for kp in kps}
    assert {255, 0, 1, 2} <= octaves        # 255: the doubled image
    same = (pts[1:] == pts[:-1]).all(1)
    assert same.any()
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    np.testing.assert_array_equal(order, np.arange(len(pts)))


def test_reflect101_matches_cv2_border():
    for n in (1, 2, 3, 7):
        idx = sift._reflect101(n, 9, "cpu").numpy()
        ref = [cv2.borderInterpolate(int(p), n, cv2.BORDER_REFLECT_101)
               for p in range(-9, n + 9)]
        np.testing.assert_array_equal(idx, ref)


def test_gaussian_blur_matches_cv2():
    x = np.random.default_rng(2).uniform(0, 255, (2, 13, 40)).astype(
        np.float32)
    for s in (1.2489996, 3.09):
        ours = sift.gaussian_blur(torch.from_numpy(x), s).numpy()
        ref = np.stack([cv2.GaussianBlur(a, (0, 0), s) for a in x])
        np.testing.assert_allclose(ours, ref, atol=1e-3)


RGB2IMU = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01, 0.9993], np.float32)
RGB2IMU[3:] /= np.linalg.norm(RGB2IMU[3:])
IDENTITY = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)

# (B, H, W, scale, motion (7,), rgb2imu, flow scale): tests/test_geometry.py's
# overlay; a batch; motions that throw reprojections off the image; scale 4
DEBUG_CASES = {
    "geometry-case": (1, 24, 32, 2, [0.1, 0, 0, 0, 0, 0, 1], IDENTITY, 0),
    "batch": (2, 24, 32, 2, [0.05, 0.02, 0, 0, 0.01, 0, 1], RGB2IMU, 1.5),
    "off-image": (2, 24, 32, 2, [0.8, -0.4, 0.1, 0, 0.05, 0, 1], RGB2IMU,
                  3.0),
    "scale4": (2, 20, 28, 4, [0.3, 0.1, 0.1, 0.02, 0.05, 0, 1], RGB2IMU,
               2.0),
}


@pytest.mark.parametrize("case", list(DEBUG_CASES))
def test_debug_png_equals_jax(case, tmp_path):
    B, H, W, scale, motion, rgb2imu, fs = DEBUG_CASES[case]
    rng = np.random.default_rng(len(case))
    z = rng.uniform(3, 8, (B, H, W)).astype(np.float32)
    pts = np.floor(np.stack([rng.uniform(2, W - 3, (B, 8)),
                             rng.uniform(2, H - 3, (B, 8))], -1)
                   ).astype(np.float32)
    flow = (rng.normal(size=(B, 2, H, W)) * fs).astype(np.float32)
    motion = np.asarray(motion, np.float32)
    motion[3:] /= np.linalg.norm(motion[3:])
    motion = np.tile(motion, (B, 1))
    img0, img1 = rng.uniform(0, 1, (2, B, H, W, 3)).astype(np.float32)
    args = (40.0, 40.0, W / 2, H / 2)
    jloss = jdba.SparseReprojectionLoss(pts, z, flow, *args, rgb2imu)
    jloss.debug(SE3(motion), img0, img1, W, H, scale=scale,
                out_dir=str(tmp_path / "jax"))
    tloss = tdba.SparseReprojectionLoss(
        *(torch.from_numpy(x) for x in (pts, z, flow)), *args,
        torch.from_numpy(rgb2imu))
    tloss.debug(torch.from_numpy(motion), img0, torch.from_numpy(img1), W,
                H, scale=scale, out_dir=str(tmp_path / "port"))
    for i in range(B):
        ref = cv2.imread(str(tmp_path / "jax" / f"{i}_reproj.png"))
        ours = read_image(str(tmp_path / "port" / f"{i}_reproj.png"))
        assert ours.shape == ref.shape == (H * scale, 2 * W * scale, 3)
        np.testing.assert_array_equal(ours, ref)
    T = lie.se3_inv(tloss._camera_motion(torch.from_numpy(motion)))
    pts1 = tgeo.point2pixel(tloss.point3d, tloss.K, T[:, None]).numpy()
    off = ~((pts1 >= 0) & (pts1 < [W, H])).all(-1)
    if case == "off-image":
        assert off.any() and not off.all()


def test_rasterisers_match_cv2():
    """cv2.circle (radius 0-5) and cv2.line at their defaults over seeded
    centres and ends, many outside the image, some far outside."""
    rng = np.random.default_rng(7)
    for trial in range(600):
        h, w = rng.integers(1, 60, 2)
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        span = 5000 if trial % 5 == 0 else 100
        p, q = rng.integers(-span, span, (2, 2))
        r = int(rng.integers(0, 6))
        cv2.circle(a, q // 10 * (span // 100), r, (0, 0, 255))
        draw_circle(b, q // 10 * (span // 100), r, (0, 0, 255))
        cv2.line(a, p, q, (255, 0, 0))
        draw_line(b, p, q, (255, 0, 0))
        np.testing.assert_array_equal(b, a, err_msg=f"{trial} {p} {q} {r}")
