"""The port's host data layer against the JAX package's: loaders, the
folder dataset's samples, the transforms, stereo rectification, and the
native resize, remap and crop/normalise.

Fixtures: copies of ``tests/test_data.py``'s (written with cv2 and yaml),
and the port's own (``islam_tpu_torch.data.fixtures``, written with
``write_png``), 60x120 for KITTI so that ``CropCenter`` upscales to
64x128.

Tolerances: loader fields exact for file lists, indices and timestamps,
1e-6 for float fields.  Samples after the preset transforms: images within
one LSB, 1/255 (1/255/std after the normalisation).  The uint8 resize and
remap are bit-exact against cv2, but EuRoC's rectification maps agree with
cv2's only to ~1e-5 px, which moves a remapped pixel that sits on a
rounding tie by one LSB (3 of 24,576 values in the fixture).  The
intrinsics layer within 1e-5 (cv2's float resize against
``F.interpolate``); links, dt and motions exactly.  Rectification against cv2: intrinsics and
baseline 1e-4 relative, maps 1e-3 px.
"""

import os

import cv2
import numpy as np
import pytest
import yaml

from islam_tpu.data import dataset as jdataset
from islam_tpu.data import loaders as jloaders
from islam_tpu.data import native as jnative
from islam_tpu.data import transforms as jtransforms
from islam_tpu_torch import train as ttrain
from islam_tpu_torch.data import dataset as tdataset
from islam_tpu_torch.data import fixtures
from islam_tpu_torch.data import loaders as tloaders
from islam_tpu_torch.data import native, transforms

from tests.rng_helpers import PerTestRNG

RNG = PerTestRNG("torch-data")
H, W = 64, 128
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


# ---- copies of tests/test_data.py's fixtures (cv2 + yaml writers) ----

def make_tartanair_fixture(root, n=6, h=96, w=128):
    os.makedirs(f"{root}/image_left", exist_ok=True)
    os.makedirs(f"{root}/image_right", exist_ok=True)
    os.makedirs(f"{root}/imu", exist_ok=True)
    for i in range(n):
        img = RNG.integers(0, 255, (h, w, 3), np.uint8)
        cv2.imwrite(f"{root}/image_left/{i:06d}.png", img)
        cv2.imwrite(f"{root}/image_right/{i:06d}.png", img)
    poses = np.concatenate(
        [RNG.normal(size=(n, 3)),
         np.tile([0, 0, 0, 1.0], (n, 1))], axis=1)
    np.savetxt(f"{root}/pose_left.txt", poses)
    S = n * 10
    np.save(f"{root}/imu/acc_nograv_body.npy",
            RNG.normal(size=(S, 3)).astype(np.float32))
    np.save(f"{root}/imu/gyro.npy", RNG.normal(size=(S, 3)).astype(np.float32))
    np.save(f"{root}/imu/vel_global.npy",
            RNG.normal(size=(S, 3)).astype(np.float32))
    with open(f"{root}/imu/parameter.yaml", "w") as f:
        yaml.dump({"acc_zero_bias": [0.01, 0.02, 0.03],
                   "gyro_zero_bias": [0.001, 0.002, 0.003]}, f)


def make_euroc_fixture(root, n=5, h=96, w=128):
    ts = (np.arange(n) * 50 + 1000) * int(1e6)  # ns, 20 Hz
    for cam in ("cam0", "cam1"):
        os.makedirs(f"{root}/{cam}/data", exist_ok=True)
        with open(f"{root}/{cam}/data.csv", "w") as f:
            f.write("#timestamp,filename\n")
            for t in ts:
                f.write(f"{t},{t}.png\n")
                img = RNG.integers(0, 255, (h, w, 3), np.uint8)
                cv2.imwrite(f"{root}/{cam}/data/{t}.png", img)
        K = [100.0, 100.0, w / 2, h / 2]
        T = np.eye(4)
        if cam == "cam1":
            T[0, 3] = 0.11  # baseline
        with open(f"{root}/{cam}/sensor.yaml", "w") as f:
            yaml.dump({"intrinsics": K,
                       "distortion_coefficients": [0.0, 0.0, 0.0, 0.0],
                       "T_BS": {"data": T.reshape(-1).tolist()}}, f)

    os.makedirs(f"{root}/state_groundtruth_estimate0", exist_ok=True)
    with open(f"{root}/state_groundtruth_estimate0/data.csv", "w") as f:
        f.write("#ts," + ",".join(f"c{i}" for i in range(16)) + "\n")
        for i, t in enumerate(ts):
            pos = [i * 0.1, 0, 0]
            quat_wxyz = [1.0, 0, 0, 0]
            vel = [1.0, 0, 0]
            bg = [0.001, 0.002, 0.003]
            ba = [0.01, 0.02, 0.03]
            row = [t] + pos + quat_wxyz + vel + bg + ba
            f.write(",".join(str(x) for x in row) + "\n")

    os.makedirs(f"{root}/imu0", exist_ok=True)
    ts_imu = (np.arange(n * 10) * 5 + 1000) * int(1e6)  # 200 Hz
    with open(f"{root}/imu0/data.csv", "w") as f:
        f.write("#ts,wx,wy,wz,ax,ay,az\n")
        for t in ts_imu:
            f.write(f"{t},0.01,0.02,0.03,0.1,0.2,9.9\n")
    T_BI = np.eye(4)
    with open(f"{root}/imu0/sensor.yaml", "w") as f:
        yaml.dump({"T_BS": {"data": T_BI.reshape(-1).tolist()}}, f)


def make_kitti_fixture(root, n=5, h=96, w=128, hz_ratio=2):
    """date_dir/drive_sync layout with calib files + oxts packets."""
    import datetime as dt

    date_dir = os.path.dirname(root)
    os.makedirs(date_dir, exist_ok=True)
    with open(f"{date_dir}/calib_cam_to_cam.txt", "w") as f:
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_02: 100 0 {w/2} -10 0 100 {h/2} 0 0 0 1 0\n")
        f.write(f"P_rect_03: 100 0 {w/2} -60 0 100 {h/2} 0 0 0 1 0\n")
    with open(f"{date_dir}/calib_velo_to_cam.txt", "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: 0.1 -0.05 -0.3\n")
    with open(f"{date_dir}/calib_imu_to_velo.txt", "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: -0.8 0.3 0.8\n")

    n_imu = n * hz_ratio

    def write_ts(sub, count, period):
        os.makedirs(f"{root}/{sub}", exist_ok=True)
        with open(f"{root}/{sub}/timestamps.txt", "w") as f:
            base = dt.datetime(2011, 9, 30, 12, 0, 0)
            for i in range(count):
                t = base + dt.timedelta(seconds=i * period)
                f.write(t.strftime("%Y-%m-%d %H:%M:%S.%f") + "000\n")

    write_ts("oxts", n_imu, 0.05)
    write_ts("image_02", n, 0.1)
    write_ts("image_03", n, 0.1)

    os.makedirs(f"{root}/oxts/data", exist_ok=True)
    for i in range(n_imu):
        pkt = np.zeros(30)
        pkt[0] = 49.0 + i * 1e-6   # lat
        pkt[1] = 8.43 + i * 2e-6   # lon
        pkt[2] = 110.0             # alt
        pkt[5] = 0.01 * i          # yaw
        pkt[8:11] = [5.0, 0.1, 0.0]     # vf, vl, vu
        pkt[11:14] = [0.1, 0.2, 9.8]    # ax, ay, az
        pkt[17:20] = [0.01, 0.02, 0.03]  # wx, wy, wz
        np.savetxt(f"{root}/oxts/data/{i:010d}.txt", pkt[None])

    for cam in ("image_02", "image_03"):
        os.makedirs(f"{root}/{cam}/data", exist_ok=True)
        for i in range(n):
            img = RNG.integers(0, 255, (h, w, 3), np.uint8)
            cv2.imwrite(f"{root}/{cam}/data/{i:010d}.png", img)


def _write(kind, source, tmp):
    """A sequence folder of ``kind``, from the copied cv2 fixtures or the
    port's ``fixtures`` module."""
    tmp = str(tmp)
    if source == "port":
        if kind == "kitti":
            return fixtures.write_kitti(tmp, n=6, h=60, w=120)
        return fixtures.WRITERS[kind](tmp, n=6)
    root = {"tartanair": f"{tmp}/P000", "euroc": f"{tmp}/mav0",
            "kitti": f"{tmp}/2011_09_30/2011_09_30_drive_0018_sync"}[kind]
    {"tartanair": make_tartanair_fixture, "euroc": make_euroc_fixture,
     "kitti": make_kitti_fixture}[kind](root)
    return root


KINDS = ["kitti", "euroc", "tartanair"]
SOURCES = ["cv2", "port"]
EXACT = {"rgbfiles", "rgbfiles_right", "flowfiles", "depthfiles", "rgb_ts",
         "imu_ts", "rgb2imu_sync", "has_imu", "require_undistort", "gravity"}


def kitti_from_origin(monkeypatch):
    """Give JAX's KITTI loader the port's repair, in this process only:
    positions from the first OXTS packet (pykitti's ``t - origin``)."""
    to_pose = jloaders._kitti_oxts_to_pose

    def from_origin(oxts):
        T = to_pose(oxts)
        T[:, :3, 3] -= T[0, :3, 3]
        return T

    monkeypatch.setattr(jloaders, "_kitti_oxts_to_pose", from_origin)


@pytest.mark.parametrize("source", SOURCES)
def test_kitti_positions_start_at_the_first_packet(tmp_path, monkeypatch,
                                                   source):
    """The port's KITTI poses are JAX's float64 devkit poses less packet
    0's translation (packet 0 of all packets, before the frame sync): to
    1e-6 m before the float32 cast and bitwise after it; the rotations and
    the velocities are JAX's."""
    root = _write("kitti", source, tmp_path)
    ref = jloaders.load_kitti(root)
    cast = tloaders._se3_from_matrix_np
    seen = []
    monkeypatch.setattr(tloaders, "_se3_from_matrix_np",
                        lambda T: (seen.append(T.copy()), cast(T))[1])
    out = tloaders.load_kitti(root)
    files = sorted(os.listdir(f"{root}/oxts/data"))
    oxts = np.stack([np.loadtxt(f"{root}/oxts/data/{f}") for f in files])
    T = jloaders._kitti_oxts_to_pose(oxts)
    assert np.abs(T[:, :3, 3]).max() > 1e5     # Mercator metres
    want = (T[:, :3, 3] - T[0, :3, 3])[out.rgb2imu_sync]
    # the poses are the loader's first casts (then the extrinsics)
    np.testing.assert_allclose(np.stack(seen[:len(want)])[:, :3, 3], want,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.poses[:, :3], want.astype(np.float32))
    np.testing.assert_array_equal(out.poses[:, 3:], ref.poses[:, 3:])
    np.testing.assert_array_equal(out.vels, ref.vels)
    assert out.rgb2imu_sync[0] == 0 and not out.poses[0, :3].any()


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("kind", KINDS)
def test_loader_matches_jax(tmp_path, monkeypatch, kind, source):
    kitti_from_origin(monkeypatch)
    root = _write(kind, source, tmp_path)
    ref = jloaders.LOADERS[kind](root)
    out = tloaders.LOADERS[kind](root)
    for field in ref.__dataclass_fields__:
        r, o = getattr(ref, field), getattr(out, field)
        if r is None or o is None:
            assert r is None and o is None, field
        elif field in ("imgmap", "imgmap_right"):
            for a, b in zip(o, r):
                np.testing.assert_allclose(a, b, atol=1e-3, err_msg=field)
        elif field in EXACT:
            if isinstance(r, list):
                assert o == r, field
            else:
                np.testing.assert_array_equal(np.asarray(o), np.asarray(r),
                                              err_msg=field)
        else:
            np.testing.assert_allclose(np.asarray(o, np.float64),
                                       np.asarray(r, np.float64), rtol=1e-6,
                                       atol=1e-6, err_msg=field)


def test_euroc_rectification_matches_cv2(tmp_path):
    """Non-zero radial-tangential distortion and a ~1 degree turn between
    the cameras: the port's Bouguet rectification against cv2's."""
    root = fixtures.write_euroc(str(tmp_path), n=4)
    cams = [tloaders.read_yaml(f"{root}/{c}/sensor.yaml")
            for c in ("cam0", "cam1")]
    K = [tloaders.intrinsic2matrix(c["intrinsics"]).astype(np.float64)
         for c in cams]
    D = [np.asarray(c["distortion_coefficients"], np.float64) for c in cams]
    T_BL, T_BR = (np.asarray(c["T_BS"]["data"]).reshape(4, 4) for c in cams)
    T_lr = np.linalg.inv(np.linalg.inv(T_BL) @ T_BR)
    assert np.abs(D[0]).max() > 0.1
    h, w = 60, 120
    R1, R2, P1, P2, *_ = cv2.stereoRectify(
        K[0], D[0], K[1], D[1], (w, h), T_lr[:3, :3],
        T_lr[:3, 3].reshape(3, 1), alpha=0)
    r2l = tloaders._se3_from_matrix_np(np.linalg.inv(T_lr))
    new_l, new_r, new_r2l, lmap, rmap = tloaders.stereo_rectify(
        cams[0]["intrinsics"], D[0], cams[1]["intrinsics"], D[1], w, h, r2l)
    np.testing.assert_allclose(new_l, tloaders.matrix2intrinsic(P1),
                               rtol=1e-4)
    np.testing.assert_allclose(new_r, tloaders.matrix2intrinsic(P2),
                               rtol=1e-4)
    np.testing.assert_allclose(new_r2l[0], -P2[0, 3] / P2[0, 0], rtol=1e-4)
    for (Kk, Dk, Rk, Pk), ours in (((K[0], D[0], R1, P1), lmap),
                                   ((K[1], D[1], R2, P2), rmap)):
        ref = cv2.initUndistortRectifyMap(Kk, Dk, Rk, Pk, (w, h),
                                          cv2.CV_32FC1)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, atol=1e-3)


YAML_BLOCK = """\
# comment
sensor_type: camera
T_BS:
  cols: 4
  data:
  - 1.0
  - -2.5e-05
rate_hz: 20
intrinsics:
- 458.654
- 457.296
name: 'cam0'
"""
YAML_FLOW = """\
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768]
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


@pytest.mark.parametrize("text", [YAML_BLOCK, YAML_FLOW],
                         ids=["block", "flow"])
def test_read_yaml_matches_yaml(tmp_path, text):
    path = tmp_path / "sensor.yaml"
    path.write_text(text)
    assert tloaders.read_yaml(str(path)) == yaml.safe_load(text)


def test_sync_data_matches_jax():
    src = np.sort(RNG.uniform(0, 10, 50))
    tar = np.sort(RNG.uniform(-1, 11, 20))
    np.testing.assert_array_equal(tloaders.sync_data(src, tar),
                                  jloaders.sync_data(src, tar))


def _jax_transform():
    return jtransforms.Compose([
        jtransforms.CropCenter((H, W), fix_ratio=True),
        jtransforms.DownscaleFlow(),
        jtransforms.Normalize(mean=MEAN, std=STD, keep_old=True),
        jtransforms.ToNHWCTensor()])


@pytest.mark.parametrize("kind", KINDS)
def test_samples_match_jax(tmp_path, monkeypatch, kind):
    """TrajFolderDataset after the preset transforms (KITTI upscales 60x120
    -> 64x128, EuRoC undistorts and rectifies)."""
    kitti_from_origin(monkeypatch)
    root = _write(kind, "port", tmp_path)
    ref = jdataset.TrajFolderDataset(root, kind, transform=_jax_transform())
    out = tdataset.TrajFolderDataset(root, kind,
                                     transform=ttrain.make_transform(H, W))
    assert len(out) == len(ref) == 4
    tally = {"images": 0, "decode": 0.0}
    for idx in (0, 3):
        r, o = ref[idx], out.sample(idx, tally)
        assert set(o) == set(r)
        for k in ("img0", "img1", "img0_r", "img1_r", "img0_norm",
                  "img1_norm", "img0_r_norm", "img1_r_norm"):
            assert o[k].shape == r[k].shape == (H, W, 3), k
            # 1 LSB: 1/255, and 1/255/std after the normalisation
            lsb = 1.0 / 255 / (np.asarray(STD) if k.endswith("norm") else 1)
            assert np.all(np.abs(o[k] - r[k]) <= lsb + 1e-6), k
        np.testing.assert_allclose(o["intrinsic"], r["intrinsic"], atol=1e-5)
        np.testing.assert_allclose(o["intrinsic_calib"], r["intrinsic_calib"],
                                   rtol=1e-6)
        for k in ("link", "dt", "motion", "extrinsic"):
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    # the two samples' images, each pair a left and a right of both frames
    assert tally["images"] == 8 and tally["decode"] > 0


def test_frame_range_imu_realignment(tmp_path):
    root = _write("tartanair", "port", tmp_path)
    ref = jdataset.TrajFolderDataset(root, "tartanair", start_frame=1,
                                     end_frame=5)
    out = tdataset.TrajFolderDataset(root, "tartanair", start_frame=1,
                                     end_frame=5)
    assert out.num_img == ref.num_img == 4 and out.rgb2imu_sync[0] == 0
    for k in ("rgb2imu_sync", "accels", "gyros", "imu_dts", "imu_ts",
              "poses", "vels", "motions", "rgb_dts", "rgb_ts"):
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k), k)


def test_iterate_batches_drops_the_tail(tmp_path):
    root = _write("kitti", "port", tmp_path)
    ds = tdataset.TrajFolderDataset(root, "kitti",
                                    transform=ttrain.make_transform(H, W))
    batches = list(tdataset.iterate_batches(ds, 3))
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0]["link"],
                                  [[0, 1], [1, 2], [2, 3]])
    assert batches[0]["img0"].shape == (3, H, W, 3)


@pytest.mark.parametrize("size", [(60, 120), (370, 1226)], ids=str)
def test_crop_center_upscale_within_one_lsb_of_cv2(size):
    """CropCenter on uint8 images that need the upscale (KITTI's 370 rows
    below the 448 crop): the port's resize against cv2's."""
    h, w = size
    crop = (H, W) if h < H else (448, 640)
    img = RNG.integers(0, 256, (h, w, 3), np.uint8)
    ref = jtransforms.CropCenter(crop)({"img0": [img.copy()]})["img0"][0]
    out = transforms.CropCenter(crop)({"img0": [img.copy()]})["img0"][0]
    assert out.dtype == np.uint8 and out.shape == ref.shape == crop + (3,)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (
        f"max {diff.max()} LSB, {100 * (diff > 0).mean():.3f} % of pixels "
        "differ")


@pytest.mark.parametrize("shape", [(370, 1226, 448, 1484, 3),
                                   (60, 120, 64, 128, 3), (50, 61, 80, 97, 1),
                                   (96, 128, 48, 64, 3), (7, 5, 3, 2, 3)],
                         ids=str)
def test_resize_u8_matches_cv2_bitwise(shape):
    h, w, th, tw, c = shape
    img = RNG.integers(0, 256, (h, w, c) if c > 1 else (h, w), np.uint8)
    ref = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(native.resize_linear_u8(img, th, tw), ref)
    np.testing.assert_array_equal(
        native.resize_linear_u8_reference(img, th, tw), ref)


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_u8_matches_cv2_bitwise(channels):
    """Maps with sub-pixel jitter and points outside the image (constant 0
    border); cv2's INTER_AREA remap is its INTER_LINEAR one."""
    h, w = 48, 64
    img = RNG.integers(0, 256, (h, w, channels) if channels > 1 else (h, w),
                       np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = (xx * 1.07 - 2.3 + RNG.normal(0, 0.7, xx.shape)).astype(np.float32)
    my = (yy * 0.96 + 1.1 + RNG.normal(0, 0.7, yy.shape)).astype(np.float32)
    ref = cv2.remap(img, mx, my, cv2.INTER_AREA)
    np.testing.assert_array_equal(native.remap_linear_u8(img, mx, my), ref)
    np.testing.assert_array_equal(native.remap_linear_u8_reference(img, mx, my),
                                  ref)


def test_native_preproc_matches_numpy():
    img = RNG.integers(0, 256, (3, 80, 100, 3), dtype=np.uint8)
    raw, norm = native.preproc_batch(img, (64, 96), MEAN, STD)
    rraw, rnorm = native.preproc_batch_reference(img, (64, 96), MEAN, STD)
    np.testing.assert_array_equal(raw, rraw)
    np.testing.assert_array_equal(norm, rnorm)
    jraw, jnorm = jnative.preproc_batch(img, (64, 96), MEAN, STD)
    np.testing.assert_allclose(raw, jraw, atol=1e-6)
    np.testing.assert_allclose(norm, jnorm, atol=1e-5)
    raw2, none = native.preproc_batch(img, (64, 96), MEAN, STD,
                                      want_norm=False)
    assert none is None
    np.testing.assert_array_equal(raw2, raw)


@pytest.mark.parametrize("keep_old", [True, False])
def test_normalize_native_path_matches_float_path(keep_old):
    """uint8 images take the native pass, float images numpy's; both give
    the same /255 and normalised images to float32 rounding."""
    img = RNG.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    norm = transforms.Normalize(mean=MEAN, std=STD, keep_old=keep_old)
    a = norm({"img0": [img.copy()]})
    b = norm({"img0": [img.astype(np.float32)]})
    assert set(a) == set(b)
    for k in a:
        assert a[k][0].dtype == np.float32
        np.testing.assert_allclose(a[k][0], b[k][0], atol=1e-6, err_msg=k)
