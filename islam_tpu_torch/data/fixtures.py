"""Small sequence folders in the KITTI raw, EuRoC and TartanAir layouts,
written from a seed with ``image_io.write_png``: the inputs of the folder
datasets' tests, of ``chip_smoke.py`` and of the CPU commands in the README.

    python -m islam_tpu_torch.data.fixtures kitti DIR [--frames 26]
        [--height 60] [--width 120] [--seed 0]

prints the sequence folder to pass as ``--data-root`` (for KITTI it is
``DIR/2011_09_30/2011_09_30_drive_0001_sync``, beside the date folder's
calibration files).

Images are a smooth random texture seen through a camera that slides by a
few pixels a frame; the right image is the left one shifted by a
disparity, so stereo and flow see real structure.  The trajectory is a
smooth drive; KITTI's OXTS packets come at 10x the image rate, EuRoC's
IMU at 10x and TartanAir's at 10x, as on the real sequences.
"""

from __future__ import annotations

import argparse
import datetime as dt
import os

import numpy as np
from scipy.spatial.transform import Rotation as R

from islam_tpu_torch.data import native
from islam_tpu_torch.data.image_io import write_png

# KITTI 2011_09_30's rectified cameras 2 and 3 (fx 707 px, baseline 0.54 m)
# and its velodyne and IMU extrinsics, at the 1226x370 size
KITTI_P2 = (707.0912, 601.8873, 183.1104, 46.88783)   # fx, cx, cy, P[0,3]
KITTI_P3_TX = -333.4597
KITTI_VELO_TO_CAM = ("7.027555e-03 -9.999753e-01 2.599616e-05 -2.254837e-03 "
                     "-4.184312e-05 -9.999975e-01 9.999728e-01 7.027479e-03 "
                     "-2.255075e-03", "-7.137748e-03 -7.482656e-02 "
                     "-3.336324e-01")
KITTI_IMU_TO_VELO = ("9.999976e-01 7.553071e-04 -2.035826e-03 -7.854027e-04 "
                     "9.998898e-01 -1.482298e-02 2.024406e-03 1.482454e-02 "
                     "9.998881e-01", "-8.086759e-01 3.195559e-01 "
                     "-7.997231e-01")


def texture(rng, h, w, cn=3) -> np.ndarray:
    """A smooth random uint8 texture: coarse noise upsampled, plus fine
    grain, so that its PNGs compress about as photographs do."""
    coarse = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), cn),
                          dtype=np.uint8)
    smooth = native.resize_linear_u8(coarse, h, w).astype(np.int16)
    grain = rng.integers(-12, 13, smooth.shape, dtype=np.int16)
    out = np.clip(smooth + grain, 0, 255).astype(np.uint8)
    return out[..., 0] if cn == 1 else out


def _frames(rng, n, h, w, disparity, cn=3):
    """n stereo pairs cut from one texture: frame i is shifted by 2 px a
    frame, the right image by ``disparity`` px more."""
    step = 2
    tex = texture(rng, h + 8, w + step * n + disparity + 8, cn)
    for i in range(n):
        x0 = step * i + 4
        left = tex[4:4 + h, x0 + disparity:x0 + disparity + w]
        right = tex[4:4 + h, x0:x0 + w]
        yield np.ascontiguousarray(left), np.ascontiguousarray(right)


def _drive(n, dt_s):
    """A smooth planar drive sampled every ``dt_s`` s: positions (n, 3) in
    a local east-north-up frame, yaw (n,), forward speed, yaw rate."""
    t = np.arange(n) * dt_s
    yaw = 0.1 * np.sin(0.4 * t)
    yaw_rate = 0.04 * np.cos(0.4 * t)
    speed = 5.0 + 0.5 * np.sin(0.3 * t)
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw), 0 * t], axis=1)
    pos = np.concatenate([np.zeros((1, 3)),
                          np.cumsum(vel[:-1] * dt_s, axis=0)])
    return t, pos, yaw, speed, yaw_rate


def write_kitti(root: str, n: int = 26, h: int = 370, w: int = 1226,
                seed: int = 0) -> str:
    """A KITTI raw drive: ``root/2011_09_30/2011_09_30_drive_0001_sync``
    with image_02, image_03 (n frames at 10 Hz) and oxts (10 n packets at
    100 Hz); the calibration files in the date folder.  Returns the drive
    folder.  Intrinsics scale with w / 1226."""
    rng = np.random.default_rng(seed)
    date_dir = os.path.join(root, "2011_09_30")
    drive = os.path.join(date_dir, "2011_09_30_drive_0001_sync")
    os.makedirs(date_dir, exist_ok=True)
    f = w / 1226.0
    fx, cx, cy, tx2 = (v * f for v in KITTI_P2)
    tx3 = KITTI_P3_TX * f
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as out:
        out.write("calib_time: 09-Jan-2012 14:00:15\n")
        out.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        for cam, tx in (("02", tx2), ("03", tx3)):
            out.write(f"P_rect_{cam}: {fx} 0 {cx} {tx} 0 {fx} {cy} 0 "
                      "0 0 1 0\n")
    for name, (rot, trans) in (("calib_velo_to_cam.txt", KITTI_VELO_TO_CAM),
                               ("calib_imu_to_velo.txt", KITTI_IMU_TO_VELO)):
        with open(os.path.join(date_dir, name), "w") as out:
            out.write(f"calib_time: 25-May-2012 16:47:16\nR: {rot}\n"
                      f"T: {trans}\n")

    def timestamps(sub, count, period):
        os.makedirs(os.path.join(drive, sub, "data"), exist_ok=True)
        base = dt.datetime(2011, 9, 30, 12, 40, 2)
        with open(os.path.join(drive, sub, "timestamps.txt"), "w") as out:
            for i in range(count):
                t = base + dt.timedelta(seconds=i * period)
                out.write(t.strftime("%Y-%m-%d %H:%M:%S.%f") + "000\n")

    n_imu = 10 * n
    timestamps("oxts", n_imu, 0.01)
    timestamps("image_02", n, 0.1)
    timestamps("image_03", n, 0.1)
    t, pos, yaw, speed, yaw_rate = _drive(n_imu, 0.01)
    er, lat0, lon0 = 6378137.0, 49.011, 8.4235
    for i in range(n_imu):
        pkt = np.zeros(30)
        pkt[0] = lat0 + pos[i, 1] / er * 180 / np.pi
        pkt[1] = lon0 + pos[i, 0] / (er * np.cos(lat0 * np.pi / 180)) * (
            180 / np.pi)
        pkt[2] = 112.0
        pkt[5] = yaw[i]
        pkt[8:11] = (speed[i], 0.0, 0.0)                        # vf vl vu
        pkt[11:14] = (0.15 * np.cos(0.3 * t[i]), speed[i] * yaw_rate[i],
                      9.81)                                     # ax ay az
        pkt[17:20] = (0.0, 0.0, yaw_rate[i])                    # wx wy wz
        np.savetxt(os.path.join(drive, "oxts", "data", f"{i:010d}.txt"),
                   pkt[None], fmt="%.10g")
    disparity = max(1, round(24 * f))
    for i, (left, right) in enumerate(_frames(rng, n, h, w, disparity)):
        write_png(os.path.join(drive, "image_02", "data", f"{i:010d}.png"),
                  left)
        write_png(os.path.join(drive, "image_03", "data", f"{i:010d}.png"),
                  right)
    return drive


def _sensor_yaml(path, T, intrinsics=None, distortion=None,
                 flow_style=True):
    """An EuRoC sensor.yaml: flow lists as the real files write them, or
    block lists as ``yaml.dump`` does."""
    def lst(key, values, indent=""):
        if flow_style:
            return f"{indent}{key}: [{', '.join(repr(float(v)) for v in values)}]\n"
        return f"{indent}{key}:\n" + "".join(
            f"{indent}- {float(v)!r}\n" for v in values)

    with open(path, "w") as out:
        out.write("# General sensor definitions.\nsensor_type: camera\n"
                  "T_BS:\n  cols: 4\n  rows: 4\n")
        out.write(lst("data", np.asarray(T).ravel(), "  "))
        if intrinsics is not None:
            out.write("rate_hz: 20\ncamera_model: pinhole\n")
            out.write(lst("intrinsics", intrinsics))
            out.write("distortion_model: radial-tangential\n")
            out.write(lst("distortion_coefficients", distortion))


def write_euroc(root: str, n: int = 9, h: int = 60, w: int = 120,
                seed: int = 0) -> str:
    """An EuRoC MAV folder ``root/mav0``: cam0 and cam1 (grayscale, 20 Hz,
    radial-tangential distortion, cam1 0.11 m to the right and turned by
    ~1 degree), imu0 (200 Hz), state_groundtruth_estimate0.  Returns
    ``root/mav0``."""
    rng = np.random.default_rng(seed)
    mav = os.path.join(root, "mav0")
    ts = (np.arange(n) * 50 + 1000) * 1000000         # ns, 20 Hz
    f = 0.6 * w
    cams = {
        "cam0": ([f, f * 1.002, w / 2 - 0.6, h / 2 + 0.4],
                 [-0.28, 0.074, 2e-4, 1.8e-5], np.eye(4)),
        "cam1": ([f * 0.998, f, w / 2 + 0.9, h / 2 - 0.3],
                 [-0.27, 0.07, -1e-4, -3.6e-5], None),
    }
    T1 = np.eye(4)
    T1[:3, :3] = R.from_rotvec([0.003, -0.015, 0.004]).as_matrix()
    T1[:3, 3] = (0.110, -0.0004, 0.0009)
    cams["cam1"] = cams["cam1"][:2] + (T1,)
    frames = list(_frames(rng, n, h, w, max(1, round(0.08 * w)), cn=1))
    for c, (cam, (K, D, T)) in enumerate(cams.items()):
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        with open(os.path.join(mav, cam, "data.csv"), "w") as out:
            out.write("#timestamp [ns],filename\n")
            for i, t in enumerate(ts):
                out.write(f"{t},{t}.png\n")
                write_png(os.path.join(mav, cam, "data", f"{t}.png"),
                          frames[i][c])
        _sensor_yaml(os.path.join(mav, cam, "sensor.yaml"), T, K, D,
                     flow_style=(cam == "cam0"))

    t, pos, yaw, speed, yaw_rate = _drive(n, 0.05)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"),
                exist_ok=True)
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as out:
        out.write("#timestamp," + ",".join(f"c{i}" for i in range(16)) + "\n")
        for i, stamp in enumerate(ts):
            q = R.from_euler("z", yaw[i]).as_quat()        # x y z w
            row = ([stamp, *pos[i], q[3], *q[:3], speed[i] * np.cos(yaw[i]),
                    speed[i] * np.sin(yaw[i]), 0.0]
                   + [0.001, 0.002, 0.003] + [0.01, 0.02, 0.03])
            out.write(f"{int(row[0])}," + ",".join(
                repr(float(v)) for v in row[1:]) + "\n")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    ts_imu = (np.arange(n * 10) * 5 + 1000) * 1000000  # ns, 200 Hz
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as out:
        out.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k, stamp in enumerate(ts_imu):
            wz = float(0.04 * np.cos(0.4 * k * 0.005))
            out.write(f"{stamp},0.001,-0.002,{wz!r},0.1,0.05,9.81\n")
    _sensor_yaml(os.path.join(mav, "imu0", "sensor.yaml"), np.eye(4))
    return mav


def write_tartanair(root: str, n: int = 9, h: int = 60, w: int = 120,
                    seed: int = 0, flow: bool = False,
                    depth: bool = False) -> str:
    """A TartanAir trajectory ``root/P000``: image_left, image_right,
    pose_left.txt and imu/ (100 Hz, gravity-free, with parameter.yaml in
    block style).  With ``flow``, flow/{i:06d}_{i+1:06d}_flow.npy ((h, w, 2)
    float32: the frames' -2 px shift along x, plus noise); with ``depth``,
    depth_left/{i:06d}_left_depth.npy ((h, w) float32: TartanAir's
    fx * baseline over the stereo disparity, plus noise).  Returns
    ``root/P000``."""
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "P000")
    for sub in ("image_left", "image_right", "imu"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    disparity = max(1, round(0.1 * w))
    for i, (left, right) in enumerate(_frames(rng, n, h, w, disparity)):
        write_png(os.path.join(seq, "image_left", f"{i:06d}_left.png"), left)
        write_png(os.path.join(seq, "image_right", f"{i:06d}_right.png"),
                  right)
    t, pos, yaw, speed, yaw_rate = _drive(n, 0.1)
    q = R.from_euler("z", yaw[:, None]).as_quat()
    np.savetxt(os.path.join(seq, "pose_left.txt"),
               np.concatenate([pos, q], axis=1))
    S = n * 10
    ti, _, yaw_i, speed_i, rate_i = _drive(S, 0.01)
    np.save(os.path.join(seq, "imu", "acc_nograv_body.npy"), np.stack(
        [0.15 * np.cos(0.3 * ti), speed_i * rate_i, 0 * ti], 1
    ).astype(np.float32))
    np.save(os.path.join(seq, "imu", "gyro.npy"), np.stack(
        [0 * ti, 0 * ti, rate_i], 1).astype(np.float32))
    np.save(os.path.join(seq, "imu", "vel_global.npy"), np.stack(
        [speed_i * np.cos(yaw_i), speed_i * np.sin(yaw_i), 0 * ti], 1
    ).astype(np.float32))
    with open(os.path.join(seq, "imu", "parameter.yaml"), "w") as out:
        out.write("acc_zero_bias:\n- 0.01\n- 0.02\n- 0.03\n"
                  "gyro_zero_bias:\n- 0.001\n- 0.002\n- 0.003\n")
    # drawn after everything above, so the other files do not change
    if flow:
        os.makedirs(os.path.join(seq, "flow"), exist_ok=True)
        for i in range(n - 1):
            f = rng.normal(0.0, 0.1, (h, w, 2)).astype(np.float32)
            f[..., 0] -= 2.0
            np.save(os.path.join(seq, "flow", f"{i:06d}_{i + 1:06d}_flow.npy"),
                    f)
    if depth:
        os.makedirs(os.path.join(seq, "depth_left"), exist_ok=True)
        for i in range(n):
            d = 320.0 * 0.25 / disparity + rng.normal(0.0, 0.01, (h, w))
            np.save(os.path.join(seq, "depth_left",
                                 f"{i:06d}_left_depth.npy"),
                    d.astype(np.float32))
    return seq


WRITERS = {"kitti": write_kitti, "euroc": write_euroc,
           "tartanair": write_tartanair}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kind", choices=sorted(WRITERS))
    p.add_argument("root")
    p.add_argument("--frames", type=int, default=26)
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--width", type=int, default=120)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    print(WRITERS[a.kind](a.root, a.frames, a.height, a.width, a.seed))


if __name__ == "__main__":
    main()
