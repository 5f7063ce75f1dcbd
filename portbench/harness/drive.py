"""Recorded drives made from a seed: a KITTI raw drive or an EuRoC MAV
folder, in the layouts the program's loaders read, written into a
directory of the run's own.

The pattern is the port's test fixtures' (``data/fixtures.py``): a smooth
random texture seen by a stereo camera that slides a few pixels a frame,
the right image the left one shifted by a disparity, and a smooth planar
trajectory whose IMU stream (KITTI: OXTS packets; EuRoC: imu0) is its
exact specific force and rate plus seeded noise.  Frames are written as
PNGs of unfiltered rows with zlib level 1, several at a time on a few
threads, so that writing stays a small part of the set-up.  Every size and
rate comes from the configuration's ``drive`` entry; the seed draws the
texture, the trajectory's phases and the noise, never a size.
"""

from __future__ import annotations

import datetime as dt
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial.transform import Rotation as R

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
WRITE_THREADS = 4


def png_bytes(img: np.ndarray) -> bytes:
    """A uint8 (H, W) grey or (H, W, 3) BGR image as PNG bytes: every row
    unfiltered, zlib level 1."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        ctype, rows = 0, img
    else:
        ctype, rows = 2, img[..., ::-1].reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def _write(path, img):
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def texture(rng, h, w, cn, grain) -> np.ndarray:
    """Coarse uniform noise, bilinearly upsampled x8, plus +-``grain``
    levels of fine noise: uint8 (h, w, cn)."""
    coarse = rng.integers(0, 256, (cn, h // 8 + 2, w // 8 + 2))
    t = torch.from_numpy(coarse.astype(np.float32))[None]
    smooth = F.interpolate(t, size=(h, w), mode="bilinear",
                           align_corners=False)[0].permute(1, 2, 0).numpy()
    fine = rng.integers(-grain, grain + 1, smooth.shape)
    return np.clip(np.rint(smooth) + fine, 0, 255).astype(np.uint8)


def stereo_frames(rng, spec, n):
    """n (left, right) pairs cut from one texture: frame i sits ``step_px``
    further along it, the right image ``disparity_px`` further still."""
    h, w, cn = spec["height"], spec["width"], spec["channels"]
    step, disp = spec["step_px"], spec["disparity_px"]
    tex = texture(rng, h + 8, w + step * n + disp + 8, cn, spec["grain"])
    if cn == 1:
        tex = tex[..., 0]
    for i in range(n):
        x0 = step * i + 4
        yield (np.ascontiguousarray(tex[4:4 + h, x0 + disp:x0 + disp + w]),
               np.ascontiguousarray(tex[4:4 + h, x0:x0 + w]))


def trajectory(rng, motion, t):
    """A smooth planar path at times ``t``: yaw, yaw rate, speed, its rate,
    world position and velocity.  The seed draws the phases."""
    p1, p2 = rng.uniform(0, 2 * np.pi, 2)
    wy, ws = motion["yaw_freq"], motion["speed_freq"]
    yaw = motion["yaw_amp"] * np.sin(wy * t + p1)
    yaw_rate = motion["yaw_amp"] * wy * np.cos(wy * t + p1)
    speed = motion["speed"] + motion["speed_amp"] * np.sin(ws * t + p2)
    accel = motion["speed_amp"] * ws * np.cos(ws * t + p2)
    vel = np.stack([speed * np.cos(yaw), speed * np.sin(yaw), 0 * t], 1)
    dt_ = np.diff(t, prepend=t[0])
    pos = np.cumsum(vel * dt_[:, None], axis=0)
    return yaw, yaw_rate, speed, accel, pos, vel


def _write_frames(paths_and_images):
    with ThreadPoolExecutor(WRITE_THREADS) as pool:
        for f in [pool.submit(_write, p, img) for p, img in paths_and_images]:
            f.result()


def write_kitti(root, spec, n, seed):
    """A KITTI raw drive of n frames (image_02/03, oxts at ``imu_per_frame``
    packets a frame) and the date folder's calibration; returns the drive
    folder.  The cameras are KITTI 2011_09_30's rectified 2 and 3."""
    rng = np.random.default_rng(seed)
    date_dir = os.path.join(root, "2011_09_30")
    drive = os.path.join(date_dir, "2011_09_30_drive_0018_sync")
    cal = spec["calib"]
    fx, cx, cy = cal["fx"], cal["cx"], cal["cy"]
    os.makedirs(date_dir, exist_ok=True)
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as out:
        out.write("calib_time: 09-Jan-2012 14:00:15\n")
        out.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        for cam, tx in (("02", cal["p2_tx"]), ("03", cal["p3_tx"])):
            out.write(f"P_rect_{cam}: {fx} 0 {cx} {tx} 0 {fx} {cy} 0 "
                      "0 0 1 0\n")
    for name, key in (("calib_velo_to_cam.txt", "velo_to_cam"),
                      ("calib_imu_to_velo.txt", "imu_to_velo")):
        with open(os.path.join(date_dir, name), "w") as out:
            out.write(f"calib_time: 25-May-2012 16:47:16\n"
                      f"R: {cal[key][0]}\nT: {cal[key][1]}\n")
    k = spec["imu_per_frame"]
    period = 1.0 / spec["frame_hz"]
    base = dt.datetime(2011, 9, 30, 12, 40, 2)

    def stamps(sub, count, step):
        os.makedirs(os.path.join(drive, sub, "data"), exist_ok=True)
        with open(os.path.join(drive, sub, "timestamps.txt"), "w") as out:
            out.write("".join(
                (base + dt.timedelta(seconds=i * step)).strftime(
                    "%Y-%m-%d %H:%M:%S.%f") + "000\n" for i in range(count)))

    n_imu = k * n
    stamps("oxts", n_imu, period / k)
    stamps("image_02", n, period)
    stamps("image_03", n, period)
    t = np.arange(n_imu) * (period / k)
    yaw, yaw_rate, speed, accel, pos, _ = trajectory(rng, spec["motion"], t)
    noise = spec["imu_noise"]
    acc = np.stack([accel, speed * yaw_rate, np.full_like(t, 9.81)], 1)
    acc += rng.normal(0, noise["accel"], acc.shape)
    gyro = np.stack([0 * t, 0 * t, yaw_rate], 1)
    gyro += rng.normal(0, noise["gyro"], gyro.shape)
    er, lat0, lon0 = 6378137.0, 49.011, 8.4235
    pkt = np.zeros((n_imu, 30))
    pkt[:, 0] = lat0 + pos[:, 1] / er * 180 / np.pi
    pkt[:, 1] = lon0 + pos[:, 0] / (er * np.cos(lat0 * np.pi / 180)) * (
        180 / np.pi)
    pkt[:, 2] = 112.0
    pkt[:, 5] = yaw
    pkt[:, 8] = speed
    pkt[:, 11:14] = acc
    pkt[:, 17:20] = gyro
    oxts = os.path.join(drive, "oxts", "data")
    for i in range(n_imu):
        with open(os.path.join(oxts, f"{i:010d}.txt"), "w") as out:
            out.write(" ".join(f"{v:.10g}" for v in pkt[i]) + "\n")
    jobs = []
    for i, (left, right) in enumerate(stereo_frames(rng, spec, n)):
        jobs.append((os.path.join(drive, "image_02", "data",
                                  f"{i:010d}.png"), left))
        jobs.append((os.path.join(drive, "image_03", "data",
                                  f"{i:010d}.png"), right))
    _write_frames(jobs)
    return drive


def _sensor_yaml(path, T, intrinsics=None, distortion=None, rate=None):
    with open(path, "w") as out:
        out.write("sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n")
        out.write("  data: [" + ", ".join(repr(float(v)) for v in
                                          np.asarray(T).ravel()) + "]\n")
        if intrinsics is not None:
            out.write(f"rate_hz: {rate}\ncamera_model: pinhole\n")
            out.write("intrinsics: [" + ", ".join(
                repr(float(v)) for v in intrinsics) + "]\n")
            out.write("distortion_model: radial-tangential\n")
            out.write("distortion_coefficients: [" + ", ".join(
                repr(float(v)) for v in distortion) + "]\n")


def write_euroc(root, spec, n, seed):
    """An EuRoC MAV folder ``root/mav0`` of n frames: cam0 and cam1 (grey,
    radial-tangential distortion), imu0 at ``imu_per_frame`` samples a
    frame, and the ground truth at the IMU rate; returns ``root/mav0``."""
    rng = np.random.default_rng(seed)
    mav = os.path.join(root, "mav0")
    k = spec["imu_per_frame"]
    period_ns = int(round(1e9 / spec["frame_hz"]))
    t0 = 1403636579763555584
    ts = t0 + np.arange(n) * period_ns
    ts_imu = t0 + np.arange(n * k) * (period_ns // k)
    cal = spec["calib"]
    T1 = np.eye(4)
    T1[:3, :3] = R.from_rotvec(cal["cam1_rotvec"]).as_matrix()
    T1[:3, 3] = cal["cam1_t"]
    jobs = []
    frames = list(stereo_frames(rng, spec, n))
    for c, (cam, T) in enumerate((("cam0", np.eye(4)), ("cam1", T1))):
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        with open(os.path.join(mav, cam, "data.csv"), "w") as out:
            out.write("#timestamp [ns],filename\n")
            out.write("".join(f"{s},{s}.png\n" for s in ts))
        jobs += [(os.path.join(mav, cam, "data", f"{s}.png"), frames[i][c])
                 for i, s in enumerate(ts)]
        _sensor_yaml(os.path.join(mav, cam, "sensor.yaml"), T,
                     cal[f"{cam}_intrinsics"], cal[f"{cam}_distortion"],
                     spec["frame_hz"])
    t = (ts_imu - t0) * 1e-9
    yaw, yaw_rate, speed, accel, pos, vel = trajectory(rng, spec["motion"],
                                                       t)
    bg, ba = np.asarray(cal["gyro_bias"]), np.asarray(cal["accel_bias"])
    q = R.from_euler("z", yaw[:, None]).as_quat()        # x y z w
    gt = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt, exist_ok=True)
    with open(os.path.join(gt, "data.csv"), "w") as out:
        out.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,"
                  "bw_x,bw_y,bw_z,ba_x,ba_y,ba_z\n")
        for i, s in enumerate(ts_imu):
            row = [*pos[i], q[i, 3], *q[i, :3], *vel[i], *bg, *ba]
            out.write(f"{s}," + ",".join(repr(float(v)) for v in row) + "\n")
    noise = spec["imu_noise"]
    acc = np.stack([accel, speed * yaw_rate, np.full_like(t, 9.81)], 1) + ba
    acc += rng.normal(0, noise["accel"], acc.shape)
    gyro = np.stack([0 * t, 0 * t, yaw_rate], 1) + bg
    gyro += rng.normal(0, noise["gyro"], gyro.shape)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as out:
        out.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i, s in enumerate(ts_imu):
            out.write(f"{s}," + ",".join(
                repr(float(v)) for v in (*gyro[i], *acc[i])) + "\n")
    _sensor_yaml(os.path.join(mav, "imu0", "sensor.yaml"), np.eye(4))
    _write_frames(jobs)
    return mav


WRITERS = {"kitti": write_kitti, "euroc": write_euroc}


def write(datatype, root, spec, n, seed):
    """The drive of ``n`` frames for ``datatype``; returns its folder."""
    return WRITERS[datatype](root, spec, n, seed)
