"""The drive folders' parsing, for the plain reference: a frozen copy of
the KITTI raw and EuRoC MAV parts of the port's ``data/loaders.py``
(reference Datasets/TrajFolderDataset.py), so that the reference reads the
calibration, the IMU streams and the timestamps of a drive, and works out
EuRoC's rectification maps, without importing the program.  Images are
read by ``ref/images.py``.
"""

from __future__ import annotations

import datetime as dt
import os
from dataclasses import dataclass
from os.path import isfile
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation as R

from portbench.ref.images import read_image

def sync_data(ts_src: np.ndarray, ts_tar: np.ndarray) -> np.ndarray:
    """Nearest-neighbor timestamp sync (TrajFolderDataset.py:17-27):
    res[i] = argmin_j |ts_src[j] - ts_tar[i]| found by a forward sweep."""
    res = []
    j = 0
    for t in ts_tar:
        while j + 1 < len(ts_src) and abs(ts_src[j + 1] - t) <= abs(ts_src[j] - t):
            j += 1
        res.append(j)
    return np.array(res)


def intrinsic2matrix(intrinsic):
    fx, fy, cx, cy = intrinsic
    return np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1],
                    dtype=np.float32).reshape(3, 3)


def matrix2intrinsic(m):
    return np.array([m[0, 0], m[1, 1], m[0, 2], m[1, 2]], dtype=np.float32)


def _se3_from_matrix_np(T: np.ndarray) -> np.ndarray:
    """4x4 -> [t(3), q(xyzw)]."""
    q = R.from_matrix(T[:3, :3]).as_quat()
    return np.concatenate([T[:3, 3], q]).astype(np.float32)


def _se3_to_matrix_np(p: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R.from_quat(p[3:]).as_matrix()
    T[:3, 3] = p[:3]
    return T


# ---------------------------------------------------------------------------
# Stereo rectification (cv2.stereoRectify + cv2.initUndistortRectifyMap)
# ---------------------------------------------------------------------------

def _distortion(d) -> np.ndarray:
    """cv2's 14 distortion coefficients (k1 k2 p1 p2 k3 k4 k5 k6 s1..s4 tx
    ty), zero beyond the given ones."""
    k = np.zeros(14)
    d = np.asarray(d, np.float64).ravel()
    k[:d.size] = d
    return k


def undistort_points(pts, K, D, Rm=None, P=None, iters: int = 5):
    """cv2.undistortPoints: (N, 2) pixels -> undistorted normalised points,
    rotated by ``Rm`` and projected by ``P`` where given (5 fixed-point
    iterations, cv2's default)."""
    k = _distortion(D)
    pts = np.asarray(pts, np.float64)
    x = (pts[:, 0] - K[0, 2]) * (1.0 / K[0, 0])
    y = (pts[:, 1] - K[1, 2]) * (1.0 / K[1, 1])
    x0, y0 = x, y
    if np.any(k):
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / (
                1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
            dx = (2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2
                  + k[9] * r2 * r2)
            dy = (k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2
                  + k[11] * r2 * r2)
            good = icdist >= 0
            x = np.where(good, (x0 - dx) * icdist, x0)
            y = np.where(good, (y0 - dy) * icdist, y0)
    RR = np.eye(3)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3].copy()
    if Rm is not None:
        RR = RR @ np.asarray(Rm, np.float64)
    xh = np.stack([x, y, np.ones_like(x)], axis=1) @ RR.T
    return xh[:, :2] / xh[:, 2:]


def _inner_rectangle(K, D, Rm, P, width, height, n=9):
    """The rectangle (x, y, w, h) inscribed in the undistorted-rectified
    image, from an n x n grid of pixel centres (cv2's
    getUndistortRectangles)."""
    gx, gy = np.meshgrid(np.arange(n) * (width - 1) / (n - 1),
                         np.arange(n) * (height - 1) / (n - 1))
    p = undistort_points(np.stack([gx.ravel(), gy.ravel()], axis=1),
                         K, D, Rm, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, -1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[-1, :, 1].min()
    return ix0, iy0, ix1 - ix0, iy1 - iy0


def stereo_rectify_params(K1, D1, K2, D2, width, height, Rm, T):
    """cv2.stereoRectify(K1, D1, K2, D2, (width, height), Rm, T, alpha=0)
    with its default CALIB_ZERO_DISPARITY: returns (R1, R2, P1, P2)."""
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    T = np.asarray(T, np.float64).ravel()
    # rotate both cameras half way, then align the baseline with x or y
    r_r = R.from_rotvec(-0.5 * R.from_matrix(Rm).as_rotvec()).as_matrix()
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(abs(c) / nt) / nw
    wR = R.from_rotvec(ww).as_matrix()
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    nx, ny = float(width), float(height)
    fc = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]],
                       np.float32)
    cc = []
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        und = undistort_points(corners, K, D)
        X = np.concatenate([und, np.ones((4, 1))], axis=1) @ Rk.T
        proj = (fc * X[:, :2] / X[:, 2:]).astype(np.float32)
        avg = proj.astype(np.float64).mean(axis=0)
        cc.append(np.array([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]]))
    cc = [(cc[0] + cc[1]) * 0.5] * 2  # CALIB_ZERO_DISPARITY

    def proj_matrix(f, ck, tx=0.0):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = f
        P[0, 2], P[1, 2] = ck
        P[2, 2] = 1.0
        P[idx, 3] = tx
        return P

    P1 = proj_matrix(fc, cc[0])
    P2 = proj_matrix(fc, cc[1], t[idx] * fc)
    # alpha = 0: scale so that only valid pixels remain; the last pixel
    # centre is at (nx - 1, ny - 1), as in the installed cv2's rule
    s = -np.inf
    for K, D, Rk, P, (cx, cy) in ((K1, D1, R1, P1, cc[0]),
                                  (K2, D2, R2, P2, cc[1])):
        ix, iy, iw, ih = _inner_rectangle(K, D, Rk, P, width, height)
        s = max(s, cx / (cx - ix), cy / (cy - iy),
                (nx - 1 - cx) / (ix + iw - cx), (ny - 1 - cy) / (iy + ih - cy))
    P1[0, 0] = P1[1, 1] = P2[0, 0] = P2[1, 1] = fc * s
    P2[idx, 3] *= s
    return R1, R2, P1, P2


def init_undistort_rectify_map(K, D, Rm, P, width, height):
    """cv2.initUndistortRectifyMap(K, D, Rm, P, (width, height), CV_32FC1):
    (map_x, map_y) float32 (height, width)."""
    k = _distortion(D)
    K = np.asarray(K, np.float64)
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ Rm)
    jj, ii = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    _x = jj * iR[0, 0] + ii * iR[0, 1] + iR[0, 2]
    _y = jj * iR[1, 0] + ii * iR[1, 1] + iR[1, 2]
    _w = jj * iR[2, 0] + ii * iR[2, 1] + iR[2, 2]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    kr = (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2) / (
        1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
    u = K[0, 0] * (x * kr + k[2] * _2xy + k[3] * (r2 + 2 * x2) + k[8] * r2
                   + k[9] * r2 * r2) + K[0, 2]
    v = K[1, 1] * (y * kr + k[2] * (r2 + 2 * y2) + k[3] * _2xy + k[10] * r2
                   + k[11] * r2 * r2) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def stereo_rectify(left_intrinsic, left_distortion, right_intrinsic,
                   right_distortion, width, height, right2left_pose):
    """Stereo rectification (TrajFolderDataset.py:42-62).

    ``right2left_pose`` is [t, q]; returns the new intrinsics, the new
    right2left pose, and the undistort-rectify pixel maps."""
    left_K = intrinsic2matrix(left_intrinsic).astype(np.float64)
    right_K = intrinsic2matrix(right_intrinsic).astype(np.float64)
    D1 = np.asarray(left_distortion, np.float64)
    D2 = np.asarray(right_distortion, np.float64)
    T_lr = np.linalg.inv(_se3_to_matrix_np(right2left_pose))
    R1, R2, P1, P2 = stereo_rectify_params(left_K, D1, right_K, D2, width,
                                           height, T_lr[:3, :3], T_lr[:3, 3])
    left_map = init_undistort_rectify_map(left_K, D1, R1, P1, width, height)
    right_map = init_undistort_rectify_map(right_K, D2, R2, P2, width, height)
    new_r2l = np.array([-P2[0, 3] / P2[0, 0], 0, 0, 0, 0, 0, 1],
                       dtype=np.float32)
    return (matrix2intrinsic(P1), matrix2intrinsic(P2), new_r2l, left_map,
            right_map)


# ---------------------------------------------------------------------------
# Small file readers (in place of yaml and pandas)
# ---------------------------------------------------------------------------

def _scalar(s: str):
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    low = s.lower()
    if low in ("null", "~", ""):
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _flow_list(s: str):
    body = s.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"not a flow list: {s!r}")
    body = body[1:-1].strip()
    return [_scalar(v) for v in body.split(",")] if body else []


def _strip_comment(line: str) -> str:
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(path: str) -> dict:
    """The YAML subset of sensor and parameter files: nested mappings,
    scalars, and lists of scalars in block (``- x``) or flow (``[x, y]``,
    over several lines) style.  Anything else raises ValueError."""
    lines = []
    with open(path) as f:
        for raw in f:
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip() or line.startswith(("%", "---")):
                continue
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def flow(i, text):
        # a flow list may run over several lines
        while text.count("[") > text.count("]"):
            i += 1
            if i >= len(lines):
                raise ValueError(f"{path}: unterminated list")
            text += " " + lines[i][1]
        return _flow_list(text), i + 1

    def block(i, indent):
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            out = []
            while i < len(lines) and lines[i][0] == indent and (
                    lines[i][1].startswith("-")):
                item = lines[i][1][1:].strip()
                if item.startswith("["):
                    value, i = flow(i, item)
                elif ":" in item and not item.startswith(("'", '"')):
                    raise ValueError(f"{path}: mappings in lists are not "
                                     "read")
                else:
                    value, i = _scalar(item), i + 1
                out.append(value)
            return out, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, sep, rest = lines[i][1].partition(":")
            if not sep or key.startswith("-"):
                raise ValueError(f"{path}: cannot read {lines[i][1]!r}")
            key, rest = _scalar(key), rest.strip()
            if rest.startswith("["):
                out[key], i = flow(i, rest)
            elif rest:
                out[key], i = _scalar(rest), i + 1
            elif i + 1 < len(lines) and (lines[i + 1][0] > indent or (
                    lines[i + 1][0] == indent
                    and lines[i + 1][1].startswith("-"))):
                out[key], i = block(i + 1, lines[i + 1][0])
            else:
                out[key], i = None, i + 1
        return out, i

    if not lines:
        return {}
    value, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"{path}: cannot read {lines[end][1]!r}")
    return value


def _read_csv(path: str):
    """A CSV with a header line, as ``pandas.read_csv(path).values``: a
    float64 array when every field is a number (timestamps included, as
    pandas gives them), else rows of strings."""
    with open(path) as f:
        next(f)
        rows = [line.strip().split(",") for line in f if line.strip()]
    try:
        return np.array([[float(v) for v in r] for r in rows], np.float64)
    except ValueError:
        return rows


def _ms(ns) -> np.ndarray:
    """Nanosecond timestamps -> integer milliseconds, as the JAX loader
    computes them (``values.astype(int) // int(1e6)``)."""
    return np.asarray(ns).astype(np.int64) // 1000000


# ---------------------------------------------------------------------------
# Sequence records and loaders
# ---------------------------------------------------------------------------

@dataclass
class SequenceData:
    rgbfiles: list
    rgb_dts: np.ndarray
    rgb_ts: np.ndarray
    intrinsic: np.ndarray
    poses: np.ndarray                      # (N, 7) [t, q]
    rgbfiles_right: Optional[list] = None
    intrinsic_right: Optional[np.ndarray] = None
    right2left_pose: Optional[np.ndarray] = None   # (7,)
    flowfiles: Optional[list] = None
    depthfiles: Optional[list] = None
    vels: Optional[np.ndarray] = None
    has_imu: bool = False
    accels: Optional[np.ndarray] = None
    gyros: Optional[np.ndarray] = None
    imu_dts: Optional[np.ndarray] = None
    imu_ts: Optional[np.ndarray] = None
    rgb2imu_sync: Optional[np.ndarray] = None
    rgb2imu_pose: Optional[np.ndarray] = None      # (7,)
    gravity: float = 9.81
    accel_bias: Optional[np.ndarray] = None
    gyro_bias: Optional[np.ndarray] = None
    require_undistort: bool = False
    imgmap: Optional[tuple] = None
    imgmap_right: Optional[tuple] = None



def _euroc_camera(datadir: str, cam: str):
    rows = _read_csv(f'{datadir}/{cam}/data.csv')
    ts = np.array([int(r[0]) for r in rows], np.int64) // 1000000
    files = [f'{datadir}/{cam}/data/{r[1].strip()}' for r in rows]
    res = read_yaml(f'{datadir}/{cam}/sensor.yaml')
    return (ts, files, np.array(res['intrinsics'], np.float32),
            np.array(res['distortion_coefficients'], np.float32),
            np.array(res['T_BS']['data'], np.float32).reshape(4, 4))


def load_euroc(datadir: str) -> SequenceData:
    """EuRoC MAV layout (TrajFolderDataset.py:139-238): cam0/cam1 CSVs with
    rectification, state_groundtruth_estimate0 (poses, vels, biases), imu0."""
    ts_left, rgbfiles, intrinsic, distortion, T_BL = _euroc_camera(
        datadir, 'cam0')
    all_ts = [ts_left]

    rgbfiles_right = intrinsic_right = right2left = None
    imgmap = imgmap_right = None
    require_undistort = False
    if isfile(datadir + '/cam1/data.csv'):
        (ts_right, rgbfiles_right, intrinsic_right, distortion_right,
         T_BR) = _euroc_camera(datadir, 'cam1')
        all_ts.append(ts_right)
        right2left = _se3_from_matrix_np(np.linalg.inv(T_BL) @ T_BR)
        h, w = read_image(rgbfiles_right[0]).shape[:2]
        intrinsic, intrinsic_right, right2left, imgmap, imgmap_right = (
            stereo_rectify(intrinsic, distortion, intrinsic_right,
                           distortion_right, w, h, right2left))
        require_undistort = True

    gt = _read_csv(datadir + '/state_groundtruth_estimate0/data.csv')
    ts_pose = _ms(gt[:, 0])
    all_ts.append(ts_pose)
    poses = gt[:, (1, 2, 3, 5, 6, 7, 4)].astype(np.float32)
    vels = gt[:, 8:11].astype(np.float32)
    accel_bias_seq = gt[:, 14:17].astype(np.float32)
    gyro_bias_seq = gt[:, 11:14].astype(np.float32)

    # Keep only timestamps present in every stream (TrajFolderDataset.py:193-205)
    common = set(all_ts[0].tolist())
    for t in all_ts[1:]:
        common &= set(t.tolist())
    rgbfiles = [f for f, t in zip(rgbfiles, ts_left) if t in common]
    if rgbfiles_right is not None:
        rgbfiles_right = [f for f, t in zip(rgbfiles_right, ts_right)
                          if t in common]
    keep_pose = [i for i, t in enumerate(ts_pose) if t in common]
    poses = poses[keep_pose]
    vels = vels[keep_pose]
    timestamps = np.sort(np.array(list(common), np.int64))

    data = SequenceData(
        rgbfiles=rgbfiles,
        rgb_dts=np.diff(timestamps).astype(np.float32) * 1e-3,
        rgb_ts=timestamps.astype(np.float64) * 1e-3,
        intrinsic=intrinsic, poses=poses, vels=vels,
        rgbfiles_right=rgbfiles_right, intrinsic_right=intrinsic_right,
        right2left_pose=right2left, require_undistort=require_undistort,
        imgmap=imgmap, imgmap_right=imgmap_right,
    )

    if isfile(datadir + '/imu0/data.csv'):
        imu = _read_csv(datadir + '/imu0/data.csv')
        ts_imu = _ms(imu[:, 0])
        data.accels = imu[:, 4:7].astype(np.float32)
        data.gyros = imu[:, 1:4].astype(np.float32)
        imu2pose = sync_data(ts_pose, ts_imu)
        data.accel_bias = np.mean(accel_bias_seq[imu2pose], axis=0)
        data.gyro_bias = np.mean(gyro_bias_seq[imu2pose], axis=0)
        data.imu_dts = np.diff(ts_imu).astype(np.float32) * 1e-3
        data.imu_ts = ts_imu.astype(np.float64) * 1e-3
        data.rgb2imu_sync = sync_data(ts_imu, timestamps)
        res = read_yaml(datadir + '/imu0/sensor.yaml')
        T_BI = np.array(res['T_BS']['data'], np.float32).reshape(4, 4)
        data.rgb2imu_pose = _se3_from_matrix_np(np.linalg.inv(T_BI) @ T_BL)
        data.gravity = 9.81
        data.has_imu = True
    return data


def _read_kitti_calib_file(path):
    out = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            k, v = line.split(':', 1)
            try:
                out[k.strip()] = np.array(
                    [float(x) for x in v.split()], np.float64)
            except ValueError:
                pass
    return out


def _kitti_oxts_to_pose(oxts: np.ndarray):
    """OXTS packets (N, >=20) -> T_w_imu (N, 4, 4) via the KITTI devkit's
    Mercator projection (the same math pykitti implements)."""
    er = 6378137.0
    lat, lon, alt = oxts[:, 0], oxts[:, 1], oxts[:, 2]
    roll, pitch, yaw = oxts[:, 3], oxts[:, 4], oxts[:, 5]
    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt
    # devkit: R = Rz(yaw) Ry(pitch) Rx(roll) = intrinsic ZYX
    rots = R.from_euler('ZYX', np.stack([yaw, pitch, roll], axis=1)
                        ).as_matrix()
    T = np.tile(np.eye(4), (len(oxts), 1, 1))
    T[:, :3, :3] = rots
    T[:, :3, 3] = np.stack([tx, ty, tz], axis=1)
    return T


def load_kitti(datadir: str) -> SequenceData:
    """KITTI raw layout (TrajFolderDataset.py:241-344): cam2/cam3 stereo,
    100 Hz OXTS IMU, world velocities from vf/vl/vu.  OXTS text packets,
    devkit Mercator poses, and the calib chain
    T_camN_imu = TN . R_rect_00 . T_velo_cam . T_imu_velo.  Positions are
    taken from the first OXTS packet, in float64 before the float32 cast,
    as pykitti does (``t - origin``): absolute Mercator metres (~4e6 m
    northing) in float32 keep only 0.25 m steps."""
    parts = datadir.rstrip('/').split('/')
    date_dir = '/'.join(parts[:-1])

    ts_imu = _load_kitti_timestamps(datadir, 'oxts')
    ts_rgb = _load_kitti_timestamps(datadir, 'image_02')
    rgb2imu_sync = sync_data(ts_imu, ts_rgb)

    # --- calibration ---
    c2c = _read_kitti_calib_file(os.path.join(date_dir,
                                              'calib_cam_to_cam.txt'))
    v2c = _read_kitti_calib_file(os.path.join(date_dir,
                                              'calib_velo_to_cam.txt'))
    i2v = _read_kitti_calib_file(os.path.join(date_dir,
                                              'calib_imu_to_velo.txt'))

    def rt(d):
        T = np.eye(4)
        T[:3, :3] = d['R'].reshape(3, 3)
        T[:3, 3] = d['T']
        return T

    T_velo_imu = rt(i2v)
    T_cam0u_velo = rt(v2c)
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c['R_rect_00'].reshape(3, 3)

    def cam_transform(n):
        P = c2c[f'P_rect_0{n}'].reshape(3, 4)
        Tn = np.eye(4)
        Tn[0, 3] = P[0, 3] / P[0, 0]
        T_camN_velo = Tn @ R_rect @ T_cam0u_velo
        K = P[:3, :3]
        return T_camN_velo @ T_velo_imu, K

    T_LI, K2 = cam_transform(2)
    T_RI, K3 = cam_transform(3)
    T_LR = T_LI @ np.linalg.inv(T_RI)
    intrinsic = np.array([K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]])
    intrinsic_right = np.array([K3[0, 0], K3[1, 1], K3[0, 2], K3[1, 2]])

    # --- OXTS packets ---
    oxts_dir = os.path.join(datadir, 'oxts', 'data')
    oxts = np.stack([np.loadtxt(os.path.join(oxts_dir, f))
                     for f in sorted(os.listdir(oxts_dir))])

    T_w_imu = _kitti_oxts_to_pose(oxts)
    T_w_imu[:, :3, 3] -= T_w_imu[0, :3, 3]
    T_w_imu = T_w_imu[rgb2imu_sync]
    poses = np.stack([_se3_from_matrix_np(T) for T in T_w_imu])
    vels_local = oxts[rgb2imu_sync][:, 8:11].astype(np.float32)  # vf, vl, vu
    vels = R.from_quat(poses[:, 3:]).apply(vels_local).astype(np.float32)

    img_dir = os.path.join(datadir, 'image_02', 'data')
    rgbfiles = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]
    img_dir_r = os.path.join(datadir, 'image_03', 'data')
    rgbfiles_right = [os.path.join(img_dir_r, f)
                      for f in sorted(os.listdir(img_dir_r))]

    data = SequenceData(
        rgbfiles=rgbfiles,
        rgb_dts=np.diff(ts_rgb).astype(np.float32),
        rgb_ts=np.asarray(ts_rgb, np.float64) - ts_rgb[0],
        intrinsic=intrinsic.astype(np.float32), poses=poses, vels=vels,
        rgbfiles_right=rgbfiles_right,
        intrinsic_right=intrinsic_right.astype(np.float32),
        right2left_pose=_se3_from_matrix_np(T_LR),
    )
    data.accels = oxts[:, 11:14].astype(np.float32)  # ax, ay, az
    data.gyros = oxts[:, 17:20].astype(np.float32)   # wx, wy, wz
    data.accel_bias = np.zeros(3, np.float32)
    data.gyro_bias = np.zeros(3, np.float32)
    data.imu_dts = np.diff(ts_imu).astype(np.float32)
    data.imu_ts = np.asarray(ts_imu, np.float64) - ts_imu[0]
    data.rgb2imu_sync = rgb2imu_sync
    data.rgb2imu_pose = _se3_from_matrix_np(np.linalg.inv(T_LI))
    data.gravity = 9.81
    data.has_imu = True
    return data


def _load_kitti_timestamps(datapath: str, subfolder: str):
    """Nanosecond timestamp parsing (TrajFolderDataset.py:326-344): the
    last three digits are cut, as the reference does."""
    path = os.path.join(datapath, subfolder, 'timestamps.txt')
    timestamps = []
    with open(path) as f:
        for line in f.readlines():
            t = dt.datetime.strptime(line[:-4], '%Y-%m-%d %H:%M:%S.%f')
            timestamps.append(t.timestamp())
    timestamps.sort()
    return timestamps



LOADERS = {'euroc': load_euroc, 'kitti': load_kitti}
