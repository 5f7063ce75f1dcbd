"""Shared fixtures: synthetic sequences and window inputs for tests,
benchmarks and dry runs.

Counterpart of ``islam_tpu/testing.py``.  The transform and the window copy
are the training path's own (``train.make_transform``,
``train.device_batch``).  Tensors go to ``device`` (default ``cuda``).
The PVGO problems of ``tests/test_pvgo.py`` (``make_problem``,
``_perturbed_init`` and its numpy residual, :181) are here as
``pvgo_problem``, ``pvgo_perturbed_init`` and ``pvgo_np_residual``, for
the PyPose replica checks (``tests/test_torch_pypose_replica.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from islam_tpu_torch import lie
from islam_tpu_torch.data.dataset import collate
from islam_tpu_torch.data.synthetic import SyntheticTrajDataset
from islam_tpu_torch.imu.module import IMUModule
from islam_tpu_torch.imu.preintegrator import IMUState
from islam_tpu_torch.pvgo import graph
from islam_tpu_torch.pvgo.pypose_replica import retract_nodes
from islam_tpu_torch.train import device_batch, make_transform
from islam_tpu_torch.transformation import motion2pose

__all__ = ["make_transform", "make_dataset", "make_imu_module",
           "make_step_inputs", "device_batch", "init_state",
           "make_sequences", "SEQ1_CALIB", "unequal_paths", "PVGO_WEIGHTS",
           "pvgo_problem", "pvgo_perturbed_init", "pvgo_np_residual",
           "pvgo_residual"]

# Sequence 1's calibration in the multi-sequence sets (the JAX package's
# tests/test_parallel.py:229-232): another T_BS, gravity and accelerometer
# bias, as KITTI drives of other dates have.
SEQ1_CALIB = {"rgb2imu_pose": np.asarray(
    [0.1, -0.05, 0.2, 0.0, 0.0, 0.1736482, 0.9848078], np.float32),
    "gravity": 9.5,
    "accel_bias": np.asarray([0.05, -0.02, 0.01], np.float32)}


def make_dataset(num_frames: int = 17, height: int = 448, width: int = 640,
                 seed: int = 0) -> SyntheticTrajDataset:
    return SyntheticTrajDataset(
        num_frames=num_frames, height=height, width=width, seed=seed,
        transform=make_transform(height, width))


def make_sequences(seeds, num_frames: int = 17, height: int = 448,
                   width: int = 640):
    """One synthetic sequence per seed (``make_dataset``), the seed-1 one
    on ``SEQ1_CALIB``."""
    datasets = [make_dataset(num_frames, height, width, seed=s)
                for s in seeds]
    for s, ds in zip(seeds, datasets):
        if s == 1:
            for k, v in SEQ1_CALIB.items():
                setattr(ds, k, v)
    return datasets


def make_imu_module(dataset, batch_frames: int = 8, denoise_params=None,
                    device="cuda") -> IMUModule:
    return IMUModule(
        dataset.accels, dataset.gyros, dataset.imu_dts,
        dataset.accel_bias, dataset.gyro_bias, gravity=dataset.gravity,
        rgb2imu_sync=dataset.rgb2imu_sync, denoise_params=denoise_params,
        denoise_accel=True, denoise_gyro=(dataset.datatype != "kitti"),
        batch_frames=batch_frames, device=device)


def init_state(dataset, device="cuda") -> IMUState:
    """The dataset's initial IMU state as float32 tensors on ``device``."""
    init = dataset.imu_init
    return IMUState(*(torch.tensor(np.asarray(init[k]), dtype=torch.float32,
                                   device=device)
                      for k in ("pos", "rot", "vel")))


def make_step_inputs(dataset, imu_module, start: int = 0, B: int = 8,
                     device="cuda"):
    """(batch, imu_win, init_state) for a window of B frame-pairs."""
    sample = collate([dataset[i] for i in range(start, start + B)])
    batch = device_batch(sample, start, device)
    imu_win = imu_module.window_inputs(start, start + B)
    return batch, imu_win, init_state(dataset, device)


def unequal_paths(a, b, path=""):
    """The paths at which two nested states (dicts, lists, tensors,
    numbers) differ bitwise, or []."""
    if torch.is_tensor(a):
        return [] if (torch.is_tensor(b) and a.dtype == b.dtype
                      and a.shape == b.shape
                      and torch.equal(a.cpu(), b.cpu())) else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path + "/keys"]
        return [p for k in a for p in unequal_paths(a[k], b[k],
                                                    f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path + "/len"]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in unequal_paths(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


# ---- PVGO problems for the PyPose replica checks (tests/test_pvgo.py) ----

PVGO_WEIGHTS = (1.0, 0.1, 10.0, 0.1)


def pvgo_problem(noise: float = 0.0, seed: int = 7, B: int = 8):
    """A ground-truth chain of B motions with consistent IMU deltas and VO
    motions with ``noise`` (tests/test_pvgo.py:20-56), fully determined by
    (noise, seed).  Float32 numpy arrays; SE3 rows [t, q]."""
    rng = np.random.default_rng(seed)
    # GT: smooth forward motion with slight rotation
    xi = np.tile(np.asarray([[0.5, 0.02, -0.01, 0.01, 0.03, 0.005]]), (B, 1))
    xi += rng.normal(size=(B, 6)) * 0.01
    gt_motions = lie.se3_exp(torch.tensor(xi, dtype=torch.float32))
    gt_poses = motion2pose(gt_motions).data
    dts = np.full((B,), 0.1, np.float32)
    gt_vels = np.zeros((B + 1, 3), np.float32)
    # velocities that zero the transvel factor: vel = diff / dt
    trans = gt_poses[:, :3].numpy()
    gt_vels[:-1] = (trans[1:] - trans[:-1]) / dts[:, None]
    gt_vels[-1] = gt_vels[-2]
    imu_drots = lie.quat_mul(lie.quat_conj(gt_poses[:-1, 3:]),
                             gt_poses[1:, 3:]).numpy()
    vo_noise = rng.normal(size=(B, 6)) * noise
    vo_motions = lie.se3_mul(gt_motions, lie.se3_exp(
        torch.tensor(vo_noise, dtype=torch.float32)))
    return dict(
        gt_poses=gt_poses.numpy(), gt_vels=gt_vels,
        vo_motions=vo_motions.numpy(),
        links=np.stack([np.arange(B), np.arange(B) + 1], axis=1),
        dts=dts, imu_drots=imu_drots,
        imu_dtrans=((trans[1:] - trans[:-1])
                    - gt_vels[:-1] * dts[:, None]).astype(np.float32),
        imu_dvels=gt_vels[1:] - gt_vels[:-1])


def pvgo_perturbed_init(p, rng, t_noise: float = 0.05, v_noise: float = 0.1):
    """Float64 start nodes and velocities: the ground truth with the
    quaternions renormalized (scipy's ``Rotation.from_quat``, the replica's
    retraction, normalizes; the port's keeps the norm), every translation
    but the first and every velocity perturbed (tests/test_pvgo.py:249-259).
    """
    B = p["links"].shape[0]
    init_nodes = np.asarray(p["gt_poses"], np.float64).copy()
    init_nodes[:, 3:] /= np.linalg.norm(init_nodes[:, 3:], axis=-1,
                                        keepdims=True)
    init_nodes[1:, :3] += rng.normal(size=(B, 3)) * t_noise
    init_vels = np.asarray(p["gt_vels"], np.float64).copy()
    init_vels += rng.normal(size=init_vels.shape) * v_noise
    return init_nodes, init_vels


def _np_mat(rows):
    """SE3 rows [t(3), q(4)] -> (N, 4, 4) homogeneous matrices."""
    rows = np.asarray(rows, np.float64)
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :3] = Rotation.from_quat(rows[:, 3:]).as_matrix()
    T[:, :3, 3] = rows[:, :3]
    return T


def _np_se3_log(T):
    """(N, 4, 4) -> (N, 6) twists [tau, phi] via rotvec + analytic V^-1."""
    phi = Rotation.from_matrix(T[:, :3, :3]).as_rotvec()
    out = np.empty((T.shape[0], 6))
    for i in range(T.shape[0]):
        p = phi[i]
        th = np.linalg.norm(p)
        K = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0.0]])
        if th < 1e-8:
            Vinv = np.eye(3) - 0.5 * K + (1.0 / 12.0) * (K @ K)
        else:
            c = 1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th))
            Vinv = np.eye(3) - 0.5 * K + c * (K @ K)
        out[i, :3] = Vinv @ T[i, :3, 3]
        out[i, 3:] = p
    return out


def pvgo_np_residual(p, weights=PVGO_WEIGHTS, saturate: float = 0.0):
    """(residual, jacobian) in numpy/scipy for the replica, with run_pvgo's
    block order and flattening (tests/test_pvgo.py:181-223); the Jacobian
    is central differences over the 9N tangent under the replica's own
    retraction.  ``saturate`` = a > 0 gives atan(a r) instead of r, whose
    Gauss-Newton steps overshoot, so that trials are rejected."""
    links = np.asarray(p["links"])
    poses_inv = np.linalg.inv(_np_mat(p["vo_motions"]))
    drots_R = Rotation.from_quat(
        np.asarray(p["imu_drots"], np.float64)).as_matrix()
    dtrans = np.asarray(p["imu_dtrans"], np.float64)
    dvels = np.asarray(p["imu_dvels"], np.float64)
    dts = np.asarray(p["dts"], np.float64).reshape(-1, 1)
    w0, w1, w2, w3 = [float(w) for w in weights]

    def residual(nodes, vels):
        r = weighted(nodes, vels)
        return np.arctan(saturate * r) if saturate else r

    def weighted(nodes, vels):
        T = _np_mat(nodes)
        T_inv = np.linalg.inv(T)
        pgerr = _np_se3_log(poses_inv @ T_inv[links[:, 0]] @ T[links[:, 1]])
        adjvelerr = dvels - (vels[1:] - vels[:-1])
        R = T[:, :3, :3]
        rel = np.transpose(drots_R, (0, 2, 1)) @ (
            np.transpose(R[:-1], (0, 2, 1)) @ R[1:])
        imuroterr = Rotation.from_matrix(rel).as_rotvec()
        trans = nodes[:, :3]
        transvelerr = (trans[1:] - trans[:-1]) - (vels[:-1] * dts + dtrans)
        return np.concatenate([
            (pgerr * w0).reshape(-1), (adjvelerr * w1).reshape(-1),
            (imuroterr * w2).reshape(-1), (transvelerr * w3).reshape(-1)])

    def jacobian(nodes, vels, eps=1e-6):
        N = nodes.shape[0]
        D = 9 * N
        cols = []
        for k in range(D):
            d = np.zeros(D)
            d[k] = eps
            xi_p, dv_p = d[:6 * N].reshape(N, 6), d[6 * N:].reshape(N, 3)
            rp = residual(retract_nodes(nodes, xi_p), vels + dv_p)
            rm = residual(retract_nodes(nodes, -xi_p), vels - dv_p)
            cols.append((rp - rm) / (2 * eps))
        return np.stack(cols, axis=1)

    return residual, jacobian


def pvgo_residual(p, weights=PVGO_WEIGHTS, dtype=torch.float64,
                  device="cuda", saturate: float = 0.0):
    """(residual_fn(nodes, vels, inputs), inputs): the port's weighted PVGO
    residual (``pvgo/graph.py``) of problem ``p`` and its tensors, in
    ``dtype`` on ``device``, in the form ``lm_solve_graphed`` takes;
    ``saturate`` as ``pvgo_np_residual``'s."""
    inputs = tuple(torch.tensor(np.asarray(p[k]), device=device,
                                dtype=torch.int64 if k == "links" else dtype)
                   for k in ("links", "vo_motions", "imu_drots",
                             "imu_dtrans", "imu_dvels", "dts"))

    def residual(nodes, vels, tensors):
        blocks = graph.pvgo_residuals(nodes, vels, *tensors)
        r = torch.cat([(b * w).reshape(-1) for b, w in zip(blocks, weights)])
        return torch.atan(saturate * r) if saturate else r

    return residual, inputs
