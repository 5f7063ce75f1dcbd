"""SE(3) frame-convention and trajectory utilities.

Counterpart of ``islam_tpu/transformation.py``: the host-side GT-motion
helper (numpy/scipy), the tensor-side conversions the VO front-end uses, and
the chaining of motions into poses and back.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from islam_tpu_torch import lie
from islam_tpu_torch.lie import SE3


def relative_twists(poses: np.ndarray, links=None, skip: int = 0) -> np.ndarray:
    """Pose rows (N, 7) [pos, quat] -> (L, 6) [R_i^T (p_j - p_i),
    Log(R_i^T R_j)] for each link (i, j) (consecutive pairs by default)."""
    poses = np.asarray(poses)
    if links is None:
        links = [(i, i + skip + 1) for i in range(poses.shape[0] - skip - 1)]
    links = np.asarray(links)
    i, j = links[:, 0], links[:, 1]
    rots = R.from_quat(poses[:, 3:7])
    inv_i = rots[i].inv()
    trans = inv_i.apply(poses[j, :3] - poses[i, :3])
    rotvec = (inv_i * rots[j]).as_rotvec()
    return np.concatenate([trans, rotvec], axis=1)


def cvt_se3(motion) -> SE3:
    """Accept SE3 wrapper, (..., 7) quaternion-pose, or (..., 6) twist.

    The 6-vector convention is cvtSE3_pypose's: [trans, so3] with the
    translation used directly (not V(phi) tau).
    """
    if isinstance(motion, SE3):
        return motion
    if motion.shape[-1] == 6:
        return SE3(torch.cat([motion[..., :3], lie.so3_exp(motion[..., 3:])],
                             dim=-1))
    if motion.shape[-1] == 7:
        return SE3(motion)
    raise ValueError(
        f"Not a valid SE3/se3 input with trailing dim {motion.shape[-1]}")


# NED (TartanAir) <-> camera-forward (KITTI) axis permutation, a pure
# rotation conjugation.
_T2K = np.array(
    [[0.0, 1.0, 0.0, 0.0],
     [0.0, 0.0, 1.0, 0.0],
     [1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]],
    dtype=np.float32,
)


def tartan2kitti(motion) -> SE3:
    motion = cvt_se3(motion)
    T = SE3.from_matrix(lie.constant(_T2K, motion.dtype,
                                     motion.data.device))
    return T @ motion @ T.Inv()


def motion2pose(motion, T0=None) -> SE3:
    """Chain relative motions into poses: pose[0] = T0 (identity by
    default), pose[i+1] = pose[i] @ motion[i] (transformation.py:100-114).
    A log-depth prefix product, as the JAX package's associative scan."""
    motion = cvt_se3(motion)
    T0 = (lie.se3_identity(dtype=motion.dtype, device=motion.data.device)
          if T0 is None else cvt_se3(T0).data)
    chain = torch.cat([T0[None], motion.data])
    return SE3(lie.prefix_product(lie.se3_mul, chain))


def pose2motion_se3(pose) -> SE3:
    """Relative motions between consecutive poses (transformation.py:
    116-124)."""
    pose = cvt_se3(pose)
    return SE3(lie.se3_mul(lie.se3_inv(pose.data[:-1]), pose.data[1:]))
