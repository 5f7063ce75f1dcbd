"""TartanVO front-end: VONet forward, de-normalization, stereo metric-scale
recovery and the KITTI frame conversion.

Counterpart of ``islam_tpu/models/tartanvo.py`` for the paths the presets
run: the scale from stereo disparity and flow, with the Sobel edge mask in
place of the reference's cv2.Canny round-trip, or from the ground truth
(``--use-gt-scale``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from islam_tpu_torch import lie
from islam_tpu_torch.models.layers import init_weights_, resize_bilinear
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.ops.geometry import edge_mask, scale_from_disp_flow_batch
from islam_tpu_torch.transformation import cvt_se3, tartan2kitti

# Output de-normalization (TartanVO.py:26): trained pose targets were divided
# by this std, so predictions are scaled back.
POSE_STD = (0.13, 0.13, 0.13, 0.013, 0.013, 0.013)

DISP_TH = {"kitti": 5.0, "tartanair": 1.0, "euroc": 1.0}


def init_model(height: int = 448, width: int = 640, seed: int = 0,
               device="cuda") -> VONet:
    """A VONet for (height, width) inputs with weights drawn from ``seed``."""
    model = init_weights_(VONet(height, width), seed)
    return model.to(device)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _bf16(x):
    return (x.to(torch.bfloat16)
            if x is not None and x.dtype == torch.float32 else x)


def forward(model: VONet, img0, img1, img0_norm, img0_r_norm, intrinsic,
            intrinsic_calib, baseline, frames=None, datatype: str = "kitti",
            use_kitti_coord: bool = True, correct_scale: bool = False,
            gt_motion=None, frozen_bn_eval: bool = False,
            bf16: bool = False) -> Dict[str, Any]:
    """TartanVO forward (TartanVO.py:90-198).  Images NHWC.

    The translation's scale comes from stereo disparity and flow, or, with
    ``correct_scale`` (``--use-gt-scale``), from the ground-truth motion
    rows ``gt_motion`` (B, 7) (TartanVO.py:184-190).  ``frozen_bn_eval``
    runs the stereo net's BatchNorms on their running stats.  ``bf16``
    (``--bf16``) runs the networks in bfloat16, as the JAX package does
    (islam_tpu/models/tartanvo.py:89-107): every float32 parameter and
    buffer, and the network inputs, are cast at call time, and the flow,
    disparity and pose are cast back to float32 before the geometry.  The
    casts are differentiable, so a 'vo' gradient reaches the float32 pose
    head.  Returns a dict with 'motion' (B, 7) SE3 rows and, for the stereo
    scale, its extras (flow (B, 2, h, w) and disp in pixels, mask, depth,
    depth_mask, scale, and 'intrinsic', the first frame's [fx, fy, cx, cy]
    at the 1/4 scale).
    """
    net_in = [_nchw(x) for x in (img0, img1, img0_norm, img0_r_norm,
                                 intrinsic)]
    kw = {"frames": None if frames is None else _nchw(frames),
          "frozen_bn_eval": frozen_bn_eval}
    if bf16:
        state = {k: _bf16(v) for k, v in (*model.named_parameters(),
                                          *model.named_buffers())}
        kw["frames"] = _bf16(kw["frames"])
        flow, disp, pose = (t.float() for t in torch.func.functional_call(
            model, state, tuple(_bf16(x) for x in net_in), kw))
    else:
        flow, disp, pose = model(*net_in, **kw)
    pose = pose * lie.constant(POSE_STD, pose.dtype, pose.device)
    trans = pose[:, :3] / torch.clamp(
        torch.linalg.norm(pose[:, :3], dim=1, keepdim=True), min=1e-12)
    res: Dict[str, Any] = {}
    if correct_scale:
        scale = torch.linalg.norm(gt_motion[:, :3], dim=1)
    else:
        flow = flow.detach() * 5.0               # TartanVO.py:122
        disp = disp.detach() * (50.0 / 4.0)      # TartanVO.py:126
        pose_ENU = tartan2kitti(pose)  # ENU conversion for image geometry
        img_small = resize_bilinear(_nchw(img0), flow.shape[-2:],
                                    align_corners=False)
        edge = edge_mask(img_small)
        scale, depth, mask, depth_mask = scale_from_disp_flow_batch(
            disp, flow, pose_ENU, intrinsic_calib / 4.0, baseline,
            mask=edge, disp_th=DISP_TH[datatype])
        res = {"flow": flow, "disp": disp, "mask": mask, "depth": depth,
               "depth_mask": depth_mask, "scale": scale,
               "intrinsic": intrinsic_calib[0] / 4.0}
    pose = torch.cat([trans * scale[:, None], pose[:, 3:]], dim=1)
    motion = tartan2kitti(pose) if use_kitti_coord else cvt_se3(pose)
    res["motion"] = motion.data
    return res
