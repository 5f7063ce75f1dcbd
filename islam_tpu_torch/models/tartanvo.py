"""TartanVO front-end: VONet forward, de-normalization, stereo metric-scale
recovery and the KITTI frame conversion.

Counterpart of ``islam_tpu/models/tartanvo.py``: the scale from stereo
disparity and flow (the network's or a precomputed flow), with the Sobel
edge mask in place of the reference's cv2.Canny round-trip, from the ground
truth (``--use-gt-scale``), or given by the caller; and the ``TartanVO``
class with ``pred_flow`` and ``join_flow``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from islam_tpu_torch import lie
from islam_tpu_torch.models.layers import init_weights_, resize_bilinear
from islam_tpu_torch.models.vonet import VONet
from islam_tpu_torch.ops import warp
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
            bf16: bool = False, given_scale=None, precalc_flow=None,
            concat_free: bool = False) -> Dict[str, Any]:
    """TartanVO forward (TartanVO.py:90-198).  Images NHWC.

    The translation's scale is ``given_scale`` (B,) where given, else, with
    ``correct_scale`` (``--use-gt-scale``), the norm of the ground-truth
    motion rows ``gt_motion`` (B, 7) (TartanVO.py:184-190), else it comes
    from stereo disparity and flow: ``precalc_flow`` (B, h, w, 2) in pixels
    at the 1/4 scale where given (TartanVO.py:121-124), else the network's.
    ``concat_free`` runs the flow net's decoders without their concat
    buffers (the same function).  ``frozen_bn_eval``
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
          "frozen_bn_eval": frozen_bn_eval, "concat_free": concat_free}
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
    if given_scale is not None:
        scale = given_scale.reshape(-1).to(pose.dtype)
    elif correct_scale:
        scale = torch.linalg.norm(gt_motion[:, :3], dim=1)
    else:
        flow = (_nchw(precalc_flow) if precalc_flow is not None
                else flow.detach() * 5.0)        # TartanVO.py:122
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


def _tensor(x, device):
    """An array or tensor on ``device``; float64 arrays become float32, as
    ``jnp.asarray`` makes them."""
    if torch.is_tensor(x):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype == np.float64 or not x.flags.writeable:
        x = x.astype(np.float32 if x.dtype == np.float64 else x.dtype)
    return torch.as_tensor(x, device=device)


class TartanVO:
    """The reference's TartanVO class (TartanVO.py:16-239,
    islam_tpu/models/tartanvo.py:167-223) over a ``VONet``: ``model``, or
    one of (``height``, ``width``) with weights drawn from ``seed``, on
    ``device``.  ``correct_scale`` takes the scale from the sample's
    ground-truth 'motion'.  ``fix_parts`` is kept and read nowhere, as in
    the JAX package: the trainer freezes parts (``--fix-model-parts``)."""

    def __init__(self, model: VONet = None, height: int = 448,
                 width: int = 640, seed: int = 0, correct_scale: bool = True,
                 fix_parts: Tuple[str, ...] = (),
                 use_kitti_coord: bool = True, device="cuda"):
        self.device = torch.device(device)
        self.model = (init_model(height, width, seed, self.device)
                      if model is None else model.to(self.device))
        self.correct_scale = correct_scale
        self.fix_parts = tuple(fix_parts)
        self.use_kitti_coord = use_kitti_coord

    def __call__(self, sample: Dict[str, Any], is_train: bool = True,
                 given_scale=None) -> Dict[str, Any]:
        """``forward`` on a collated sample (NHWC arrays or tensors, as
        ``data/dataset.py`` gives them).  A 'flow' entry is the precomputed
        flow; ``is_train`` False normalises the stereo net's BatchNorms by
        their running stats; ``given_scale`` (B,) fixes the scale."""
        datatype = sample.get("datatype", "kitti")
        if isinstance(datatype, (list, tuple)):
            datatype = datatype[0]
        t = {k: _tensor(sample[k], self.device) for k in (
            "img0", "img1", "img0_norm", "img0_r_norm", "intrinsic",
            "intrinsic_calib", "extrinsic", "motion", "flow") if k in sample}
        return forward(
            self.model, t["img0"], t["img1"], t["img0_norm"],
            t["img0_r_norm"], t["intrinsic"], t["intrinsic_calib"],
            torch.linalg.norm(t["extrinsic"][:, :3], dim=1),
            datatype=datatype, use_kitti_coord=self.use_kitti_coord,
            correct_scale=self.correct_scale, gt_motion=t.get("motion"),
            frozen_bn_eval=not is_train,
            given_scale=(None if given_scale is None
                         else _tensor(given_scale, self.device)),
            precalc_flow=t.get("flow"))

    def pred_flow(self, img0, img1) -> torch.Tensor:
        """The finest flow in pixels (x5), (B, h, w, 2) for NHWC images
        (B, H, W, 3), or (h, w, 2) for one (H, W, 3) pair
        (TartanVO.py:201-216)."""
        img0, img1 = _tensor(img0, self.device), _tensor(img1, self.device)
        batched = img0.dim() == 4
        if not batched:
            img0, img1 = img0[None], img1[None]
        with torch.no_grad():
            flow = self.model.flowNet(_nchw(torch.cat([img0, img1], dim=-1)))
        flow = flow[0].permute(0, 2, 3, 1) * 5.0
        return flow if batched else flow[0]

    def join_flow(self, flow_to_join) -> torch.Tensor:
        """Chain (2, H, W) pixel flows into one (TartanVO.py:219-239)."""
        flows = [_tensor(f, self.device) for f in flow_to_join]
        h, w = flows[0].shape[-2:]
        return warp.join_flow(flows, h, w)
