"""VONet composite: PWC flow + StereoNet7 disparity + VOFlowRes pose head.

Counterpart of ``islam_tpu/models/vonet.py`` (reference Network/VONet.py).
The stereo head runs with ``quarter_output``, which gives exactly the x1/4
nearest downsample the reference applies to the full-resolution disparity.
The flow and stereo nets run without autograd: only the pose head is ever
trained, and their outputs are detached (tartanvo.py:110-111).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from islam_tpu_torch.models.pwcnet import PWCDCNet
from islam_tpu_torch.models.stereonet import StereoNet7
from islam_tpu_torch.models.voflownet import VOFlowRes


class VONet(nn.Module):
    def __init__(self, height: int = 448, width: int = 640):
        super().__init__()
        self.flowNet = PWCDCNet()
        self.stereoNet = StereoNet7(quarter_output=True)
        self.flowPoseNet = VOFlowRes(height // 4, width // 4)

    def forward(self, img0, img1, img0_norm, img0_r_norm, intrinsic,
                frames=None, frozen_bn_eval: bool = False,
                concat_free: bool = False):
        """All inputs NCHW; ``intrinsic`` is the 1/4-scale 2-channel ray map.
        With ``frames`` (B+1, 3, H, W) of consecutive frames the flow pyramid
        is shared between adjacent pairs (img0/img1 are then not read).
        ``frozen_bn_eval`` runs the stereo net's BatchNorms on their running
        stats (vonet.py:42-44).  ``concat_free`` runs the flow net's
        decoders without their concat buffers (vonet.py:25,36).

        Returns (flow (B, 2, h, w), disp (B, 1, h, w), pose (B, 6)) at
        h, w = H/4, W/4, pose normalized."""
        with torch.no_grad():
            if frames is not None:
                flow = self.flowNet(frames, shared_frames=True,
                                    concat_free=concat_free)[0]
            else:
                flow = self.flowNet(torch.cat([img0, img1], dim=1),
                                    concat_free=concat_free)[0]
            disp, _ = self.stereoNet(torch.cat([img0_norm, img0_r_norm], dim=1),
                                     frozen_bn_eval=frozen_bn_eval)
        pose = self.flowPoseNet(torch.cat([flow, intrinsic], dim=1))
        return flow, disp, pose
