"""PWC-DC optical-flow network (without uncertainty heads), NCHW.

Counterpart of ``islam_tpu/models/pwcnet.py`` and the reference's
Network/PWC/PWCNet.py: 6-level siamese conv pyramid, per-level warp and
local correlation (the CUDA kernel of ``ops/correlation.py`` on the card),
DenseNet-style decoders, deconv upsampling, the dilated context refiner.
Outputs 5 scales of flow, finest first.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from islam_tpu_torch.models.layers import ConvT2d, leaky_relu
from islam_tpu_torch.ops.correlation import correlation
from islam_tpu_torch.ops.warp import flow_warp


def conv_leaky(cin, cout, kernel_size=3, stride=1, padding=1, dilation=1):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel_size, stride, padding,
                                   dilation), nn.LeakyReLU(0.1))


_DEC_WIDTHS = (128, 128, 96, 64, 32)
_NCORR = 81  # (2 md + 1)^2 at md = 4


class PWCDCNet(nn.Module):
    def __init__(self):
        super().__init__()
        # Siamese pyramid (PWCNet.py:78-95)
        self.conv1a = conv_leaky(3, 16, 3, 2)
        self.conv1aa = conv_leaky(16, 16)
        self.conv1b = conv_leaky(16, 16)
        self.conv2a = conv_leaky(16, 32, 3, 2)
        self.conv2aa = conv_leaky(32, 32)
        self.conv2b = conv_leaky(32, 32)
        self.conv3a = conv_leaky(32, 64, 3, 2)
        self.conv3aa = conv_leaky(64, 64)
        self.conv3b = conv_leaky(64, 64)
        self.conv4a = conv_leaky(64, 96, 3, 2)
        self.conv4aa = conv_leaky(96, 96)
        self.conv4b = conv_leaky(96, 96)
        self.conv5a = conv_leaky(96, 128, 3, 2)
        self.conv5aa = conv_leaky(128, 128)
        self.conv5b = conv_leaky(128, 128)
        self.conv6aa = conv_leaky(128, 196, 3, 2)
        self.conv6a = conv_leaky(196, 196)
        self.conv6b = conv_leaky(196, 196)

        # Decoders (PWCNet.py:107-153): level l's input is the correlation
        # plus, below level 6, the pyramid feature and the two upsampled
        # 2-channel maps.
        feat = {6: 0, 5: 128, 4: 96, 3: 64, 2: 32}
        for lvl in (6, 5, 4, 3, 2):
            cin = _NCORR + feat[lvl] + (4 if lvl < 6 else 0)
            for i, w in enumerate(_DEC_WIDTHS):
                setattr(self, f"conv{lvl}_{i}", conv_leaky(cin, w))
                cin += w
            setattr(self, f"predict_flow{lvl}", nn.Conv2d(cin, 2, 3, 1, 1))
            if lvl > 2:
                setattr(self, f"deconv{lvl}", ConvT2d(2, 2, 4, 2, 1))
                setattr(self, f"upfeat{lvl}", ConvT2d(cin, 2, 4, 2, 1))

        # Dilated context network (PWCNet.py:155-161)
        self.dc_conv1 = conv_leaky(cin, 128, 3, 1, 1, 1)
        self.dc_conv2 = conv_leaky(128, 128, 3, 1, 2, 2)
        self.dc_conv3 = conv_leaky(128, 128, 3, 1, 4, 4)
        self.dc_conv4 = conv_leaky(128, 96, 3, 1, 8, 8)
        self.dc_conv5 = conv_leaky(96, 64, 3, 1, 16, 16)
        self.dc_conv6 = conv_leaky(64, 32, 3, 1, 1, 1)
        self.dc_conv7 = nn.Conv2d(32, 2, 3, 1, 1)

    def _corr(self, f1, f2):
        return leaky_relu(correlation(f1, f2), 0.1)

    def _decode(self, lvl, x):
        """DenseNet-style concat chain (PWCNet.py:208-214)."""
        for i in range(len(_DEC_WIDTHS)):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], dim=1)
        return x

    def _level(self, lvl, x, feat_low1, feat_low2, scale):
        """concate_two_layers (PWCNet.py:216-233): predict, upsample, warp the
        next level's second feature, correlate."""
        flow_high = getattr(self, f"predict_flow{lvl}")(x)
        up_flow = getattr(self, f"deconv{lvl}")(flow_high)
        up_feat = getattr(self, f"upfeat{lvl}")(x)
        warp_feat = flow_warp(feat_low2, up_flow * scale)
        corr = self._corr(feat_low1, warp_feat)
        return torch.cat([corr, feat_low1, up_flow, up_feat], dim=1), flow_high

    def _pyramid(self, im):
        c1 = self.conv1b(self.conv1aa(self.conv1a(im)))
        c2 = self.conv2b(self.conv2aa(self.conv2a(c1)))
        c3 = self.conv3b(self.conv3aa(self.conv3a(c2)))
        c4 = self.conv4b(self.conv4aa(self.conv4a(c3)))
        c5 = self.conv5b(self.conv5aa(self.conv5a(c4)))
        c6 = self.conv6b(self.conv6a(self.conv6aa(c5)))
        return c1, c2, c3, c4, c5, c6

    def forward(self, x: torch.Tensor, shared_frames: bool = False):
        """x: (B, 6, H, W) = cat(img0, img1), or with ``shared_frames``
        (B+1, 3, H, W) consecutive frames: the pyramid runs once per frame
        and pair k correlates frame k with frame k+1.
        Returns (flow2, flow3, flow4, flow5, flow6)."""
        if shared_frames:
            pyr = self._pyramid(x)
            c1s = [c[:-1] for c in pyr]
            c2s = [c[1:] for c in pyr]
        else:
            c1s = self._pyramid(x[:, 0:3])
            c2s = self._pyramid(x[:, 3:6])
        _, c12, c13, c14, c15, c16 = c1s
        _, c22, c23, c24, c25, c26 = c2s

        x = self._decode(6, self._corr(c16, c26))
        x, flow6 = self._level(6, x, c15, c25, 0.625)
        x = self._decode(5, x)
        x, flow5 = self._level(5, x, c14, c24, 1.25)
        x = self._decode(4, x)
        x, flow4 = self._level(4, x, c13, c23, 2.5)
        x = self._decode(3, x)
        x, flow3 = self._level(3, x, c12, c22, 5.0)
        x = self._decode(2, x)
        flow2 = self.predict_flow2(x)

        x = self.dc_conv4(self.dc_conv3(self.dc_conv2(self.dc_conv1(x))))
        x = self.dc_conv6(self.dc_conv5(x))
        flow2 = flow2 + self.dc_conv7(x)
        return flow2, flow3, flow4, flow5, flow6
