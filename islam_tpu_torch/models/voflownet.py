"""VOFlowRes pose-regression head, NCHW.

Counterpart of ``islam_tpu/models/voflownet.py`` and the reference's
Network/VOFlowNet.py for the main path: config=1, down_scale=True,
intrinsic=True, stereo=0.  A ResNet-style embedding of cat(flow, intrinsic
ray map), flattened in torch's NCHW order (docs/PARITY.md C10), then
separate 3-layer MLP heads for translation and rotation.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``.  A bfloat16 input on the CPU is convolved in float32
    and the output rounded to bfloat16, which is what a bfloat16 convolution
    computes (float32 sums, one rounding): torch's CPU bfloat16 kernel
    returns a wrong weight gradient (NaN or ~1e33) for a 3x3, stride-2
    convolution of a 1x1 input, which the last layers of this head see at
    64x128 inputs.  On the card the convolution runs in bfloat16."""

    def forward(self, x):
        if x.dtype != torch.bfloat16 or x.device.type != "cpu":
            return super().forward(x)
        bias = None if self.bias is None else self.bias.float()
        return self._conv_forward(x.float(), self.weight.float(),
                                  bias).to(torch.bfloat16)


def conv_relu(cin, cout, kernel_size=3, stride=2, padding=1, dilation=1):
    return nn.Sequential(Conv2d(cin, cout, kernel_size, stride, padding,
                                dilation), nn.ReLU())


class BasicBlock(nn.Module):
    """VOFlowNet.py:20-39: conv+relu, conv, optional 1x1 downsample, add,
    relu."""

    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = conv_relu(cin, planes, 3, stride, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.downsample = (Conv2d(cin, planes, 1, stride, 0)
                           if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


# config 1: (planes, blocks) of the layers kept with down_scale=True
_LAYERS = ((64, 3), (128, 4), (128, 6), (256, 7), (256, 3))


def _conv_out(n: int) -> int:
    return (n - 1) // 2 + 1  # k=3, s=2, p=1


def flat_features(height: int, width: int) -> int:
    """Width of the flattened embedding for a (height, width) input."""
    h, w = _conv_out(height), _conv_out(width)
    for _ in _LAYERS:
        h, w = _conv_out(h), _conv_out(w)
    return _LAYERS[-1][0] * h * w


class VOFlowRes(nn.Module):
    """Input (B, 4, h, w) = cat(flow, intrinsic layer) at 1/4 resolution;
    output (B, 6) = [trans, rot], normalized by POSE_STD."""

    def __init__(self, height: int, width: int):
        super().__init__()
        blocks = [conv_relu(4, 32, 3, 2, 1), conv_relu(32, 32, 3, 1, 1),
                  conv_relu(32, 32, 3, 1, 1)]
        cin = 32
        for planes, n in _LAYERS:
            # the stride-2 first block always carries the 1x1 downsample
            blocks.append(nn.Sequential(
                BasicBlock(cin, planes, 2, True),
                *[BasicBlock(planes, planes, 1, False) for _ in range(1, n)]))
            cin = planes
        self.feat_net = nn.Sequential(*blocks)
        nf = flat_features(height, width)

        def head():
            return nn.Sequential(nn.Sequential(nn.Linear(nf, 128), nn.ReLU()),
                                 nn.Sequential(nn.Linear(128, 32), nn.ReLU()),
                                 nn.Linear(32, 3))

        self.voflow_trans = head()
        self.voflow_rot = head()

    def forward(self, x):
        feat = self.feat_net(x).flatten(1)
        return torch.cat([self.voflow_trans(feat), self.voflow_rot(feat)],
                         dim=1)
