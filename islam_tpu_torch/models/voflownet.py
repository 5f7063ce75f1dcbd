"""VOFlowRes pose-regression head, NCHW.

Counterpart of ``islam_tpu/models/voflownet.py`` and the reference's
Network/VOFlowNet.py with intrinsic=True.  The main path (config=1,
down_scale=True, stereo=0): a ResNet-style embedding of cat(flow,
intrinsic ray map), flattened in torch's NCHW order (docs/PARITY.md C10),
then separate 3-layer MLP heads for translation and rotation.  Configs 0,
2 and 3 change the embedding's widths and depths (config 3 mean-pools its
last map before the heads); down_scale=False keeps all seven of its layers
instead of the last five.  The multi-camera variant
(stereo=2.1/2.2, VOFlowNet.py:196-218) embeds two flows, encodes the
extrinsic, and regresses the translation from both and the rotation from
the second.
"""

from __future__ import annotations

import math

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


# (planes, blocks) of the embedding's seven layers per config
# (VOFlowNet.py:110-157); configs 1 and 2 are the same.  down_scale=True
# keeps the last five.
_CONFIG_LAYERS = {
    0: ((32, 2), (64, 2), (64, 3), (64, 3), (128, 3), (128, 3), (128, 3)),
    1: ((32, 2), (64, 2), (64, 3), (128, 4), (128, 6), (256, 7), (256, 3)),
    3: ((32, 3), (64, 4), (128, 7), (128, 9), (256, 9), (256, 5), (512, 3)),
}


def _layers(config: int = 1, down_scale: bool = True):
    layers = _CONFIG_LAYERS[1 if config == 2 else config]
    return layers[2:] if down_scale else layers


def _conv_out(n: int) -> int:
    return (n - 1) // 2 + 1  # k=3, s=2, p=1


def flat_features(height: int, width: int, config: int = 1,
                  down_scale: bool = True) -> int:
    """Width of the flattened embedding for a (height, width) input; config
    3 mean-pools the last feature map, so only its channels remain."""
    layers = _layers(config, down_scale)
    if config == 3:
        return layers[-1][0]
    h, w = _conv_out(height), _conv_out(width)
    for _ in layers:
        h, w = _conv_out(h), _conv_out(w)
    return layers[-1][0] * h * w


def linear_relu(cin, cout):
    return nn.Sequential(nn.Linear(cin, cout), nn.ReLU())


def _feature_embedding(config=1, down_scale=True):
    blocks = [conv_relu(4, 32, 3, 2, 1), conv_relu(32, 32, 3, 1, 1),
              conv_relu(32, 32, 3, 1, 1)]
    cin = 32
    for planes, n in _layers(config, down_scale):
        # the stride-2 first block always carries the 1x1 downsample
        blocks.append(nn.Sequential(
            BasicBlock(cin, planes, 2, True),
            *[BasicBlock(planes, planes, 1, False) for _ in range(1, n)]))
        cin = planes
    return nn.Sequential(*blocks)


def _head(nf):
    return nn.Sequential(linear_relu(nf, 128), linear_relu(128, 32),
                         nn.Linear(32, 3))


def _encode_pose_sincos(x: torch.Tensor, L: int = 10) -> torch.Tensor:
    """Sin/cos encoding of (B, n) poses (VOFlowNet.py:173-177): (B, 2 L n),
    the sines of 2^l pi x for l < L, then the cosines."""
    c = (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)) * math.pi
    y = c.reshape(1, -1, 1) * x[:, None, :]
    return torch.cat([torch.sin(y), torch.cos(y)], dim=1).reshape(
        x.shape[0], -1)


class VOFlowRes(nn.Module):
    """Input (B, 4, h, w) = cat(flow, intrinsic layer) at 1/4 resolution;
    output (B, 6) = [trans, rot], normalized by POSE_STD.

    ``stereo`` 2.1 or 2.2: input (B, 6, h, w) = cat(flow AB, flow AC,
    intrinsic layer) and an (B, 6) ``extrinsic``.  Channels (0, 1, 4, 5)
    and (2, 3, 4, 5) are embedded by ``feat_net`` (2.1) or by ``feat_net2``
    and ``feat_net`` (2.2); ``extrinsic_encoder_layers`` Linear-ReLU
    layers of 128 (``extrinsic_fc1``, ...) or, at 0, the sin/cos encoding
    encode the extrinsic; ``fcAB_trans``, ``fcAC_trans`` and the
    translation head (``trans_head_fc1``, ``trans_head_mid0``, ...,
    ``trans_head_fc2``, ``trans_head_fc3``; ``trans_head_layers`` in all)
    give the translation, ``voflow_rot`` on the AC embedding the rotation.
    ``config`` and ``down_scale`` shape the embedding(s), as above.
    """

    def __init__(self, height: int, width: int, stereo: float = 0,
                 extrinsic_encoder_layers: int = 2,
                 trans_head_layers: int = 3, config: int = 1,
                 down_scale: bool = True):
        super().__init__()
        self.stereo = stereo
        self.config = config
        self.feat_net = _feature_embedding(config, down_scale)
        nf = flat_features(height, width, config, down_scale)
        if stereo not in (2.1, 2.2):
            self.voflow_trans = _head(nf)
            self.voflow_rot = _head(nf)
            return
        if stereo == 2.2:
            self.feat_net2 = _feature_embedding(config, down_scale)
        self.extrinsic_encoder_layers = extrinsic_encoder_layers
        for i in range(extrinsic_encoder_layers):
            setattr(self, f"extrinsic_fc{i + 1}",
                    linear_relu(6 if i == 0 else 128, 128))
        self.fcAB_trans = linear_relu(nf, 128)
        self.fcAC_trans = linear_relu(nf, 128)
        ne = 128 if extrinsic_encoder_layers else _encode_pose_sincos(
            torch.zeros(1, 6)).shape[1]
        self.trans_head_fc1 = linear_relu(256 + ne, 128)
        self.trans_head_layers = trans_head_layers
        for i in range(trans_head_layers - 3):
            setattr(self, f"trans_head_mid{i}", linear_relu(128, 128))
        self.trans_head_fc2 = linear_relu(128, 32)
        self.trans_head_fc3 = nn.Linear(32, 3)
        self.voflow_rot = _head(nf)

    def _flatten(self, feat):
        """NCHW flatten; config 3 mean-pools the map first
        (islam_tpu/models/voflownet.py:124-129)."""
        if self.config == 3:
            feat = feat.mean(dim=(2, 3), keepdim=True)
        return feat.flatten(1)

    def forward(self, x, extrinsic=None):
        if self.stereo in (2.1, 2.2):
            return self._forward_multicam(x, extrinsic)
        feat = self._flatten(self.feat_net(x))
        return torch.cat([self.voflow_trans(feat), self.voflow_rot(feat)],
                         dim=1)

    def _forward_multicam(self, x, extrinsic):
        """islam_tpu/models/voflownet.py:151-187."""
        x_ab, x_ac = x[:, [0, 1, 4, 5]], x[:, [2, 3, 4, 5]]
        net_ab = self.feat_net2 if self.stereo == 2.2 else self.feat_net
        feat_ab = self._flatten(net_ab(x_ab))
        feat_ac = self._flatten(self.feat_net(x_ac))
        if self.extrinsic_encoder_layers:
            e = extrinsic
            for i in range(self.extrinsic_encoder_layers):
                e = getattr(self, f"extrinsic_fc{i + 1}")(e)
        else:
            e = _encode_pose_sincos(extrinsic)
        t = torch.cat([self.fcAC_trans(feat_ac), self.fcAB_trans(feat_ab), e],
                      dim=1)
        t = self.trans_head_fc1(t)
        for i in range(self.trans_head_layers - 3):
            t = getattr(self, f"trans_head_mid{i}")(t)
        t = self.trans_head_fc3(self.trans_head_fc2(t))
        return torch.cat([t, self.voflow_rot(feat_ac)], dim=1)
