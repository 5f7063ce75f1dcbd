"""StereoNet7 disparity network with its PSM submodules, NCHW.

Counterpart of ``islam_tpu/models/stereonet.py`` and the reference's
Network/StereoNet7.py, Network/PSM/submodule.py and Network/PSM/hourglass.py,
with their module names, so the state-dict keys are the reference's.  The
shared feature extractor runs on the L/R images stacked along the batch, as
the reference does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from islam_tpu_torch.models.layers import (BatchNorm, ClampedAvgPool, ConvT2d,
                                           resize_bilinear,
                                           use_running_average)


def convbn(cin, cout, kernel_size, stride, pad, dilation):
    """PSM convbn (submodule.py:10-13): conv (no bias) + BatchNorm."""
    pad = dilation if dilation > 1 else pad
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel_size, stride, pad, dilation, bias=False),
        BatchNorm(cout))


class PSMBasicBlock(nn.Module):
    """PSM BasicBlock (submodule.py:22-43)."""

    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(cin, planes, 3, stride, 1, 1),
                                   nn.ReLU())
        self.conv2 = convbn(planes, planes, 3, 1, 1, 1)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, 0, bias=False),
            BatchNorm(planes)) if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


class FeatureExtraction(nn.Module):
    """PSM feature_extraction (submodule.py:66-155).  StereoNet7 builds it
    with bigger=True, last_planes=64, middleblock=3 (1/2-scale features);
    the PSMNets with bigger=False, last_planes=32, middleblock=16 (1/4)."""

    def __init__(self, last_planes: int = 64, bigger: bool = True,
                 middleblock: int = 3):
        super().__init__()
        self.bigger = bigger
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU(),
            convbn(32, 32, 3, 1, 1, 1), nn.ReLU())

        def layer(cin, planes, blocks, stride):
            down = stride != 1 or cin != planes
            return nn.Sequential(
                PSMBasicBlock(cin, planes, stride, down),
                *[PSMBasicBlock(planes, planes, 1, False)
                  for _ in range(1, blocks)])

        self.layer1 = layer(32, 32, 3, 1)
        self.layer2 = layer(32, 64, middleblock, 2)
        self.layer3 = layer(64, 128, 3, 1)
        self.layer4 = layer(128, 128, 3, 1)
        for i, pool in ((1, 64), (2, 32), (3, 16), (4, 8)):
            setattr(self, f"branch{i}", nn.Sequential(
                ClampedAvgPool(pool), convbn(128, 32, 1, 1, 0, 1),
                nn.ReLU()))
        self.lastconv = nn.Sequential(
            convbn(352 if bigger else 320, 128, 3, 1, 1, 1), nn.ReLU(),
            nn.Conv2d(128, last_planes, 1, 1, 0, bias=False))

    def forward(self, x):
        out = self.firstconv(x)
        output_0 = self.layer1(out)
        output_raw = self.layer2(output_0)
        output_skip = self.layer4(self.layer3(output_raw))
        hw = output_skip.shape[-2:]
        bs = [resize_bilinear(getattr(self, f"branch{i}")(output_skip), hw,
                              align_corners=True) for i in (4, 3, 2, 1)]
        feat = torch.cat([output_raw, output_skip, *bs], dim=1)
        if self.bigger:
            feat = resize_bilinear(feat, (hw[0] * 2, hw[1] * 2),
                                   align_corners=True)
            feat = torch.cat([feat, output_0], dim=1)
        return self.lastconv(feat)


class HGConv(nn.Module):
    """hourglass.py Conv: conv with bias (the batch norm is unused here)."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, 1, (kernel_size - 1) // 2)

    def forward(self, x):
        return self.conv(x)


class Residual(nn.Module):
    """hourglass.py:27-52."""

    def __init__(self, cin, cout):
        super().__init__()
        self.skip_layer = HGConv(cin, cout, 1) if cin != cout else None
        self.conv1 = HGConv(cin, cout // 2, 1)
        self.conv2 = HGConv(cout // 2, cout // 2, 3)
        self.conv3 = HGConv(cout // 2, cout, 1)

    def forward(self, x):
        residual = x if self.skip_layer is None else self.skip_layer(x)
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        out = self.conv3(F.relu(out))
        return out + residual


class Hourglass(nn.Module):
    """hourglass.py:54-77 (recursive, bilinear upsample)."""

    def __init__(self, n, f, increase=0):
        super().__init__()
        nf = f + increase
        self.up1 = Residual(f, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf)
        self.low3 = Residual(nf, nf)

    def forward(self, x):
        up1 = self.up1(x)
        low3 = self.low3(self.low2(F.max_pool2d(up1, 2)))
        return up1 + resize_bilinear(low3, up1.shape[-2:], align_corners=False)


class SSP(nn.Module):
    """StereoNet7.py:16-51 spatial pyramid pooling."""

    def __init__(self, channels):
        super().__init__()
        for i, pool in ((1, 64), (2, 32), (3, 16), (4, 8)):
            setattr(self, f"branch{i}", nn.Sequential(
                ClampedAvgPool(pool), nn.Conv2d(channels, channels // 4, 1),
                nn.ReLU()))

    def forward(self, x):
        hw = x.shape[-2:]
        bs = [resize_bilinear(getattr(self, f"branch{i}")(x), hw,
                              align_corners=False) for i in (4, 3, 2, 1)]
        return torch.cat([x, *bs], dim=1)


class StereoNet7(nn.Module):
    """Input (B, 6, H, W) = cat(img0_norm, img0_r_norm); output disparity
    (B, 1, H, W), or with ``quarter_output`` only its rows/cols 0, 4, 8, ...
    (exactly torch's nearest x1/4 downsample that VONet applies, computed
    without the full-resolution head).  ``frozen_bn_eval`` normalises every
    BatchNorm by its running stats (islam_tpu/models/stereonet.py:207-217).
    Returns (disp, None)."""

    def __init__(self, quarter_output: bool = False):
        super().__init__()
        self.feature_extraction = FeatureExtraction()
        self.conv_c0 = nn.Conv2d(134, 64, 3, 1, 1)
        self.conv_c1 = Hourglass(2, 64, 0)
        self.conv_c2 = Hourglass(2, 64, 0)
        self.conv_c2_SSP = SSP(64)
        self.conv_c3 = Hourglass(2, 128, 64)
        self.conv_c4 = Hourglass(2, 192, 64)
        self.conv_c5 = nn.Conv2d(256, 384, 3, 1, 1)
        self.conv_c6 = nn.Conv2d(384, 512, 3, 1, 1)
        self.conv_c6_2 = nn.Conv2d(512, 512, 3, 1, 1)
        self.deconv_c7_2 = ConvT2d(512, 512, 4, 2, 1)
        self.deconv_c7 = ConvT2d(896, 320, 4, 2, 1)
        self.deconv_c8 = ConvT2d(576, 192, 4, 2, 1)
        self.conv_c8 = Hourglass(2, 192, 0)
        self.deconv_c9 = ConvT2d(384, 128, 4, 2, 1)
        self.conv_c9 = Hourglass(2, 128, 0)
        self.deconv_c10 = ConvT2d(256, 64, 4, 2, 1)
        self.conv_c10 = Hourglass(2, 64, 0)
        self.deconv_c11 = ConvT2d(128, 64, 4, 2, 1,
                                  out_stride=4 if quarter_output else 1)
        self.conv_c12 = nn.Conv2d(64, 16, 1, 1, 0)
        self.conv_c13 = nn.Conv2d(16, 1, 1, 1, 0)

    def forward(self, x, frozen_bn_eval: bool = False):
        use_running_average(self, frozen_bn_eval)
        B, C, H, W = x.shape
        x1 = self.feature_extraction(
            torch.cat([x[:, :C // 2], x[:, C // 2:]], dim=0))
        x2 = resize_bilinear(x, (H // 2, W // 2), align_corners=False)
        x = self.conv_c0(torch.cat([x1[:B], x1[B:], x2], dim=1))
        cat0 = self.conv_c1(x)                                   # 1/2 - 64
        x = F.max_pool2d(self.conv_c2(cat0), 2)                  # 1/4 - 64
        cat1 = self.conv_c2_SSP(x)                               # 1/4 - 128
        cat2 = F.max_pool2d(self.conv_c3(cat1), 2)               # 1/8 - 192
        cat3 = F.max_pool2d(self.conv_c4(cat2), 2)               # 1/16 - 256
        cat4 = F.max_pool2d(F.relu(self.conv_c5(cat3)), 2)       # 1/32 - 384
        x = F.max_pool2d(F.relu(self.conv_c6(cat4)), 2)          # 1/64 - 512
        x = F.relu(self.conv_c6_2(x))

        x = F.relu(self.deconv_c7_2(x))                          # 1/32
        x = F.relu(self.deconv_c7(torch.cat([x, cat4], dim=1)))  # 1/16
        x = F.relu(self.deconv_c8(torch.cat([x, cat3], dim=1)))  # 1/8
        x = self.conv_c8(x)
        x = F.relu(self.deconv_c9(torch.cat([x, cat2], dim=1)))  # 1/4
        x = self.conv_c9(x)
        x = F.relu(self.deconv_c10(torch.cat([x, cat1], dim=1)))  # 1/2
        x = self.conv_c10(x)
        x = F.relu(self.deconv_c11(torch.cat([x, cat0], dim=1)))  # 1/1
        x = F.relu(self.conv_c12(x))
        return self.conv_c13(x), None


def stereo_loss(output, target, criterion, mask=None, unc=None, lamb=1.0):
    """Disparity supervision (StereoNet7.py:148-167; stereonet.py:263-276):
    the masked criterion, or the uncertainty-weighted L1.  Returns (the
    criterion's loss, None) or (the uncertainty loss, mean |output -
    target|)."""
    if mask is not None:
        w = mask.to(output.dtype)
        output = output * w
        target = target * w
        if unc is not None:
            unc = unc * w
    if unc is None:
        return criterion(output, target), None
    diff = (output - target).abs()
    loss_unc = torch.mean(torch.exp(-unc) * diff + unc * lamb)
    return loss_unc / (1.0 + lamb), diff.mean()
