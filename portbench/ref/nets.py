"""The plain reference of the VO networks: PWC-Net (with a plain
correlation), StereoNet7 and the VOFlowRes pose head, in float32 torch ops
and nothing else.

The networks are TartanVO's (iSLAM, RA-L 2024, arXiv 2306.07894; the
reference's Network/PWC, Network/StereoNet7.py, Network/VOFlowNet.py), with
their state-dict keys, so one state dict loads into this reference and into
the program.  What differs from the program on purpose:

- the correlation is the textbook sum over the 81 shifted products
  (``correlation``), with no kernel;
- the stereo net's last three layers run at full resolution and the
  disparity is then taken at every fourth row and column (the x1/4 nearest
  downsample of Network/VONet.py), where the program computes only those
  outputs;
- the flow pyramid runs once per frame of the window's B + 1 consecutive
  frames, and pair k correlates frame k with frame k + 1 (the program does
  the same; the reference's network ran each pair's two frames).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

MD = 4                 # correlation displacement: (2 MD + 1)^2 = 81 shifts
DEC_WIDTHS = (128, 128, 96, 64, 32)
N_CORR = (2 * MD + 1) ** 2


def correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, 81, H, W): the mean over channels of f1 times
    f2 shifted by (dy, dx) in [-4, 4]^2, zero outside, dy major."""
    B, C, H, W = f1.shape
    f2p = F.pad(f2, (MD, MD, MD, MD))
    outs = [torch.sum(f1 * f2p[:, :, dy:dy + H, dx:dx + W], dim=1) / C
            for dy in range(2 * MD + 1) for dx in range(2 * MD + 1)]
    return torch.stack(outs, dim=1)


def flow_warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """PWCDCNet.warp: bilinear backward warp of ``x`` by ``flo`` with zero
    padding; a pixel whose four taps do not all fall inside the image
    (the sampled ones image below 0.9999) is zeroed."""
    B, C, H, W = x.shape
    xx = torch.arange(W, dtype=x.dtype, device=x.device).expand(H, W)
    yy = torch.arange(H, dtype=x.dtype, device=x.device)[:, None].expand(H, W)
    vgrid = torch.stack([xx, yy])[None] + flo
    grid = torch.stack([2.0 * vgrid[:, 0] / max(W - 1, 1) - 1.0,
                        2.0 * vgrid[:, 1] / max(H - 1, 1) - 1.0], dim=-1)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    ones = torch.ones_like(x[:, :1])
    mask = F.grid_sample(ones, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)
    return out * (mask >= 0.9999).to(x.dtype)


def conv_leaky(cin, cout, k=3, stride=1, padding=1, dilation=1):
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding, dilation),
                         nn.LeakyReLU(0.1))


class PWCDCNet(nn.Module):
    """PWC-Net (PWCNet.py): six-level siamese pyramid, per level warp and
    correlation, DenseNet decoders, the dilated context refiner."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, stride in (
                ("conv1a", 3, 16, 2), ("conv1aa", 16, 16, 1),
                ("conv1b", 16, 16, 1), ("conv2a", 16, 32, 2),
                ("conv2aa", 32, 32, 1), ("conv2b", 32, 32, 1),
                ("conv3a", 32, 64, 2), ("conv3aa", 64, 64, 1),
                ("conv3b", 64, 64, 1), ("conv4a", 64, 96, 2),
                ("conv4aa", 96, 96, 1), ("conv4b", 96, 96, 1),
                ("conv5a", 96, 128, 2), ("conv5aa", 128, 128, 1),
                ("conv5b", 128, 128, 1), ("conv6aa", 128, 196, 2),
                ("conv6a", 196, 196, 1), ("conv6b", 196, 196, 1)):
            setattr(self, name, conv_leaky(cin, cout, 3, stride))
        feat = {6: 0, 5: 128, 4: 96, 3: 64, 2: 32}
        for lvl in (6, 5, 4, 3, 2):
            cin = N_CORR + feat[lvl] + (4 if lvl < 6 else 0)
            for i, w in enumerate(DEC_WIDTHS):
                setattr(self, f"conv{lvl}_{i}", conv_leaky(cin, w))
                cin += w
            setattr(self, f"predict_flow{lvl}", nn.Conv2d(cin, 2, 3, 1, 1))
            if lvl > 2:
                setattr(self, f"deconv{lvl}", nn.ConvTranspose2d(2, 2, 4, 2, 1))
                setattr(self, f"upfeat{lvl}",
                        nn.ConvTranspose2d(cin, 2, 4, 2, 1))
        for i, (ci, co, d) in enumerate(((cin, 128, 1), (128, 128, 2),
                                         (128, 128, 4), (128, 96, 8),
                                         (96, 64, 16), (64, 32, 1)), 1):
            setattr(self, f"dc_conv{i}", conv_leaky(ci, co, 3, 1, d, d))
        self.dc_conv7 = nn.Conv2d(32, 2, 3, 1, 1)

    def pyramid(self, im):
        out = []
        x = im
        for lvl in range(1, 7):
            names = (("conv6aa", "conv6a", "conv6b") if lvl == 6 else
                     (f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"))
            for n in names:
                x = getattr(self, n)(x)
            out.append(x)
        return out

    def decode(self, lvl, x):
        for i in range(len(DEC_WIDTHS)):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], dim=1)
        return x

    def forward(self, frames):
        """frames (B + 1, 3, H, W) consecutive -> the finest flow of each of
        the B pairs, (B, 2, H/4, W/4)."""
        pyr = self.pyramid(frames)
        a = [p[:-1] for p in pyr]
        b = [p[1:] for p in pyr]
        corr = F.leaky_relu(correlation(a[5], b[5]), 0.1)
        x = self.decode(6, corr)
        for lvl, scale in ((6, 0.625), (5, 1.25), (4, 2.5), (3, 5.0)):
            flow = getattr(self, f"predict_flow{lvl}")(x)
            up_flow = getattr(self, f"deconv{lvl}")(flow)
            up_feat = getattr(self, f"upfeat{lvl}")(x)
            warped = flow_warp(b[lvl - 2], up_flow * scale)
            corr = F.leaky_relu(correlation(a[lvl - 2], warped), 0.1)
            x = self.decode(lvl - 1,
                            torch.cat([corr, a[lvl - 2], up_flow, up_feat], 1))
        flow2 = self.predict_flow2(x)
        for i in range(1, 7):
            x = getattr(self, f"dc_conv{i}")(x)
        return flow2 + self.dc_conv7(x)


class BatchNorm(nn.Module):
    """BatchNorm2d normalised by the batch's statistics, as the frozen
    stereo net runs in the preset (its running statistics are kept in the
    state dict and not used)."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=1e-5)


def convbn(cin, cout, k, stride, pad, dilation=1):
    pad = dilation if dilation > 1 else pad
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, pad, dilation,
                                   bias=False), BatchNorm(cout))


class PSMBasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(cin, planes, 3, stride, 1),
                                   nn.ReLU())
        self.conv2 = convbn(planes, planes, 3, 1, 1)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, 0, bias=False),
            BatchNorm(planes)) if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


def _avg_pool(x, window):
    return F.avg_pool2d(x, min(window, x.shape[-2], x.shape[-1]))


def _resize(x, hw, align_corners):
    if tuple(hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=align_corners)


class Pooled(nn.Module):
    """avg_pool (window clamped to the input), then the rest."""

    def __init__(self, window, *rest):
        super().__init__()
        self.window = window
        for i, m in enumerate(rest, 1):
            self.add_module(str(i), m)

    def forward(self, x):
        x = _avg_pool(x, self.window)
        for m in list(self.children()):
            x = m(x)
        return x


class FeatureExtraction(nn.Module):
    """PSM feature_extraction with bigger=True, last_planes 64, middle
    block 3 (submodule.py)."""

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1), nn.ReLU(), convbn(32, 32, 3, 1, 1),
            nn.ReLU(), convbn(32, 32, 3, 1, 1), nn.ReLU())

        def layer(cin, planes, blocks, stride):
            return nn.Sequential(
                PSMBasicBlock(cin, planes, stride,
                              stride != 1 or cin != planes),
                *[PSMBasicBlock(planes, planes, 1, False)
                  for _ in range(1, blocks)])

        self.layer1 = layer(32, 32, 3, 1)
        self.layer2 = layer(32, 64, 3, 2)
        self.layer3 = layer(64, 128, 3, 1)
        self.layer4 = layer(128, 128, 3, 1)
        for i, pool in ((1, 64), (2, 32), (3, 16), (4, 8)):
            setattr(self, f"branch{i}", Pooled(
                pool, convbn(128, 32, 1, 1, 0), nn.ReLU()))
        self.lastconv = nn.Sequential(
            convbn(352, 128, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(128, 64, 1, 1, 0, bias=False))

    def forward(self, x):
        out0 = self.layer1(self.firstconv(x))
        raw = self.layer2(out0)
        skip = self.layer4(self.layer3(raw))
        hw = skip.shape[-2:]
        branches = [_resize(getattr(self, f"branch{i}")(skip), hw, True)
                    for i in (4, 3, 2, 1)]
        feat = torch.cat([raw, skip, *branches], dim=1)
        feat = _resize(feat, (hw[0] * 2, hw[1] * 2), True)
        return self.lastconv(torch.cat([feat, out0], dim=1))


class HGConv(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, (k - 1) // 2)

    def forward(self, x):
        return self.conv(x)


class Residual(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.skip_layer = HGConv(cin, cout, 1) if cin != cout else None
        self.conv1 = HGConv(cin, cout // 2, 1)
        self.conv2 = HGConv(cout // 2, cout // 2, 3)
        self.conv3 = HGConv(cout // 2, cout, 1)

    def forward(self, x):
        res = x if self.skip_layer is None else self.skip_layer(x)
        out = self.conv3(F.relu(self.conv2(F.relu(self.conv1(F.relu(x))))))
        return out + res


class Hourglass(nn.Module):
    def __init__(self, n, f, increase=0):
        super().__init__()
        nf = f + increase
        self.up1 = Residual(f, nf)
        self.low2 = Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf)
        self.low3 = Residual(nf, nf)

    def forward(self, x):
        up1 = self.up1(x)
        low3 = self.low3(self.low2(F.max_pool2d(up1, 2)))
        return up1 + _resize(low3, up1.shape[-2:], False)


class SSP(nn.Module):
    def __init__(self, c):
        super().__init__()
        for i, pool in ((1, 64), (2, 32), (3, 16), (4, 8)):
            setattr(self, f"branch{i}", Pooled(
                pool, nn.Conv2d(c, c // 4, 1), nn.ReLU()))

    def forward(self, x):
        hw = x.shape[-2:]
        return torch.cat([x] + [_resize(getattr(self, f"branch{i}")(x), hw,
                                        False) for i in (4, 3, 2, 1)], 1)


class StereoNet7(nn.Module):
    """StereoNet7.py: (B, 6, H, W) = cat(left, right), normalised ->
    disparity (B, 1, H/4, W/4), every fourth row and column of the full
    resolution output."""

    def __init__(self):
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
        self.deconv_c7_2 = nn.ConvTranspose2d(512, 512, 4, 2, 1)
        self.deconv_c7 = nn.ConvTranspose2d(896, 320, 4, 2, 1)
        self.deconv_c8 = nn.ConvTranspose2d(576, 192, 4, 2, 1)
        self.conv_c8 = Hourglass(2, 192, 0)
        self.deconv_c9 = nn.ConvTranspose2d(384, 128, 4, 2, 1)
        self.conv_c9 = Hourglass(2, 128, 0)
        self.deconv_c10 = nn.ConvTranspose2d(256, 64, 4, 2, 1)
        self.conv_c10 = Hourglass(2, 64, 0)
        self.deconv_c11 = nn.ConvTranspose2d(128, 64, 4, 2, 1)
        self.conv_c12 = nn.Conv2d(64, 16, 1, 1, 0)
        self.conv_c13 = nn.Conv2d(16, 1, 1, 1, 0)

    def forward(self, x):
        B, C, H, W = x.shape
        x1 = self.feature_extraction(torch.cat([x[:, :3], x[:, 3:]], 0))
        x2 = _resize(x, (H // 2, W // 2), False)
        x = self.conv_c0(torch.cat([x1[:B], x1[B:], x2], 1))
        cat0 = self.conv_c1(x)
        x = F.max_pool2d(self.conv_c2(cat0), 2)
        cat1 = self.conv_c2_SSP(x)
        cat2 = F.max_pool2d(self.conv_c3(cat1), 2)
        cat3 = F.max_pool2d(self.conv_c4(cat2), 2)
        cat4 = F.max_pool2d(F.relu(self.conv_c5(cat3)), 2)
        x = F.max_pool2d(F.relu(self.conv_c6(cat4)), 2)
        x = F.relu(self.conv_c6_2(x))
        x = F.relu(self.deconv_c7_2(x))
        x = F.relu(self.deconv_c7(torch.cat([x, cat4], 1)))
        x = F.relu(self.deconv_c8(torch.cat([x, cat3], 1)))
        x = self.conv_c8(x)
        x = F.relu(self.deconv_c9(torch.cat([x, cat2], 1)))
        x = self.conv_c9(x)
        x = F.relu(self.deconv_c10(torch.cat([x, cat1], 1)))
        x = self.conv_c10(x)
        x = F.relu(self.deconv_c11(torch.cat([x, cat0], 1)))
        x = self.conv_c13(F.relu(self.conv_c12(x)))
        return x[:, :, ::4, ::4]


def conv_relu(cin, cout, k=3, stride=2, padding=1):
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding), nn.ReLU())


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = conv_relu(cin, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.downsample = (nn.Conv2d(cin, planes, 1, stride, 0)
                           if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return F.relu(out + (x if self.downsample is None
                             else self.downsample(x)))


# (planes, blocks) of the embedding with config 1 and down_scale
# (VOFlowNet.py:110-157)
POSE_LAYERS = ((64, 3), (128, 4), (128, 6), (256, 7), (256, 3))


class VOFlowRes(nn.Module):
    """VOFlowNet.py's VOFlowRes with intrinsic=True, config 1, down_scale:
    (B, 4, h, w) = cat(flow, ray map) -> (B, 6) = [trans, rot], normalised
    by the pose std."""

    def __init__(self, h, w):
        super().__init__()
        blocks = [conv_relu(4, 32, 3, 2, 1), conv_relu(32, 32, 3, 1, 1),
                  conv_relu(32, 32, 3, 1, 1)]
        cin = 32
        for planes, n in POSE_LAYERS:
            blocks.append(nn.Sequential(
                BasicBlock(cin, planes, 2, True),
                *[BasicBlock(planes, planes, 1, False) for _ in range(1, n)]))
            cin = planes
        self.feat_net = nn.Sequential(*blocks)
        for _ in range(1 + len(POSE_LAYERS)):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        nf = cin * h * w
        for head in ("voflow_trans", "voflow_rot"):
            setattr(self, head, nn.Sequential(
                nn.Sequential(nn.Linear(nf, 128), nn.ReLU()),
                nn.Sequential(nn.Linear(128, 32), nn.ReLU()),
                nn.Linear(32, 3)))

    def forward(self, x):
        f = self.feat_net(x).flatten(1)
        return torch.cat([self.voflow_trans(f), self.voflow_rot(f)], dim=1)


class VONet(nn.Module):
    """Network/VONet.py: flow of each consecutive pair, disparity of each
    left/right pair, pose from cat(flow, ray map)."""

    def __init__(self, height, width):
        super().__init__()
        self.flowNet = PWCDCNet()
        self.stereoNet = StereoNet7()
        self.flowPoseNet = VOFlowRes(height // 4, width // 4)

    def forward(self, frames, img0_norm, img0_r_norm, intrinsic):
        """All NCHW: frames (B + 1, 3, H, W) /255, the left and right
        normalised images (B, 3, H, W), the ray map (B, 2, H/4, W/4).
        Returns (flow, disp, pose), the flow and disparity without
        gradients, as the frozen networks give them."""
        with torch.no_grad():
            flow = self.flowNet(frames)
            disp = self.stereoNet(torch.cat([img0_norm, img0_r_norm], 1))
        pose = self.flowPoseNet(torch.cat([flow, intrinsic], 1))
        return flow, disp, pose
