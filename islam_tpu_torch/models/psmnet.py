"""PSMNet stereo alternates (basic and stacked hourglass), NCDHW.

Counterpart of ``islam_tpu/models/psmnet.py`` (the reference's
Network/PSM/{basic,stackhourglass}.py): the shared PSM feature extractor at
1/4 scale, a concat cost volume over D/4 disparities, 3-D conv hourglasses
and soft-argmin disparity regression.  Module names are the reference's, so
the state_dict keys are its torch keys (``_psmnet_key``,
islam_tpu/utils/checkpoints.py:112).  Disparity is the depth axis of the
3-D convolutions.  ``train_bn`` picks batch statistics (True) or the
running stats (False) for every BatchNorm, as the JAX modules' field does;
``training_mode`` returns the stacked hourglass's three predictions.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from islam_tpu_torch.models.layers import (BatchNorm, ConvT3d, init_weights_,
                                           use_running_average)
from islam_tpu_torch.models.stereonet import FeatureExtraction


def convbn_3d(cin, cout, kernel_size=3, stride=1, pad=1):
    """PSM convbn_3d (submodule.py:15-19): Conv3d (no bias) + BatchNorm3d."""
    return nn.Sequential(nn.Conv3d(cin, cout, kernel_size, stride, pad,
                                   bias=False), BatchNorm(cout))


def build_cost_volume(ref_fea: torch.Tensor, target_fea: torch.Tensor,
                      maxdisp4: int) -> torch.Tensor:
    """Concat cost volume (stackhourglass.py:117-126).  ref/target
    (B, C, H, W) -> (B, 2C, D, H, W): at disparity d, channels [0, C) hold
    the reference features and [C, 2C) the target's shifted right by d,
    both zero for x < d."""
    B, C, H, W = ref_fea.shape
    cost = ref_fea.new_zeros((B, 2 * C, maxdisp4, H, W))
    for d in range(maxdisp4):
        cost[:, :C, d, :, d:] = ref_fea[..., d:]
        cost[:, C:, d, :, d:] = target_fea[..., :W - d]
    return cost


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Soft-argmin (submodule.py:56-64): prob (B, D, H, W) -> (B, 1, H, W)."""
    disp = torch.arange(maxdisp, dtype=prob.dtype, device=prob.device)
    return torch.sum(prob * disp.reshape(1, maxdisp, 1, 1), dim=1,
                     keepdim=True)


def _trilinear_resize(x, out_dhw, align_corners=False):
    """(B, C, D, H, W) trilinear resize: align_corners=False as
    stackhourglass's F.interpolate (stackhourglass.py:146-160), True as
    basic.py's F.upsample (basic.py:87)."""
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear",
                         align_corners=align_corners)


def _predict(cost, maxdisp, hw, align_corners):
    """(B, 1, D/4, H/4, W/4) costs -> (B, 1, H, W) disparity."""
    c = _trilinear_resize(cost, (maxdisp, *hw), align_corners)[:, 0]
    return disparity_regression(F.softmax(c, dim=1), maxdisp)


def _dres(cin, relu_last):
    """dresN: convbn_3d, ReLU, convbn_3d (and ReLU for dres0)."""
    layers = [convbn_3d(cin, 32), nn.ReLU(), convbn_3d(32, 32)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu_last else []))


def _classif():
    """classifN / classify: convbn_3d, ReLU, Conv3d to one channel."""
    return nn.Sequential(convbn_3d(32, 32), nn.ReLU(),
                         nn.Conv3d(32, 1, 3, 1, 1, bias=False))


class Hourglass3D(nn.Module):
    """stackhourglass.py:10-50."""

    def __init__(self, inplanes: int):
        super().__init__()
        p2 = inplanes * 2
        self.conv1 = nn.Sequential(convbn_3d(inplanes, p2, 3, 2, 1),
                                   nn.ReLU())
        self.conv2 = convbn_3d(p2, p2, 3, 1, 1)
        self.conv3 = nn.Sequential(convbn_3d(p2, p2, 3, 2, 1), nn.ReLU())
        self.conv4 = nn.Sequential(convbn_3d(p2, p2, 3, 1, 1), nn.ReLU())
        self.conv5 = nn.Sequential(ConvT3d(p2, p2), BatchNorm(p2))
        self.conv6 = nn.Sequential(ConvT3d(p2, inplanes), BatchNorm(inplanes))

    def forward(self, x, presqu, postsqu):
        pre = self.conv2(self.conv1(x))
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = self.conv4(self.conv3(pre))
        post = self.conv5(out)
        post = F.relu(post + (presqu if presqu is not None else pre))
        return self.conv6(post), pre, post


class PSMNetStackHourglass(nn.Module):
    """stackhourglass.py:52-176.  Input (B, 6, H, W) = cat(left, right);
    H, W divisible by 16 and ``maxdisp`` by 16.  Returns (disp (B, 1, H, W),
    None), or with ``training_mode`` ((disp1, disp2, disp3), None)."""

    def __init__(self, maxdisp: int = 192, train_bn: bool = True,
                 training_mode: bool = False):
        super().__init__()
        self.maxdisp, self.train_bn = maxdisp, train_bn
        self.training_mode = training_mode
        self.feature_extraction = FeatureExtraction(32, False, 16)
        self.dres0 = _dres(64, True)
        self.dres1 = _dres(32, False)
        self.dres2 = Hourglass3D(32)
        self.dres3 = Hourglass3D(32)
        self.dres4 = Hourglass3D(32)
        self.classif1 = _classif()
        self.classif2 = _classif()
        self.classif3 = _classif()

    def forward(self, x):
        use_running_average(self, not self.train_bn)
        B, C, H, W = x.shape
        # the L/R images stacked along the batch, pair by pair
        feat = self.feature_extraction(x.reshape(B * 2, C // 2, H, W))
        feat = feat.reshape(B, 2, *feat.shape[1:])
        cost = build_cost_volume(feat[:, 0], feat[:, 1], self.maxdisp // 4)

        cost0 = self.dres0(cost)
        cost0 = self.dres1(cost0) + cost0
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0

        cost1 = self.classif1(out1)
        cost2 = self.classif2(out2) + cost1
        cost3 = self.classif3(out3) + cost2
        if self.training_mode:
            return tuple(_predict(c, self.maxdisp, (H, W), False)
                         for c in (cost1, cost2, cost3)), None
        return _predict(cost3, self.maxdisp, (H, W), False), None


class PSMNetBasic(nn.Module):
    """basic.py:10-107.  Inputs: separate left and right images
    (B, 3, H, W).  Returns disp (B, 1, H, W)."""

    def __init__(self, maxdisp: int = 192, train_bn: bool = True):
        super().__init__()
        self.maxdisp, self.train_bn = maxdisp, train_bn
        self.feature_extraction = FeatureExtraction(32, False, 16)
        self.dres0 = _dres(64, True)
        for i in range(1, 5):
            setattr(self, f"dres{i}", _dres(32, False))
        self.classify = _classif()

    def forward(self, left, right):
        use_running_average(self, not self.train_bn)
        H, W = left.shape[-2:]
        cost = build_cost_volume(self.feature_extraction(left),
                                 self.feature_extraction(right),
                                 self.maxdisp // 4)
        cost0 = self.dres0(cost)
        for i in range(1, 5):
            cost0 = getattr(self, f"dres{i}")(cost0) + cost0
        return _predict(self.classify(cost0), self.maxdisp, (H, W), True)


def init_model(basic: bool = False, seed: int = 0, device="cuda",
               **kw) -> nn.Module:
    """A ``PSMNetStackHourglass`` (or, with ``basic``, a ``PSMNetBasic``)
    built with ``kw`` and weights drawn from ``seed``, on ``device``."""
    model = (PSMNetBasic if basic else PSMNetStackHourglass)(**kw)
    return init_weights_(model, seed).to(device)
