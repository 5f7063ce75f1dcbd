"""PWC-DC optical-flow network, NCHW, and its multi-scale flow losses.

Counterpart of ``islam_tpu/models/pwcnet.py`` and the reference's
Network/PWC/PWCNet.py: 6-level siamese conv pyramid, per-level warp and
local correlation (the CUDA kernel of ``ops/correlation.py`` on the card),
DenseNet-style decoders, deconv upsampling, the dilated context refiner.
Outputs 5 scales of flow, finest first; with ``uncertainty`` also the
log-variance heads of PWCNet.py:22-52.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from islam_tpu_torch.models.layers import (ConvT2d, conv_parts,
                                           interpolate_scale, leaky_relu,
                                           resize_bilinear)
from islam_tpu_torch.ops.correlation import correlation
from islam_tpu_torch.ops.warp import flow_warp


def conv_leaky(cin, cout, kernel_size=3, stride=1, padding=1, dilation=1):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel_size, stride, padding,
                                   dilation), nn.LeakyReLU(0.1))


class PredictUncertainty(nn.Sequential):
    """predict_uncertainty (PWCNet.py:22-33): a 3-conv funnel to 1 channel
    (conv0, conv1, conv2 in the JAX package; items 0, 2, 4 here, as in the
    reference's checkpoints)."""

    def __init__(self, cin):
        super().__init__(nn.Conv2d(cin, cin // 2, 3, 1, 1), nn.LeakyReLU(0.1),
                         nn.Conv2d(cin // 2, cin // 4, 3, 1, 1),
                         nn.LeakyReLU(0.1), nn.Conv2d(cin // 4, 1, 3, 1, 1))


class PredictFlow(nn.Module):
    """A flow conv with its uncertainty head, as the reference's uncertainty
    checkpoints hold them: ``<name>.pred`` and ``<name>.unc.{0,2,4}``
    (islam_tpu/utils/checkpoints.py:33-47).  Returns (flow, log-variance)."""

    def __init__(self, cin):
        super().__init__()
        self.pred = nn.Conv2d(cin, 2, 3, 1, 1)
        self.unc = PredictUncertainty(cin)

    def forward(self, x):
        return self.pred(x), self.unc(x)


_DEC_WIDTHS = (128, 128, 96, 64, 32)
_NCORR = 81  # (2 md + 1)^2 at md = 4


class PWCDCNet(nn.Module):
    """``uncertainty`` adds the log-variance heads: each level's decoder
    then also takes the upsampled uncertainty of the level below (one more
    channel), and ``forward`` returns (flows, uncertainties) in place of the
    flows alone."""

    def __init__(self, uncertainty: bool = False):
        super().__init__()
        self.uncertainty = uncertainty
        head = PredictFlow if uncertainty else (
            lambda cin: nn.Conv2d(cin, 2, 3, 1, 1))
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
        # 2-channel maps (and the upsampled uncertainty).
        feat = {6: 0, 5: 128, 4: 96, 3: 64, 2: 32}
        up = 5 if uncertainty else 4
        for lvl in (6, 5, 4, 3, 2):
            cin = _NCORR + feat[lvl] + (up if lvl < 6 else 0)
            for i, w in enumerate(_DEC_WIDTHS):
                setattr(self, f"conv{lvl}_{i}", conv_leaky(cin, w))
                cin += w
            setattr(self, f"predict_flow{lvl}", head(cin))
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
        self.dc_conv7 = head(32)

    def _corr(self, f1, f2):
        return leaky_relu(correlation(f1, f2), 0.1)

    @staticmethod
    def _conv(conv, x):
        """A conv of a tensor, or of a tuple of channel parts."""
        return conv_parts(conv, x) if isinstance(x, tuple) else conv(x)

    def _block(self, block, x):
        """conv_leaky of a tensor or of channel parts."""
        return block[1](self._conv(block[0], x))

    def _decode(self, lvl, x, concat_free):
        """DenseNet-style concat chain (PWCNet.py:208-214).  With
        ``concat_free`` the chain keeps the parts, newest first, and each
        block sums its convolutions over them: conv(cat(parts)) with no
        concat buffer written (pwcnet.py:138-150)."""
        if concat_free:
            parts = list(x) if isinstance(x, tuple) else [x]
            for i in range(len(_DEC_WIDTHS)):
                parts.insert(0, self._block(
                    getattr(self, f"conv{lvl}_{i}"), tuple(parts)))
            return tuple(parts)
        for i in range(len(_DEC_WIDTHS)):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], dim=1)
        return x

    def _level(self, lvl, x, feat_low1, feat_low2, scale, concat_free):
        """concate_two_layers (PWCNet.py:216-233): predict, upsample, warp the
        next level's second feature, correlate.  Returns (the next decoder's
        input, as channel parts with ``concat_free``; flow; uncertainty or
        None)."""
        pred = getattr(self, f"predict_flow{lvl}")
        flow_unc = None
        if self.uncertainty:
            flow_high, flow_unc = pred(x)
        else:
            flow_high = self._conv(pred, x)
        up_flow = getattr(self, f"deconv{lvl}")(flow_high)
        up_feat = getattr(self, f"upfeat{lvl}")(x)
        warp_feat = flow_warp(feat_low2, up_flow * scale)
        corr = self._corr(feat_low1, warp_feat)
        parts = [corr, feat_low1, up_flow, up_feat]
        if concat_free:
            return tuple(parts), flow_high, None
        if flow_unc is not None:
            parts.append(resize_bilinear(flow_unc, up_feat.shape[-2:]))
        return torch.cat(parts, dim=1), flow_high, flow_unc

    def _pyramid(self, im):
        c1 = self.conv1b(self.conv1aa(self.conv1a(im)))
        c2 = self.conv2b(self.conv2aa(self.conv2a(c1)))
        c3 = self.conv3b(self.conv3aa(self.conv3a(c2)))
        c4 = self.conv4b(self.conv4aa(self.conv4a(c3)))
        c5 = self.conv5b(self.conv5aa(self.conv5a(c4)))
        c6 = self.conv6b(self.conv6a(self.conv6aa(c5)))
        return c1, c2, c3, c4, c5, c6

    def forward(self, x: torch.Tensor, shared_frames: bool = False,
                concat_free: bool = False):
        """x: (B, 6, H, W) = cat(img0, img1), or with ``shared_frames``
        (B+1, 3, H, W) consecutive frames: the pyramid runs once per frame
        and pair k correlates frame k with frame k+1.  ``concat_free``
        evaluates the decoders' concat chains as sums of convolutions over
        their parts (the same function and parameters, no concat buffers);
        it is ignored with ``uncertainty``, as in the JAX package.
        Returns (flow2, flow3, flow4, flow5, flow6), and with
        ``uncertainty`` ((flow2, ..., flow6), (unc2, ..., unc6))."""
        cf = concat_free and not self.uncertainty
        if shared_frames:
            pyr = self._pyramid(x)
            c1s = [c[:-1] for c in pyr]
            c2s = [c[1:] for c in pyr]
        else:
            c1s = self._pyramid(x[:, 0:3])
            c2s = self._pyramid(x[:, 3:6])
        _, c12, c13, c14, c15, c16 = c1s
        _, c22, c23, c24, c25, c26 = c2s

        x = self._decode(6, self._corr(c16, c26), cf)
        x, flow6, unc6 = self._level(6, x, c15, c25, 0.625, cf)
        x = self._decode(5, x, cf)
        x, flow5, unc5 = self._level(5, x, c14, c24, 1.25, cf)
        x = self._decode(4, x, cf)
        x, flow4, unc4 = self._level(4, x, c13, c23, 2.5, cf)
        x = self._decode(3, x, cf)
        x, flow3, unc3 = self._level(3, x, c12, c22, 5.0, cf)
        x = self._decode(2, x, cf)
        if self.uncertainty:
            flow2, unc2 = self.predict_flow2(x)
        else:
            flow2 = self._conv(self.predict_flow2, x)

        x = self._block(self.dc_conv1, x)
        x = self.dc_conv4(self.dc_conv3(self.dc_conv2(x)))
        x = self.dc_conv6(self.dc_conv5(x))
        flows = (flow2 + (self.dc_conv7.pred(x) if self.uncertainty
                          else self.dc_conv7(x)),
                 flow3, flow4, flow5, flow6)
        if not self.uncertainty:
            return flows
        # PWCNet.py:287-289: the refiner's uncertainty joins unc2's
        unc2 = torch.log(torch.exp(unc2) + torch.exp(self.dc_conv7.unc(x)))
        return flows, (unc2, unc3, unc4, unc5, unc6)


# ---------------------------------------------------------------------------
# Multi-scale flow supervision (PWCNet.py:296-450; pwcnet.py:241-306), on
# NCHW tensors.  ``criterion`` is e.g. lambda a, b: (a - b).abs().mean().
# ---------------------------------------------------------------------------

def scale_targetflow(targetflow, small_scale=False):
    """GT flow pyramid at the 5 prediction scales (PWCNet.py:296-308)."""
    targets = [targetflow if small_scale
               else interpolate_scale(targetflow, 0.25)]
    for _ in range(4):
        targets.append(interpolate_scale(targets[-1], 0.5))
    return targets


def scale_mask(mask, small_scale=False):
    """Occlusion-mask pyramid; True = supervise (PWCNet.py:310-332)."""
    masks = [mask if small_scale else interpolate_scale(mask, 0.25)]
    for _ in range(4):
        masks.append(interpolate_scale(masks[-1], 0.5))
    return [(m < 0.5) | (m > 1) for m in masks]


def calc_one_flow_loss(output, target, criterion, mask=None, unc=None,
                       lamb=1.0):
    """PWCNet.py:334-347: the masked criterion, or the uncertainty-weighted
    L1."""
    if unc is None:
        if mask is not None:
            w = mask.to(output.dtype)
            return criterion(output * w, target * w)
        return criterion(output, target)
    diff = (output - target).abs()
    loss_unc = torch.mean(torch.exp(-unc) * diff + unc * lamb)
    return loss_unc / (1.0 + lamb)


def calc_flow_loss(outputs, target, criterion, mask=None, uncs=None,
                   lamb=1.0, training=True):
    """Multi-scale loss (PWCNet.py:404-450).  Training: the mean over the 5
    scales, and the finest scale's loss without uncertainty.  Eval: the
    finest flow upsampled x4 against the target, masked where mask < 10.
    Returns (loss, loss without uncertainty)."""
    small_scale = target.shape == outputs[0].shape
    if training:
        targets = scale_targetflow(target, small_scale)
        masks = [None] * 5 if mask is None else scale_mask(mask, small_scale)
        losses = [calc_one_flow_loss(
            outputs[k], targets[k], criterion, masks[k],
            None if uncs is None else uncs[k], lamb) for k in range(5)]
        loss_nounc = calc_one_flow_loss(outputs[0], targets[0], criterion,
                                        masks[0], None, lamb)
        return sum(losses) / 5.0, loss_nounc
    out4 = outputs[0] if small_scale else interpolate_scale(outputs[0], 4)
    unc4 = None
    if uncs is not None and uncs[0] is not None:
        unc4 = uncs[0] if small_scale else interpolate_scale(uncs[0], 4)
    valid = None if mask is None else (mask < 10)
    loss = calc_one_flow_loss(out4, target, criterion, valid, unc4, lamb)
    loss_nounc = calc_one_flow_loss(out4, target, criterion, valid, None,
                                    lamb)
    return loss, loss_nounc
