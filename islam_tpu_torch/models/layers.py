"""Layer primitives in NCHW with the torch parameter layout of the reference.

Counterpart of ``islam_tpu/models/layers.py``.  The JAX package re-creates
torch's Conv2d / ConvTranspose2d / BatchNorm2d in NHWC; here they are torch's
own (or thin modules over ``torch.nn.functional``), so parameters carry the
reference's layouts and names: conv (out, in, kh, kw), transposed conv
(in, out, kh, kw), Linear (out, in).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _split_conv_sum(parts, weight, dim, conv_one):
    """conv(cat(parts)) == sum_i conv_one(part_i, weight_i), ``weight_i``
    the slice of ``weight``'s input-channel ``dim`` that part i meets
    (islam_tpu/models/layers.py:40-54): no concatenation is written."""
    y, off = None, 0
    for p in parts:
        t = conv_one(p, weight.narrow(dim, off, p.shape[1]))
        y = t if y is None else y + t
        off += p.shape[1]
    return y


def conv_parts(conv: nn.Conv2d, parts) -> torch.Tensor:
    """``conv(torch.cat(parts, dim=1))`` without the concatenation: the sum
    over the channel parts of ``F.conv2d(part, weight[:, off:off + c])``,
    plus the bias once (``PartsConv``, islam_tpu/models/layers.py:57-107).
    ``conv`` keeps its one weight, so its state_dict keys are those of the
    concatenating path."""
    y = _split_conv_sum(parts, conv.weight, 1, lambda p, w: F.conv2d(
        p, w, None, conv.stride, conv.padding, conv.dilation))
    return y if conv.bias is None else y + conv.bias[:, None, None]


class ConvT2d(nn.Module):
    """torch.nn.ConvTranspose2d (weight (in, out, k, k)) with ``out_stride``.

    ``out_stride`` = n > 1 computes only the output rows/cols 0, n, 2n, ...
    (exactly ``full_output[..., ::n, ::n]``) without the full-resolution
    output: at m = n*i only the taps t with t % s == pad % s (pad = k-1-p)
    meet real input samples, so the subsampled output is an ordinary
    stride-(n/s) convolution of the input with those taps of the flipped
    kernel, padded by ``pb`` before and ``pr`` after.  StereoNet7's
    quarter-res head uses it.  Requires out_stride % stride == 0.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, out_stride: int = 1):
        super().__init__()
        if out_stride > 1 and out_stride % stride:
            raise ValueError(f"out_stride {out_stride} % stride {stride} != 0")
        self.k, self.s, self.p, self.out_stride = (kernel_size, stride,
                                                   padding, out_stride)
        self.weight = nn.Parameter(
            torch.empty(cin, cout, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x) -> torch.Tensor:
        """``x`` is a tensor or, as for ``conv_parts``, a tuple of channel
        parts: then the output is the sum over the parts of the transposed
        convolution with the weight's input rows of that part, plus the bias
        once."""
        if isinstance(x, (tuple, list)):
            return _split_conv_sum(x, self.weight, 0, lambda q, w: (
                self._transposed(q, w, None))) + self.bias[:, None, None]
        return self._transposed(x, self.weight, self.bias)

    def _transposed(self, x, weight, bias):
        k, s, p, n = self.k, self.s, self.p, self.out_stride
        if n == 1:
            return F.conv_transpose2d(x, weight, bias, stride=s, padding=p)
        pad = k - 1 - p
        t0 = pad % s
        taps = list(range(t0, k, s))
        ke, st = len(taps), n // s
        pb = max(0, -((taps[0] - pad) // s))
        # flipped, (out, in, k, k): the equivalent forward-conv kernel
        w = weight.flip(2, 3).transpose(0, 1)[:, :, t0::s, t0::s]
        n_out = [-(-((sz - 1) * s - 2 * p + k) // n) for sz in x.shape[-2:]]
        pr = [max(0, st * (m - 1) + ke - pb - sz)
              for m, sz in zip(n_out, x.shape[-2:])]
        xp = F.pad(x, (pb, pr[1], pb, pr[0]))
        y = F.conv2d(xp, w.contiguous(), bias, stride=st)
        if list(y.shape[-2:]) != n_out:
            raise AssertionError((tuple(y.shape), n_out))
        return y


def ConvT3d(cin: int, cout: int) -> nn.ConvTranspose3d:
    """The PSMNet hourglasses' transposed 3-D convolution (``ConvT3d``,
    islam_tpu/models/layers.py:200-240; stackhourglass.py:25-29): k=3, s=2,
    p=1, output_padding=1, no bias, so out = 2 in.  Its weight is torch's
    (in, out, 3, 3, 3); the JAX package stores it flipped, and
    ``utils/weights.py`` flips it back."""
    return nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1, bias=False)


class BatchNorm(nn.Module):
    """BatchNorm2d (and 3d: any (N, C, ...) input) with the reference's
    parameters and buffers (weight, bias,
    running_mean, running_var; eps 1e-5).

    By default the batch statistics normalise and the running stats are left
    untouched: the reference runs its frozen subnets in train mode and never
    consumes the update (the JAX package drops it, tartanvo.py:100-104).
    With ``use_running_average`` set (``--frozen-bn-eval``; the function of
    that name sets it on a whole net) the running stats normalise, as in
    eval mode (islam_tpu/models/layers.py:241-250).  That flag, not
    ``nn.Module``'s train/eval mode, decides.
    """

    use_running_average = False

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=1e-5)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=1e-5)


def use_running_average(module: nn.Module, flag: bool) -> None:
    """Sets ``use_running_average`` on every BatchNorm in ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.use_running_average = flag


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False):
    """Bilinear resize of NCHW ``x`` to ``out_hw`` (no antialias), torch's
    F.interpolate semantics, which the JAX package reproduces."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def interpolate_scale(x: torch.Tensor, scale: float, mode="bilinear"):
    """``F.interpolate(scale_factor=scale)`` as the JAX package computes it
    (islam_tpu/models/layers.py:348-355): the output is int(n * scale) a
    side and the sampling grid is that of the sizes; 'nearest' takes
    source floor((i + 0.5) n / n'), as ``jax.image.resize`` does."""
    hw = (int(x.shape[-2] * scale), int(x.shape[-1] * scale))
    if mode == "nearest":
        return F.interpolate(x, size=hw, mode="nearest-exact")
    return resize_bilinear(x, hw, align_corners=False)


class ClampedAvgPool(nn.Module):
    """avg_pool with the window clamped to the input size, so inputs smaller
    than the reference's 448x640 stay valid (a no-op at that size)."""

    def __init__(self, window: int):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, min(self.window, x.shape[-2], x.shape[-1]))


def _trunc_normal_(t: torch.Tensor, fan_in: int, scale: float,
                   gen: torch.Generator):
    # flax variance_scaling(scale, "fan_in", "truncated_normal")
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise ``model`` in place, reproducibly from ``seed``, with the
    JAX package's initialisers: kaiming-normal 2-D and transposed convs,
    lecun-normal 3-D convs (flax ``nn.Conv``'s default, which the PSMNets
    use) and Linear, zero biases, unit BatchNorm scale."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _trunc_normal_(m.weight, m.weight[0].numel(), 2.0, gen)
        elif isinstance(m, (ConvT2d, nn.ConvTranspose3d)):
            # flax fan_in of the (D)HWIO kernel: k^d * in
            _trunc_normal_(m.weight, m.weight[:, 0].numel(), 2.0, gen)
        elif isinstance(m, nn.Conv3d):
            _trunc_normal_(m.weight, m.weight[0].numel(), 1.0, gen)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, m.in_features, 1.0, gen)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return model
