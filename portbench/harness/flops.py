"""The work of one window, counted once a run on the plain reference's
networks at the cell's shapes (on the meta device: no memory, no time on
the card).

The rule is ``islam_tpu_torch/tools/flops.py``'s useful one, copied: a
convolution or matrix product counts 2 x its multiply-adds as
``torch.utils.flop_counter`` gives them (a transposed convolution counts
its input's taps, not the zeros a dilated one would insert), and a resize
or the correlation counts 0.  The stereo net's last three layers count
one sixteenth of their full-resolution work, since the window needs only
every fourth row and column of their output (the reference computes all
of them; the program only those).  The LM's and the denoiser's products,
some 2e-5 TFLOPs a window, are left out.

Besides the total it keeps each convolution's FLOPs and bytes (input,
weight, bias and output read or written once, float32), and the shapes
of the correlation's five calls a forward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from portbench.ref import nets

aten = torch.ops.aten
QUARTER_LAYERS = ("stereoNet.deconv_c11", "stereoNet.conv_c12",
                  "stereoNet.conv_c13")


class Work(NamedTuple):
    flops: float          # useful FLOPs of the window's networks
    conv_flops: float     # of which convolutions (forward and backward)
    conv_bytes: float     # the convolutions' bytes, each read or write once
    corr_shapes: list     # (B, C, H, W) of each correlation call


class _Counter(TorchDispatchMode):
    def __init__(self, where):
        super().__init__()
        self.where = where     # the module path stack
        self.flops = self.conv_flops = self.conv_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            shapes = [a.shape if isinstance(a, torch.Tensor) else a
                      for a in args]
            outs = out if isinstance(out, (tuple, list)) else [out]
            out_shapes = [o.shape if isinstance(o, torch.Tensor) else None
                          for o in outs]
            f = flop_registry[packet](*shapes, **kwargs,
                                      out_val=out_shapes if len(outs) > 1
                                      else out_shapes[0])
            share = 1.0 / 16 if any(p.endswith(QUARTER_LAYERS)
                                    for p in self.where) else 1.0
            self.flops += f * share
            if packet in (aten.convolution, aten.convolution_backward):
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                tensors += [o for o in outs if isinstance(o, torch.Tensor)]
                self.conv_flops += f * share
                self.conv_bytes += share * sum(t.numel() * 4 for t in tensors)
        return out


def count(height: int, width: int, batch: int, train_pose: bool) -> Work:
    """The work of one window: the three networks' forward and, with
    ``train_pose``, the pose head's backward (its input needs no
    gradient)."""
    with torch.device("meta"):
        net = nets.VONet(height, width)
        frames = torch.empty(batch + 1, 3, height, width)
        left = torch.empty(batch, 3, height, width)
        right = torch.empty(batch, 3, height, width)
        ray = torch.empty(batch, 2, height // 4, width // 4)
    names = {m: n for n, m in net.named_modules()}
    where, corr_shapes = [], []
    plain = nets.correlation

    def corr(f1, f2):
        corr_shapes.append(tuple(f1.shape))
        return plain(f1, f2)

    def pre(module, args):
        where.append(names.get(module, ""))

    def post(module, args, out):
        where.pop()

    h1 = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    h2 = torch.nn.modules.module.register_module_forward_hook(post)
    nets.correlation = corr
    counter = _Counter(where)
    try:
        with counter:
            flow, disp, pose = net(frames, left, right, ray)
            if train_pose:
                pose.sum().backward()
    finally:
        nets.correlation = plain
        h1.remove()
        h2.remove()
    return Work(counter.flops, counter.conv_flops, counter.conv_bytes,
                corr_shapes)
