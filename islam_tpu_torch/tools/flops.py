"""Model FLOPs of one window's ``train_step``, by part.

    python -m islam_tpu_torch.tools.flops [--quick] [--target vo|imu]
        [--f32] [--device cuda|cpu]

Counterpart of ``tools/flops_analysis.py``: the convolution and matmul
FLOPs (2 x multiply-adds) of one ``train.train_step`` at the JAX tool's
configuration (``tools/flops_analysis.py:96-123``): KITTI coordinates, no
ground-truth scale (the stereo net runs), the accelerometer denoised and
the gyroscope not, loss weights (1, 0.1, 10, 0.1), rot_w 1, trans_w 0.1,
bfloat16 unless ``--f32``, the synthetic window of ``testing`` and a seed-1
denoiser.  448x640, B=8 by default; ``--quick`` 64x128, B=2.

Two rules count the same operations:

- ``model_tflops``: the useful multiply-adds, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them, plus the
  matrix-vector products it skips (the LM's).  A transposed convolution
  counts its input's taps, not the zeros a lhs-dilated convolution would
  insert; a bilinear resize counts 0.  (Its weight gradient of a grouped
  convolution counts ``groups`` times the products; none is on this path.)
  It is the numerator of an MFU.
- ``model_tflops_jax_rule``: what ``flops_analysis.eqn_flops`` counts for
  the JAX package's program of the same shapes.  JAX writes a transposed
  convolution, and the input gradient of a strided one, as a convolution
  with ``lhs_dilation``, and counts ``2 * out * k * Cin / groups`` over the
  dilated input; it resizes with a depthwise x2 convolution (exact x2) or
  two matrix products (other ratios).

The correlation counts 0 in both (in JAX it is elementwise work); its
multiply-adds, 81 x B x C x H x W a pyramid level, are reported apart.
The PVGO part (the LM's Jacobians and solves: 10 steps, as JAX bounds its
while loop) is counted op by op: on the card the detached solve runs
outside its CUDA graph here, whose replay the counter cannot see.  On the
card ``nn.GRU`` runs as one cuDNN call, which the counter does not know:
``rnn_flops`` counts it as the CPU's decomposed matrix products.

The counting runs the step on ``--device``: at 448x640, B=8 that needs the
card (the correlation has no path on ``meta``); the CPU serves small sizes.
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from collections import defaultdict
from contextlib import ExitStack
from typing import NamedTuple
from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from islam_tpu_torch.tools import h100

aten = torch.ops.aten

PARTS = ("flow", "stereo", "pose", "denoiser", "imu", "pvgo", "other",
         "backward")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# An op belongs to the innermost frame of one of these files; an op of the
# autograd engine's backward with none on its stack to 'backward'.
_PART_FILES = tuple((os.path.join(_PKG, *sub.split("/")), part) for sub, part in (
    ("models/pwcnet.py", "flow"), ("models/stereonet.py", "stereo"),
    ("models/psmnet.py", "stereo"), ("models/voflownet.py", "pose"),
    ("imu/denoiser.py", "denoiser"), ("imu/", "imu"), ("pvgo/", "pvgo")))
CORR_SHIFTS = 81  # (2 x 4 + 1)^2 displacements a pixel
# The count at 448x640, B=8, bfloat16, 'vo' under JAX's rule, as
# ``bench.py`` keeps it for its MFU line (``MODEL_TFLOPS_FALLBACK``).
FULL_JAX_RULE_TFLOPS = 4.3359


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


# ---- the useful rule: FlopCounterMode's own formulas ----

def conv_useful(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """``FlopCounterMode``'s count of a convolution."""
    return int(flop_registry[aten.convolution](
        list(x_shape), list(w_shape), None, None, None, None, transposed,
        out_val=list(out_shape)))


def conv_backward_useful(grad_out_shape, x_shape, w_shape, transposed: bool,
                         output_mask) -> int:
    """``FlopCounterMode``'s count of a convolution's backward."""
    return int(flop_registry[aten.convolution_backward](
        list(grad_out_shape), list(x_shape), list(w_shape), None, None, None,
        None, transposed, None, None, list(output_mask),
        out_val=[list(x_shape), list(w_shape), None]))


# ---- the JAX rule, from the shapes of the port's ops ----

def conv_jax_rule(x_shape, w_shape, out_shape, groups: int) -> int:
    """``eqn_flops`` of JAX's convolution of these torch shapes (x (B, Cin,
    ...), out (B, Cout, ...), torch's weight of a plain or transposed
    convolution): 2 x out x Cin / groups x the kernel's taps.  For a
    transposed convolution ``out`` is the dilated input's output, so the
    inserted zeros count."""
    return 2 * _numel(out_shape) * (x_shape[1] // groups) * _numel(w_shape[2:])


def conv_backward_jax_rule(grad_out_shape, x_shape, w_shape, groups: int,
                           output_mask) -> int:
    """``eqn_flops`` of the convolutions JAX's transpose rules emit for the
    input gradient (``output_mask[0]``: a convolution onto the input's
    shape over Cout / groups, lhs-dilated by the stride) and the weight
    gradient (``output_mask[1]``: onto the kernel's shape over the batch
    and the output's positions)."""
    n = 0
    if output_mask[0]:
        n += 2 * _numel(x_shape) * (grad_out_shape[1] // groups) * _numel(
            w_shape[2:])
    if output_mask[1]:
        n += 2 * _numel(w_shape) * grad_out_shape[0] * _numel(
            grad_out_shape[2:])
    return n


def resize_jax_rule(x_shape, out_shape, align_corners: bool) -> int:
    """``eqn_flops`` of the JAX package's ``resize_bilinear``
    (islam_tpu/models/layers.py:327-345): an exact half-pixel x2 is a
    depthwise 4x4 convolution, an exact x1/2 an average pool, any other
    ratio two matrix products (rows, then columns)."""
    B, C, H, W = x_shape
    Ho, Wo = out_shape[2:]
    if (Ho, Wo) == (H, W):
        return 0
    if not align_corners and (Ho, Wo) == (2 * H, 2 * W):
        return 2 * _numel(out_shape) * 16
    if not align_corners and (H, W) == (2 * Ho, 2 * Wo):
        return 0
    return 2 * B * C * Ho * W * H + 2 * B * C * Ho * Wo * W


def solve_jax_rule(a_shape, rhs_cols: int) -> int:
    """``eqn_flops`` of ``jnp.linalg.solve`` and ``inv`` (a solve against
    the identity): ``jaxpr_flops`` walks the closures of
    ``lax.custom_linear_solve``, whose matvec and its transpose are each a
    product of A with the right-hand side (they serve differentiation; the
    LU factorisation and its triangular solves count 0)."""
    n = a_shape[-1]
    return 2 * 2 * _numel(a_shape[:-2]) * n * n * rhs_cols


_RNN_GATES = {0: 1, 1: 1, 2: 4, 3: 3}  # cuDNN modes: relu, tanh, LSTM, GRU


def rnn_flops(seq_len: int, batch: int, input_size: int, hidden: int,
              gates: int, num_layers: int = 1, dirs: int = 1) -> int:
    """An RNN's forward matrix products: each layer and direction projects
    all inputs once (``seq_len x batch x input x gates*hidden``) and the
    state at every step (``batch x hidden x gates*hidden``).  The products
    of JAX's ``_gru_scan`` (islam_tpu/imu/denoiser.py:52-72) and of the
    CPU's decomposed ``nn.GRU``."""
    n = 0
    for layer in range(num_layers):
        inp = input_size if layer == 0 else hidden * dirs
        n += dirs * 2 * seq_len * batch * gates * hidden * (inp + hidden)
    return n


def rnn_backward_flops(seq_len: int, batch: int, input_size: int,
                       hidden: int, gates: int, output_mask) -> int:
    """One layer's backward matrix products as the CPU's decomposition
    runs them: the input gradient (``output_mask[0]``), the state's through
    every step but the first (and into ``hx`` with ``output_mask[1]``), the
    weight gradients (``output_mask[3]``)."""
    g = gates * hidden
    n = 2 * batch * hidden * g * (seq_len - 1 + bool(output_mask[1]))
    if output_mask[0]:
        n += 2 * seq_len * batch * input_size * g
    if output_mask[3]:
        n += 2 * seq_len * batch * g * (input_size + hidden)
    return n


class Op(NamedTuple):
    part: str
    op: str
    kind: str
    module: str
    useful: int
    jax_rule: int


def _shape(t):
    return tuple(t.shape)


def _rnn_shapes(inp, hidden, batch_first, batch_sizes):
    if batch_sizes is not None and len(batch_sizes):
        raise ValueError("flops: packed RNN inputs are not counted")
    T, N = (inp.shape[1], inp.shape[0]) if batch_first else inp.shape[:2]
    return int(T), int(N)


class Count:
    """A ``FlopCounterMode`` that also records, op by op, the part (by the
    innermost frame of ``_PART_FILES`` on the stack, else 'backward' in the
    autograd engine, else 'other'), the module, the useful count and the
    JAX rule's.  ``ops`` holds the records."""

    def __init__(self):
        self.ops: list[Op] = []
        self.mode = None

    def _part(self) -> str:
        f = sys._getframe(1)
        while f is not None:
            name = f.f_code.co_filename
            for prefix, part in _PART_FILES:
                if name.startswith(prefix):
                    return part
            f = f.f_back
        if torch._C._current_graph_task_id() != -1:
            return "backward"
        return "other"

    def _module(self) -> str:
        parents = self.mode.mod_tracker.parents if self.mode else ()
        return max(parents, key=len, default="")

    def _record(self, kind, useful, jax_rule, op):
        self.ops.append(Op(self._part(), op, kind, self._module(),
                           int(useful), int(jax_rule)))
        return int(useful)

    def _mapping(self):
        def wrap(packet, formula, jax_rule, kind):
            def counted(*args, out_val=None, **kwargs):
                useful = formula(*args, out_val=out_val, **kwargs) if formula \
                    else 0
                j = useful if jax_rule is None else jax_rule(
                    *args, out_val=out_val, **kwargs)
                k = kind(*args) if callable(kind) else kind
                return self._record(k, useful, j, packet.__name__)
            counted._get_raw = True
            return counted

        def conv_fwd(x, w, bias, stride, padding, dilation, transposed,
                     output_padding, groups, out_val=None, **kw):
            return conv_jax_rule(_shape(x), _shape(w), _shape(out_val), groups)

        def conv_kind(x, w, bias, stride, padding, dilation, transposed,
                      *a, **kw):
            return "transposed_conv" if transposed else "conv"

        def conv_bwd(g, x, w, bias_sizes, stride, padding, dilation,
                     transposed, output_padding, groups, output_mask,
                     out_val=None, **kw):
            return conv_backward_jax_rule(_shape(g), _shape(x), _shape(w),
                                          groups, output_mask)

        def resize(x, output_size, align_corners, *a, out_val=None, **kw):
            return resize_jax_rule(_shape(x), _shape(out_val),
                                   bool(align_corners))

        def rnn(inp, weight, stride0, weight_buf, hx, cx, mode, hidden,
                proj_size, num_layers, batch_first, dropout, train,
                bidirectional, batch_sizes, *a, out_val=None, **kw):
            if proj_size:
                raise ValueError("flops: projected RNNs are not counted")
            T, N = _rnn_shapes(inp, hidden, batch_first, batch_sizes)
            return rnn_flops(T, N, inp.shape[-1], hidden, _RNN_GATES[mode],
                             num_layers, 2 if bidirectional else 1)

        def rnn_bwd(inp, weight, stride0, weight_buf, hx, cx, output,
                    grad_output, grad_hy, grad_cy, mode, hidden, proj_size,
                    num_layers, batch_first, dropout, train, bidirectional,
                    batch_sizes, dropout_state, reserve, output_mask,
                    out_val=None, **kw):
            if num_layers != 1 or bidirectional or proj_size:
                raise ValueError("flops: only one-layer, one-direction RNN "
                                 "backwards are counted")
            T, N = _rnn_shapes(inp, hidden, batch_first, batch_sizes)
            return rnn_backward_flops(T, N, inp.shape[-1], hidden,
                                      _RNN_GATES[mode], output_mask)

        def inv(a, *args, out_val=None, **kw):
            return solve_jax_rule(_shape(a), a.shape[-1])

        def mv(a, b, out_val=None, **kw):
            return 2 * _numel(a.shape)

        # Under the mode only the outermost op of a call is seen: for a
        # convolution, ``aten.convolution``; the registry's other entries
        # are matrix products (and attention, none on this path).
        mapping = {}
        for packet, formula in flop_registry.items():
            if not isinstance(packet, torch._ops.OpOverloadPacket):
                continue  # higher-order attention ops
            if packet is aten.convolution_backward:
                mapping[packet] = wrap(packet, formula, conv_bwd, "conv_grad")
            elif packet is aten.convolution:
                mapping[packet] = wrap(packet, formula, conv_fwd, conv_kind)
            else:
                mapping[packet] = wrap(packet, formula, None, "matmul")
        mapping[aten.upsample_bilinear2d] = wrap(
            aten.upsample_bilinear2d, None, resize, "resize")
        mapping[aten._cudnn_rnn] = wrap(aten._cudnn_rnn, rnn, None, "rnn")
        mapping[aten._cudnn_rnn_backward] = wrap(
            aten._cudnn_rnn_backward, rnn_bwd, None, "rnn")
        mapping[aten.linalg_inv_ex] = wrap(aten.linalg_inv_ex, None, inv,
                                           "solve")
        # matrix-vector products (the LM's), which FlopCounterMode skips
        mapping[aten.mv] = wrap(aten.mv, mv, None, "matmul")
        return mapping

    def __enter__(self):
        self.mode = FlopCounterMode(display=False,
                                    custom_mapping=self._mapping())
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def total(self, rule: str = "useful") -> int:
        return sum(getattr(o, rule) for o in self.ops)

    def by_part(self) -> dict:
        """{part: [useful, jax_rule]} for every part in ``PARTS``."""
        out = {p: [0, 0] for p in PARTS}
        for o in self.ops:
            out[o.part][0] += o.useful
            out[o.part][1] += o.jax_rule
        return out

    def rule_difference(self, top: int = 8):
        """JAX's rule less the useful count: by op kind, and the ``top``
        modules (a module path, '(backward)' appended in the backward) that
        make most of it."""
        kinds, mods = defaultdict(int), defaultdict(int)
        for o in self.ops:
            d = o.jax_rule - o.useful
            if d:
                kinds[o.kind] += d
                mods[o.module + (" (backward)" if o.part == "backward"
                                 else "")] += d
        return dict(kinds), sorted(mods.items(), key=lambda kv: -kv[1])[:top]


def recording_correlation(levels):
    """A stand-in for ``pwcnet.correlation`` that records each call's
    (B, C, H, W) and calls the real one."""
    from islam_tpu_torch.ops import correlation as corr

    def counted(f1, f2, md=corr.MD_DEFAULT):
        levels.append(list(f1.shape))
        return corr.correlation(f1, f2, md)
    return counted


def _op_by_op_solve(residual_fn, inputs, nodes0, vels0, config, key=None):
    """``lm_solve_graphed`` without its graph: the solve's ops run, and are
    counted, one by one (what it does on the CPU)."""
    from islam_tpu_torch.pvgo import lm
    return lm.lm_solve_graphed(residual_fn, inputs, nodes0, vels0, config)


def count_step(fn):
    """Runs ``fn()`` under a ``Count``, with the LM solved op by op and the
    correlation's calls recorded.  Returns (Count, the correlation's
    (B, C, H, W) per call)."""
    from islam_tpu_torch.models import pwcnet
    from islam_tpu_torch.pvgo import run
    levels = []
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            pwcnet, "correlation", recording_correlation(levels)))
        stack.enter_context(mock.patch.object(
            run, "lm_solve_graphed", _op_by_op_solve))
        count = stack.enter_context(Count())
        fn()
    return count, levels


SEED_DENOISER = "seed-1"


def train_step_flops(h: int = 448, w: int = 640, b: int = 8,
                     bf16: bool = True, target: str = "vo", device="cuda",
                     model=None, denoiser=SEED_DENOISER) -> dict:
    """Count one ``train_step`` of the first window (see the module's
    docstring); ``target`` '' is an eval window.  ``model`` defaults to
    seed-0 VO weights and ``denoiser`` to a seed-1 denoiser (None: none,
    as an eval-only run has): the count does not depend on the weights.
    Returns the report: TFLOPs unrounded, and the exact counts in
    ``flops``."""
    from islam_tpu_torch import testing
    from islam_tpu_torch.imu.denoiser import init_denoiser
    from islam_tpu_torch.models.tartanvo import init_model
    from islam_tpu_torch.train import train_step

    if target not in ("", "vo", "imu"):
        raise ValueError(f"flops: target '', 'vo' or 'imu', not {target!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flops: no CUDA device (use --device cpu --quick)")
    ds = testing.make_dataset(num_frames=b + 1, height=h, width=w)
    imu = testing.make_imu_module(ds, batch_frames=b, device=device)
    model = model if model is not None else init_model(h, w, 0, device)
    if denoiser is SEED_DENOISER:
        denoiser = init_denoiser(1, device)
    batch, win, init = testing.make_step_inputs(ds, imu, 0, b, device=device)
    pose = torch.tensor(ds.rgb2imu_pose, dtype=torch.float32, device=device)

    def step():
        train_step(model, batch, win, init, pose, imu.gravity,
                   imu.accel_bias, imu.gyro_bias,
                   torch.tensor(False, device=device), target=target,
                   denoiser=denoiser, datatype="kitti", correct_scale=False,
                   use_kitti_coord=True, denoise_accel=True,
                   denoise_gyro=False, loss_weight=(1.0, 0.1, 10.0, 0.1),
                   rot_w=1.0, trans_w=0.1, bf16=bf16)

    count, levels = count_step(step)
    parts = count.by_part()
    kinds, mods = count.rule_difference()
    corr_macs = sum(CORR_SHIFTS * _numel(s) for s in levels)
    return {
        "h": h, "w": w, "b": b, "bf16": bf16, "target": target,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "model_tflops": count.total("useful") / 1e12,
        "model_tflops_jax_rule": count.total("jax_rule") / 1e12,
        "parts_tflops": {p: {"model": u / 1e12, "jax_rule": j / 1e12}
                         for p, (u, j) in parts.items()},
        "pvgo_mflops": parts["pvgo"][0] / 1e6,
        "jax_rule_minus_model_tflops": {
            "by_kind": {k: v / 1e12 for k, v in kinds.items()},
            "by_module": [[m, v / 1e12] for m, v in mods]},
        "correlation": {"calls_b_c_h_w": levels,
                        "multiply_adds": corr_macs,
                        "note": "not in the model FLOPs: elementwise in JAX"},
        "flops": {"model": count.total("useful"),
                  "jax_rule": count.total("jax_rule"), "parts": parts},
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="64x128, B=2 (default 448x640, B=8)")
    p.add_argument("--target", default="vo", choices=["vo", "imu"])
    p.add_argument("--f32", action="store_true",
                   help="float32 networks (default bfloat16, as JAX's tool)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    h, w, b = (64, 128, 2) if a.quick else (448, 640, 8)
    info = train_step_flops(h, w, b, bf16=not a.f32, target=a.target,
                            device=a.device)
    if torch.device(a.device).type == "cuda":
        info["card"] = h100.card_line()
    info["note"] = ("conv and matmul model FLOPs (fwd+bwd; the LM at 10 "
                    "steps); divide by time and peak for an MFU")
    print(json.dumps(info), flush=True)
    return info


if __name__ == "__main__":
    main()
