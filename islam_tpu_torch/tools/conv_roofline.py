"""Every convolution family of a profiled window against the H100's
roofline, the correlation kernels beside them, and the window's MFU.

    python -m islam_tpu_torch.tools.conv_roofline [--epoch 0|1|2] [--bf16]
        [--top N]

Counterpart of ``tools/conv_roofline.py``.  The window is
``profile_window``'s (the Trainer at 448x640, B=8, preset flags, warmed
up, one epoch of 3 windows under ``torch.profiler`` with shapes recorded;
``tools/window.py``).  Each ``aten::convolution`` and
``aten::convolution_backward`` is joined to the device kernels it launched
(the profiler's correlation ids: the kernels of the op and of the ops under
it) and grouped into a family by (dtype, input, weight, stride, padding,
dilation, groups, transposed, forward or which gradients).  A family's row:

- calls, and FLOPs by the useful rule of ``tools/flops.py``;
- bytes: input, weight and output once each (JAX's rule, ``hlo_convs``);
  a backward reads the output gradient once, and the weight (for the input
  gradient) and the input (for the weight gradient), and writes the
  gradients it computes;
- device ms per window, TFLOP/s and its share of the dtype's peak (TF32's
  where cuDNN may use it), GB/s and its share of 3.35 TB/s;
- 'compute-bound' or 'bandwidth-bound' at >= 50 % of that roof, else
  'neither';
- the module of its first call.

Each correlation kernel that launched gets a row, its bound from
``bench_corr.bound_ms``.  Every other outermost aten op that launched
kernels (batch norms, activations, resizes, concats, ...) is a row of its
family (op, argument shapes, dtype) against the HBM roof: its tensor
arguments read once and the output it allocated written once.  The share
of the window's device time the rows cover is its own line, by kind (the
convolutions, the correlation, the other ops), beside the kernels no aten
op launched (the detached LM's CUDA graph); so are the MFUs:
``model_tflops`` of ``tools/flops.py`` for the window's target and dtype
over the warm epoch's median window after the first (wall time) and over
the profiled window's device time, each against the dtype's peak.  A step's MFU stays undefined until a benchmark names it; this tool
only prints it.  In float32 a cuDNN kernel whose name says ``tf32`` is
listed under ``tf32_kernels`` (an FP32 roof would be wrong for it).
Needs the card; prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
from collections import Counter

import torch

from islam_tpu_torch.tools import h100
from islam_tpu_torch.tools import window as win
from islam_tpu_torch.tools.flops import (_numel, conv_backward_useful,
                                         conv_useful)

CONV_OPS = ("aten::convolution", "aten::convolution_backward")
# the profiler's type names
DTYPES = {"float": torch.float32, "c10::BFloat16": torch.bfloat16,
          "c10::Half": torch.float16, "double": torch.float64,
          "long int": torch.int64, "int": torch.int32, "bool": torch.bool,
          "unsigned char": torch.uint8}
ROOF_SHARE = 0.5  # a family at >= half a roof is bound by it
# The correlation kernels of the main paths: (row name, kernel symbol)
CORRELATION_KERNELS = (("correlation_fwd_sm90", "corr_sm90_kernel"),
                       ("correlation_all_fwd_sm90", "corr_all_sm90_kernel"))


def conv_output_shape(x, w, stride, padding, dilation, transposed,
                      output_padding, groups):
    """The output shape of ``aten::convolution``."""
    spatial = []
    for i, n in enumerate(x[2:]):
        k = dilation[i] * (w[2 + i] - 1)
        if transposed:
            spatial.append((n - 1) * stride[i] - 2 * padding[i] + k
                           + output_padding[i] + 1)
        else:
            spatial.append((n + 2 * padding[i] - k - 1) // stride[i] + 1)
    cout = w[1] * groups if transposed else w[0]
    return (x[0], cout, *spatial)


class Conv:
    """One convolution op of a trace: its family key, FLOPs and bytes."""

    def __init__(self, evt, dtype_name):
        shapes, args = evt.input_shapes, evt.concrete_inputs
        self.forward = evt.name == "aten::convolution"
        if self.forward:
            x, w = tuple(shapes[0]), tuple(shapes[1])
            stride, padding, dilation, transposed, out_pad, groups = args[3:9]
            self.mask = None
            out = conv_output_shape(x, w, stride, padding, dilation,
                                    transposed, out_pad, groups)
            self.flops = conv_useful(x, w, out, transposed)
            elems = _numel(x) + _numel(w) + _numel(out)
            self.shapes = {"input": x, "weight": w, "output": out}
        else:
            g, x, w = (tuple(s) for s in shapes[:3])
            stride, padding, dilation, transposed, out_pad, groups, \
                mask = args[4:11]
            self.mask = tuple(bool(m) for m in mask[:2])
            self.flops = conv_backward_useful(g, x, w, transposed, mask)
            elems = _numel(g)
            if self.mask[0]:
                elems += _numel(w) + _numel(x)
            if self.mask[1]:
                elems += _numel(x) + _numel(w)
            self.shapes = {"input": x, "weight": w, "output_grad": g}
        self.dtype = DTYPES.get(dtype_name, torch.float32)
        self.bytes = elems * itemsize(dtype_name)
        self.key = (dtype_name, x, w, tuple(stride), tuple(padding),
                    tuple(dilation), int(groups), bool(transposed),
                    "forward" if self.forward else
                    "backward" + "".join(n for n, m in zip(
                        ("[input]", "[weight]"), self.mask) if m))


def conv_ops(events):
    """The convolution ops of a trace, without those nested in another."""
    return [e for e in events if e.name in CONV_OPS and not any(
        a.name in CONV_OPS for a in win.ancestors(e))]


def families(events, dtypes, modules):
    """{family key: {"convs": [Conv], "ms": device ms, "module": the first
    call's module path, "kernels": set of kernel names}}."""
    fams = {}
    for e in conv_ops(events):
        c = Conv(e, (dtypes.get(e.id) or ["float"])[0])
        f = fams.setdefault(c.key, {"convs": [], "ms": 0.0,
                                    "module": modules(e), "kernels": set()})
        f["convs"].append(c)
        ks = win.op_kernels(e)
        f["ms"] += sum(k.duration for k in ks) / 1e3
        f["kernels"].update(k.name for k in ks)
    return fams


def _label(flop_share, byte_share):
    if flop_share >= ROOF_SHARE:
        return "compute-bound"
    if byte_share >= ROOF_SHARE:
        return "bandwidth-bound"
    return "neither"


def family_rows(fams, windows, tf32):
    """One row a family, by device time; rates and labels are None without
    device time (a CPU trace)."""
    rows = []
    for key, f in fams.items():
        c0, n = f["convs"][0], len(f["convs"])
        s = f["ms"] / 1e3
        row = {
            "dtype": str(c0.dtype).replace("torch.", ""),
            "direction": key[-1], **{k: list(v) for k, v in c0.shapes.items()},
            "stride": list(key[3]), "padding": list(key[4]),
            "dilation": list(key[5]), "groups": key[6],
            "transposed": key[7], "calls": n,
            "gflop_per_call": c0.flops / 1e9, "mb_per_call": c0.bytes / 1e6,
            "ms_per_window": f["ms"] / windows, "tflop_per_s": None,
            "pct_flop_roof": None, "gb_per_s": None, "pct_hbm_roof": None,
            "label": None, "module": f["module"]}
        if s:
            flop_share = n * c0.flops / s / h100.peak_flop_per_s(c0.dtype, tf32)
            byte_share = n * c0.bytes / s / h100.HBM_BYTES_PER_S
            row.update(tflop_per_s=n * c0.flops / s / 1e12,
                       pct_flop_roof=100 * flop_share,
                       gb_per_s=n * c0.bytes / s / 1e9,
                       pct_hbm_roof=100 * byte_share,
                       label=_label(flop_share, byte_share))
        rows.append(row)
    rows.sort(key=lambda r: -r["ms_per_window"])
    return rows


def itemsize(dtype_name) -> int:
    """Bytes an element of the profiler's type name (4 if unknown)."""
    dt = DTYPES.get(dtype_name)
    return torch.empty((), dtype=dt).element_size() if dt else 4


def _holds_conv(evt):
    return evt.name in CONV_OPS or any(_holds_conv(c)
                                       for c in evt.cpu_children)


def other_ops(events):
    """The outermost aten ops of a trace that launched kernels, but those
    that are or hold a convolution (``aten::conv2d`` holds one)."""
    return [e for e in events
            if e.name.startswith("aten::") and e.device_type != win.DEVICE
            and not any(a.name.startswith("aten::")
                        for a in win.ancestors(e))
            and win.op_kernels(e) and not _holds_conv(e)]


def op_bytes(evt, dtypes) -> int:
    """An op's bytes: its tensor arguments read once and its output written
    once.  The output is what the op allocated (``window.allocated_bytes``),
    or for an in-place op its largest argument; a cat reads what it
    writes (the profiler keeps no shapes of a tensor list)."""
    dt = dtypes.get(evt.id) or []
    ins = [_numel(s) * itemsize(dt[i] if i < len(dt) else "float")
           for i, s in enumerate(evt.input_shapes) if s]
    out = win.allocated_bytes(evt) or max(ins, default=0)
    return (2 * out if evt.name == "aten::cat" else sum(ins) + out)


def op_rows(events, dtypes, modules, windows):
    """A row for each family of other ops, by (op, argument shapes, dtype):
    calls, device ms, bytes, GB/s and its share of the HBM rate (their
    multiply-adds, if any, are not counted)."""
    fams = {}
    for e in other_ops(events):
        dt = (dtypes.get(e.id) or [""])[0]
        key = (e.name, json.dumps([s for s in e.input_shapes if s]), dt)
        f = fams.setdefault(key, {"calls": 0, "bytes": 0, "ms": 0.0,
                                  "module": modules(e)})
        f["calls"] += 1
        f["bytes"] += op_bytes(e, dtypes)
        f["ms"] += win.op_device_ms(e)
    rows = []
    for (name, shapes, dt), f in fams.items():
        byte_share = (f["bytes"] / (f["ms"] / 1e3) / h100.HBM_BYTES_PER_S
                      if f["ms"] else None)
        rows.append({
            "op": name, "shapes": json.loads(shapes), "dtype": dt,
            "calls": f["calls"], "mb_per_call": f["bytes"] / f["calls"] / 1e6,
            "ms_per_window": f["ms"] / windows,
            "pct_hbm_roof": None if byte_share is None else 100 * byte_share,
            "label": None if byte_share is None else _label(0, byte_share),
            "module": f["module"]})
    rows.sort(key=lambda r: -r["ms_per_window"])
    return rows


def unattributed_kernels(events, windows, top=8):
    """Device time of kernels that no aten op launched (a CUDA graph's
    replay, the correlation's ctypes launches): (ms per window, the
    ``top`` kernel names by time)."""
    device = Counter()
    for e in win.device_events(events):
        device[e.name] += e.time_range.elapsed_us()
    for e in events:
        if e.name.startswith("aten::") and e.device_type != win.DEVICE and \
                not any(a.name.startswith("aten::")
                        for a in win.ancestors(e)):
            for k in win.op_kernels(e):
                device[k.name] -= k.duration
    rest = {k: v for k, v in device.items() if v > 0}
    names = sorted(rest, key=lambda k: -rest[k])[:top]
    return (sum(rest.values()) / 1e3 / windows,
            [{"kernel": k[:100], "ms_per_window": rest[k] / 1e3 / windows}
             for k in names])


def correlation_rows(events, shapes, dtype, windows):
    """A row for each correlation kernel that launched in the trace: its
    device time against the bound of the calls' shapes."""
    from islam_tpu_torch import bench_corr

    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    bound = sum(bench_corr.bound_ms(s, name)[0] for s in shapes)
    flops = sum(2 * 81 * _numel(s) for s in shapes)
    rows = []
    for row, symbol in CORRELATION_KERNELS:
        ks = [e for e in win.device_events(events) if symbol in e.name]
        if not ks:
            continue
        ms = sum(e.time_range.elapsed_us() for e in ks) / 1e3
        rows.append({"name": row, "calls": len(ks), "dtype": name,
                     "ms_per_window": ms / windows,
                     "bound_ms_per_window": bound / windows,
                     "pct_of_bound": 100 * bound / ms,
                     "tflop_per_s": flops / ms / 1e9})
    return rows


def tf32_kernels(fams):
    """The float32 families' kernels whose name says tf32."""
    return sorted({k for f in fams.values() if f["convs"][0].dtype ==
                   torch.float32 for k in f["kernels"] if "tf32" in k.lower()})


def mfu(model_tflops, seconds, dtype, tf32=False):
    """``model_tflops`` done in ``seconds`` as a share of the dtype's peak;
    None without a time."""
    if not seconds:
        return None
    return model_tflops * 1e12 / seconds / h100.peak_flop_per_s(dtype, tf32)


def roofline(w: "win.Window", model_tflops=None, top=None) -> dict:
    """The roofline report of a profiled window.  ``model_tflops`` (the
    window step's useful TFLOPs) adds the MFU lines."""
    events = w.prof.events()
    dtype = torch.bfloat16 if w.trainer.args.bf16 else torch.float32
    tf32 = torch.backends.cudnn.allow_tf32
    dtypes, modules = win.dtypes_by_id(w.prof), win.Modules(events)
    fams = families(events, dtypes, modules)
    rows = family_rows(fams, w.windows, tf32)
    ops = op_rows(events, dtypes, modules, w.windows)
    corr = correlation_rows(events, w.correlation_shapes, dtype, w.windows)
    device_ms = win.device_ms(events) / w.windows
    rest_ms, rest = unattributed_kernels(events, w.windows)
    ms = {"convolutions": sum(r["ms_per_window"] for r in rows),
          "correlation": sum(r["ms_per_window"] for r in corr),
          "other_ops": sum(r["ms_per_window"] for r in ops)}

    def share(x):
        return x / device_ms if device_ms else None

    out = {
        "epoch": w.epoch, "target": w.trainer.train_target[w.epoch],
        "dtype": str(dtype).replace("torch.", ""),
        "concat_free": w.trainer.concat_free, "windows": w.windows,
        "tf32_flags": h100.tf32_flags(),
        "window_ms": w.wall_ms,
        "window_ms_median": statistics.median(w.wall_ms[1:]),
        "device_ms_per_window": device_ms,
        "ms_per_window": ms,
        "covered_share": share(sum(ms.values())),
        "shares": {k: share(v) for k, v in ms.items()},
        "unattributed_ms_per_window": rest_ms, "unattributed_top": rest,
        "families": len(rows), "conv_calls": sum(r["calls"] for r in rows),
        "conv_labels_ms": {lab: sum(r["ms_per_window"] for r in rows
                                    if r["label"] == lab)
                           for lab in ("compute-bound", "bandwidth-bound",
                                       "neither")},
        "op_labels_ms": {lab: sum(r["ms_per_window"] for r in ops
                                  if r["label"] == lab)
                         for lab in ("bandwidth-bound", "neither")},
        "correlation_launches": w.correlation_launches,
        "correlation": corr,
        "tf32_kernels": tf32_kernels(fams) if dtype == torch.float32 else [],
        "rows": rows[:top] if top else rows,
        "op_rows": ops[:top] if top else ops,
    }
    if model_tflops is not None:
        out["model_tflops"] = model_tflops
        out["mfu_wall"] = mfu(model_tflops, out["window_ms_median"] / 1e3,
                              dtype, tf32)
        out["mfu_device"] = mfu(model_tflops, device_ms / 1e3, dtype, tf32)
    return out


def window_model_tflops(w: "win.Window") -> float:
    """``model_tflops`` of the window's step: its target and dtype, its
    networks, at 448x640, B=8."""
    from islam_tpu_torch import profile_window
    from islam_tpu_torch.tools import flops
    t = w.trainer
    return flops.train_step_flops(
        profile_window.HEIGHT, profile_window.WIDTH, profile_window.BATCH,
        bf16=t.args.bf16, target=t.train_target[w.epoch], device="cuda",
        model=t.model, denoiser=t.denoiser)["model_tflops"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epoch", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--top", type=int, default=25, help="families listed")
    a = p.parse_args(argv)
    h100.require_card("conv_roofline")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = win.profile(a.epoch, bf16=a.bf16)
    out = roofline(w, window_model_tflops(w), a.top)
    out["card"] = h100.card_line()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
