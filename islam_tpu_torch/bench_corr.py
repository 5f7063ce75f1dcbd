"""Race of the four correlation kernels, at the five pyramid levels of
one 448x640, B=8 VO forward.

    python -m islam_tpu_torch.bench_corr [--device cuda|cpu] [--batch 8]

Counterpart of ``scripts/bench_corr.py``, which races the two Pallas
variants.  Here the four hand-written CUDA kernels race:

- ``correlation`` (``csrc/correlation_sm90.cu``, the main path's kernel,
  designed for Hopper): 4 x 9 sums a thread, cp.async staging, a grid that
  fills the card at every level;
- ``correlation_81`` (``csrc/correlation.cu``, PR 1's port of
  ``_corr_dy_kernel``, the baseline): all 81 sums of a pixel in one thread;
- ``correlation_all`` (``csrc/correlation_all_sm90.cu``, the port of
  ``_corr_all_kernel`` designed for Hopper): all 81 shifts per block, sums
  on the tensor cores as banded products (bf16 mma, 3xTF32 for f32);
- ``correlation_all_dy`` (``csrc/correlation_dy.cu``, PR 2's port of
  ``_corr_all_kernel``, its baseline): one row shift per block, 9 sums a
  thread.

At each level and in float32 (what the main path runs) and bfloat16 (what
the JAX script times), it checks every kernel against the plain version and
against each other kernel (tolerances ``TOL`` x max|plain|), then times
them and the plain version: medians of CUDA-event times with the L2 cache
flushed before each launch.  It prints one JSON line per level and a total
line.  ``--device cpu`` runs the checks through the dispatchers (all are the
plain version there) and times nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from islam_tpu_torch.ops import correlation as corr
from islam_tpu_torch.tools import h100

LEVELS = [(196, 7, 10), (128, 14, 20), (96, 28, 40), (64, 56, 80),
          (32, 112, 160)]  # (C, H, W)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Kernel vs plain version, as a share of max|plain|: float32 sums of up to
# 196 products in another order (a few ulp); bfloat16 output rounding.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def bound_ms(shape, dtype_name):
    """The least time the card could take for one call: the larger of the
    bytes (both inputs read once, the 81-channel output written once) over
    the memory rate and the multiply-adds over the peak rate of the type
    (``tools/h100.py``).
    Returns (ms, "bytes" or "operations")."""
    B, C, H, W = shape
    itemsize = torch.empty((), dtype=DTYPES[dtype_name]).element_size()
    t_bytes = ((2 * B * C * H * W + B * 81 * H * W) * itemsize
               / h100.HBM_BYTES_PER_S)
    t_ops = 2 * 81 * B * C * H * W / h100.PEAK_FLOP_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, flush, reps=21, warmup=3):
    """Median CUDA-event time of ``fn`` in ms, with the L2 cache flushed
    (``flush``, a buffer larger than L2, is rewritten) before each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def feature_pair(shape, dtype, gen, device):
    """f1, f2 drawn independently, as the main path gives them at levels 5
    to 2 (f2 is the warped second feature map, a tensor of its own) and as
    ``scripts/bench_corr.py`` draws them.  No f2 line is in L2 as another
    image's f1."""
    f1, f2 = (torch.randn(shape, generator=gen, device=device).to(dtype)
              for _ in range(2))
    return f1, f2


def kernels(device):
    """{name: function} of the four kernels' wrappers on a CUDA device, and
    of their dispatchers (the plain version) on the CPU."""
    if device.type == "cuda":
        return {"correlation": corr.correlation_cuda,
                "correlation_81": corr.correlation_81_cuda,
                "correlation_all": corr.correlation_all_cuda,
                "correlation_all_dy": corr.correlation_all_dy_cuda}
    return {"correlation": corr.correlation,
            "correlation_81": corr.correlation_81,
            "correlation_all": corr.correlation_all,
            "correlation_all_dy": corr.correlation_all_dy}


def check(f1, f2, fns, dtype_name):
    """Every kernel against the plain version and against every other
    kernel; raises if one is off by more than TOL x max|plain|.  Returns the
    errors (``<a>_vs_<b>_max_abs_diff`` for each pair)."""
    ref = corr.correlation_reference(f1, f2).float()
    scale = ref.abs().max().item()
    outs = {}
    for name, fn in fns.items():
        out = fn(f1, f2)
        if out.dtype != f1.dtype or out.shape != ref.shape:
            raise AssertionError(f"{name}: {out.dtype} {tuple(out.shape)}")
        outs[name] = out.float()
    errs = {f"{n}_max_abs_err": (o - ref).abs().max().item()
            for n, o in outs.items()}
    names = list(outs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            errs[f"{a}_vs_{b}_max_abs_diff"] = (
                outs[a] - outs[b]).abs().max().item()
    errs["tol"] = TOL[dtype_name] * scale
    bad = {k: v for k, v in errs.items() if not v <= errs["tol"]}
    if bad:
        raise AssertionError(f"correlation kernels disagree at "
                             f"{tuple(f1.shape)} {dtype_name}: {bad}")
    return errs


def run(device="cuda", batch=8, levels=LEVELS):
    """One row per level: the checks and, on a CUDA device, the times."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_corr: no CUDA device (use --device cpu)")
    fns = kernels(device)
    gen = torch.Generator(device=device).manual_seed(0)
    flush = (torch.empty(64 * 2 ** 20, dtype=torch.float32, device=device)
             if on_card else None)  # 256 MB > the 50 MB L2
    rows = []
    with torch.no_grad():
        for C, H, W in levels:
            shape = (batch, C, H, W)
            row = {"level": [C, H, W], "batch": batch}
            for dname, dtype in DTYPES.items():
                f1, f2 = feature_pair(shape, dtype, gen, device)
                r = check(f1, f2, fns, dname)
                r["bound_ms"], r["bound_by"] = bound_ms(shape, dname)
                align = corr._alignment(f1, f2)
                r["correlation_plan"] = corr._plan_sm90(
                    *shape, dtype, align)._asdict()
                r["correlation_all_plan"] = corr._plan_all_sm90(
                    *shape, dtype, align)._asdict()
                for name, fn in (*fns.items(),
                                 ("plain", corr.correlation_reference)):
                    r[f"{name}_ms"] = (
                        time_ms(lambda: fn(f1, f2), flush) if on_card
                        else None)  # not measured off the card
                row[dname] = r
            rows.append(row)
    return rows


def totals(rows):
    """Per dtype: each time summed over the levels (one VO forward)."""
    out = {}
    for dname in DTYPES:
        rs = [r[dname] for r in rows]
        out[dname] = {k: (None if rs[0][k] is None
                          else sum(r[k] for r in rs))
                      for k in ("correlation_ms", "correlation_81_ms",
                                "correlation_all_ms", "correlation_all_dy_ms",
                                "plain_ms", "bound_ms")}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=8)
    a = p.parse_args(argv)
    rows = run(a.device, a.batch)
    for row in rows:
        print(json.dumps(row), flush=True)
    device = (torch.cuda.get_device_name(0) if a.device.startswith("cuda")
              else "cpu")
    print(json.dumps({"total_per_forward": totals(rows), "device": device}),
          flush=True)
    return rows


if __name__ == "__main__":
    main()
