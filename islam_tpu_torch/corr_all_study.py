"""What holds the all-shift correlation kernel (``csrc/correlation_all_sm90.cu``)
at the five pyramid levels of one 448x640, B=8 VO forward, on the card.

    python -m islam_tpu_torch.corr_all_study parts [--levels 2 3 4]
    python -m islam_tpu_torch.corr_all_study plans

``parts`` times the kernel beside copies of its source with one part
switched off: the global stores, the band writes and the stores, the
tensor-core sums, or (in the copy-staged instantiations) the loads.  Each
copy is built like the kernel and launched with the level's own plan; the
results of the copies are wrong by design and are not checked.  ``plans``
times every plan of ``ry`` rows and ``ns`` channel slices that fits, checks
each against the plain version, and prints the six fastest per level and
dtype beside the chosen one.  Times are CUDA-event medians of 21 launches
with the L2 cache flushed (``bench_corr.time_ms``); one JSON line per level
and dtype.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json

import torch

from islam_tpu_torch import bench_corr
from islam_tpu_torch.ops import correlation as corr

SYMBOL = "islam_corr_fwd_all_sm90"
_STORE = ("      store4(ob + o * plane + static_cast<size_t>(y) * g.W + x, v);",
          "      if (v.x == 12345.f) "
          "store4(ob + o * plane + static_cast<size_t>(y) * g.W + x, v);")
_BAND = ("        if (dx >= 0 && dx < ND) "
         "mine[(dy * ND + dx) * BP + m] = acc[dy][nf][i];",
         "        if (acc[dy][nf][i] == 12345.f) mine[0] = 1.f;")
# (text in the kernel source, its replacement): the replacements keep the
# accumulators live, so the compiler removes only the part named
PARTS = {
    "full": [],
    "no_global_store": [_STORE],
    "no_band_no_store": [_BAND, _STORE],
    "no_mma": [("    chunk_sums(acc, reinterpret_cast<const T*>(sp),",
                "    acc[0][0][0] += float(reinterpret_cast<const T*>(sp)"
                "[threadIdx.x]);\n    if (acc[0][0][0] == 12345.f) "
                "chunk_sums(acc, reinterpret_cast<const T*>(sp),")],
    "no_load": [("  const int c0 = ch * g.kc;",
                 "  return;\n  const int c0 = ch * g.kc;")],
}


def _variant(name, build_dir):
    """Build the source with part ``name`` switched off; its C entry."""
    text = corr.SOURCES[SYMBOL].read_text()
    for old, new in PARTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel source changed: {old!r}")
        text = text.replace(old, new)
    src = build_dir / f"corr_all_{name}.cu"
    src.write_text(text)
    fn = getattr(ctypes.CDLL(str(corr.build_library(src))), SYMBOL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ctypes.c_float, i32,
                   *[i32] * 9, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launcher(fn, f1, f2, out, p):
    B, C, H, W = f1.shape

    def call():
        rc = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
                1.0 / C, corr._DTYPES[f1.dtype], p.vec, p.ry, p.ns, p.kc,
                *p.grid, p.block, p.smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def _levels(indices):
    for i in indices:
        C, H, W = bench_corr.LEVELS[i]
        for dname, dtype in bench_corr.DTYPES.items():
            yield (8, C, H, W), dname, dtype


def parts(indices):
    build_dir = corr._BUILD_DIR / "study"
    build_dir.mkdir(parents=True, exist_ok=True)
    fns = {name: _variant(name, build_dir) for name in PARTS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    for shape, dname, dtype in _levels(indices):
        f1, f2 = bench_corr.feature_pair(shape, dtype, gen, "cuda")
        out = torch.empty((8, 81, *shape[2:]), dtype=dtype, device="cuda")
        p = corr._plan_all_sm90(*shape, dtype, corr._alignment(f1, f2))
        row = {"level": list(shape[1:]), "dtype": dname, "plan": p._asdict()}
        for name, fn in fns.items():
            if name == "no_load" and p.vec == corr._ALL_TMA:
                continue  # the waits on TMA barriers need the loads
            call = _launcher(fn, f1, f2, out, p)
            call()
            torch.cuda.synchronize()
            row[f"{name}_ms"] = bench_corr.time_ms(call, flush)
        print(json.dumps(row), flush=True)


def plans(indices):
    corr.build_library(corr.SOURCES[SYMBOL])
    fn = corr.load_kernel(SYMBOL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    for shape, dname, dtype in _levels(indices):
        f1, f2 = bench_corr.feature_pair(shape, dtype, gen, "cuda")
        ref = corr.correlation_reference(f1, f2).float()
        tol = bench_corr.TOL[dname] * ref.abs().max().item()
        out = torch.empty((8, 81, *shape[2:]), dtype=dtype, device="cuda")
        chosen = corr._plan_all_sm90(*shape, dtype, corr._alignment(f1, f2))
        rows = []
        for ry, ns in itertools.product((1, 2, 4, 8), (1, 2, 3, 4, 6, 7, 8)):
            p = corr._all_sm90_launch(*shape, corr._ITEMSIZE[dtype],
                                      chosen.vec, ry, ns)
            if p.block > 256 or p.smem > corr._SMEM_MAX or ns * 16 > 2 * (
                    shape[1] + 15):
                continue
            call = _launcher(fn, f1, f2, out, p)
            call()
            torch.cuda.synchronize()
            if not (out.float() - ref).abs().max().item() <= tol:
                raise AssertionError(f"plan {p} disagrees at {shape}")
            rows.append({"ry": ry, "ns": ns, "grid": p.grid[0],
                         "ms": bench_corr.time_ms(call, flush)})
        rows.sort(key=lambda r: r["ms"])
        print(json.dumps({"level": list(shape[1:]), "dtype": dname,
                          "chosen": {"ry": chosen.ry, "ns": chosen.ns},
                          "fastest": rows[:6]}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("study", choices=["parts", "plans"])
    p.add_argument("--levels", type=int, nargs="+", default=[0, 1, 2, 3, 4],
                   help="indices into bench_corr.LEVELS")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("corr_all_study: no CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    {"parts": parts, "plans": plans}[a.study](a.levels)


if __name__ == "__main__":
    main()
