"""The benchmark of islam_tpu_torch on the card: one run of one cell.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It makes the cell's drive and weights from
the seed, sets up the program (the preset's trainer) and warms up the
cell's shapes, runs the timed epoch, and compares what it produced with the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error.  It exits non-zero
and prints no result without enough CUDA devices, and where the process
has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache of the program at a fixed path in the
# checkout, so that only a checkout's first run builds.
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "islam_tpu")


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    a = _args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec
    cell = spec.load(a.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"run.py: {a.workload} needs {cell.chips} CUDA device(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench.harness import cell as runner
    from portbench.harness import report
    result, numbers = runner.run(cell, a.seed, a.seconds, bool(a.trace),
                                 START)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}; the benchmark may not "
              "import JAX or the JAX package", file=sys.stderr)
        return 4
    line = report.line(cell, result, numbers, bool(a.trace))
    report.print_checks(line["checks"])
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
