"""What a cell is made of, found by name: ``BENCHMARK.json``'s entries,
the configuration's file, the traffic mix's file (``traffic/<name>.json``),
the cell's own file (``cells/<name>.json``: the window's pace and the
limits of its comparison) and each metric's reader
(``metrics/<name>.py``)."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict            # cells/<name>.json
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises if either is
    missing."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    spec = json.loads((BENCH / "cells" / f"{name}.json").read_text())
    return Cell(name, cell["chips"], config, traffic, spec,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric}").read
