"""The result line: the metrics with their units, the device, and each
compared number beside its limit."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch


def checks(limits, numbers) -> dict:
    """{name: {'value', 'limit'}} of the numbers the cell compares: those
    its cell file gives a limit."""
    numbers = dict(numbers)
    return {name: {"value": numbers[name], "limit": limit}
            for name, limit in limits.items()}


def correct(checked) -> bool:
    """Every compared number is finite and within its limit."""
    return bool(checked) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values())


def line(cell, result, numbers, traced: bool) -> dict:
    checked = checks(cell.spec["limits"], numbers)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {m["name"]: {"value": result["metrics"][m["name"]],
                           "unit": m["unit"]}
               for m in wanted if m["name"] in result["metrics"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(result["peak"])}
    if traced and result["busy"] is not None:
        device["busy_s"], device["window_s"] = result["busy"]
    out = {"correct": correct(checked), "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": device}
    if traced:
        out["breakdown"] = result["breakdown"]
    out["checks"] = checked
    return out


def print_checks(checks) -> None:
    """Each compared number and its limit, as the last lines of standard
    error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()


def failed_windows(windows) -> int:
    """Windows of the timed epoch with a non-finite answer."""
    return sum(not all(np.isfinite(np.asarray(w[k])).all() for k in (
        "motions", "imu_poses", "pgo_poses", "pgo_vels")) for w in windows)
