"""Time of the PVGO Levenberg-Marquardt solve of one window, on the card.

    python -m islam_tpu_torch.bench_lm [--device cuda|cpu] [--reps 21]

One window's graph at the presets' B=8: 9 nodes and velocities, 8 VO edges
and IMU deltas of a smooth forward chain (0.5 m a frame), the VO motions
perturbed by 0.02 and the start's translations by 0.05 and velocities by
0.1, drawn from seeds 0-3, with the presets' weights (1, 0.1, 10, 0.1), in
float32.  Per problem it runs ``pvgo.lm.lm_solve_manifold`` (op by op) and,
where the checkout has it, ``lm_solve_graphed`` (one CUDA graph replay, as
the detached PVGO solve runs on the card) ``--reps`` times each and prints
one JSON line: the median wall ms of a solve (the device synchronized after
it, so host reads inside the solve count) and its median device ms (CUDA
events), the steps it took, the final cost, and the largest difference of
its nodes and velocities from the op-by-op solve's.  It needs only
``lm_solve_manifold``, ``LMConfig``, ``graph.pvgo_residuals`` and ``lie``,
so a copy of it times an older checkout's solve the same way.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from islam_tpu_torch import lie
from islam_tpu_torch.pvgo import graph, lm

B = 8
WEIGHTS = (1.0, 0.1, 10.0, 0.1)


def problem(seed: int, device):
    """(residual_fn, inputs, nodes0, vels0) of one window's graph from
    ``seed``; ``residual_fn(nodes, vels, inputs)`` reads no other
    tensor."""
    rng = np.random.default_rng(seed)
    xi = np.tile([0.5, 0.02, -0.01, 0.01, 0.03, 0.005], (B, 1))
    xi = xi + rng.normal(size=(B, 6)) * 0.01

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    gt_motions = lie.se3_exp(t(xi))
    poses = [t([0, 0, 0, 0, 0, 0, 1])]
    for m in gt_motions:
        poses.append(lie.se3_mul(poses[-1], m))
    poses = torch.stack(poses)
    dt = 0.1
    trans = poses[:, :3]
    vels = torch.cat([(trans[1:] - trans[:-1]) / dt,
                      (trans[-1:] - trans[-2:-1]) / dt])
    drots = lie.quat_mul(lie.quat_conj(poses[:-1, 3:]), poses[1:, 3:])
    dvels = vels[1:] - vels[:-1]
    dtrans = (trans[1:] - trans[:-1]) - vels[:-1] * dt
    vo = lie.se3_mul(gt_motions, lie.se3_exp(t(rng.normal(size=(B, 6))
                                               * 0.02)))
    links = torch.stack([torch.arange(B), torch.arange(B) + 1], 1).to(device)
    dts = torch.full((B,), dt, device=device)
    nodes0 = poses.clone()
    nodes0[1:, :3] += t(rng.normal(size=(B, 3)) * 0.05)
    vels0 = vels + t(rng.normal(size=(B + 1, 3)) * 0.1)

    def residual(nodes, v, inputs):
        blocks = graph.pvgo_residuals(nodes, v, *inputs)
        return torch.cat([(b * w).reshape(-1)
                          for b, w in zip(blocks, WEIGHTS)])

    return (residual, (links, vo, drots, dtrans, dvels, dts), nodes0,
            vels0)


def solvers():
    """name -> solve(residual_fn, inputs, nodes0, vels0)."""
    out = {"op_by_op": lambda res, inputs, n0, v0: lm.lm_solve_manifold(
        lambda n, v: res(n, v, inputs), n0, v0, lm.LMConfig())}
    if hasattr(lm, "lm_solve_graphed"):
        out["graphed"] = lambda res, inputs, n0, v0: lm.lm_solve_graphed(
            res, inputs, n0, v0, lm.LMConfig(), key=("bench_lm", WEIGHTS))
    return out


def time_solve(solve, residual, inputs, nodes0, vels0, reps, device):
    on_card = torch.device(device).type == "cuda"
    walls, devs = [], []
    for _ in range(reps + 2):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = solve(residual, inputs, nodes0, vels0)
        if on_card:
            end.record()
            torch.cuda.synchronize()
            devs.append(start.elapsed_time(end))
        walls.append((time.perf_counter() - t0) * 1e3)
    walls, devs = walls[2:], devs[2:]
    return {"wall_ms": statistics.median(walls),
            "device_ms": statistics.median(devs) if devs else None,
            "steps": int(out[3]), "cost": float(out[2])}, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=21)
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, first = [], {}
    for name, solve in solvers().items():
        for seed in range(4):
            times, out = time_solve(solve, *problem(seed, a.device), a.reps,
                                    a.device)
            row = {"solver": name, "seed": seed, **times}
            # the nodes and velocities against the first solver's
            ref = first.setdefault(seed, out)
            row["max_abs_diff"] = max(float((x - y).abs().max())
                                      for x, y in zip(out[:2], ref[:2]))
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {"device": (torch.cuda.get_device_name(0)
                          if torch.device(a.device).type == "cuda"
                          else "cpu")}
    for name in solvers():
        mine = [r for r in rows if r["solver"] == name]
        summary[name] = {
            "wall_ms_median": statistics.median(r["wall_ms"] for r in mine),
            "device_ms_median": (
                statistics.median(r["device_ms"] for r in mine)
                if mine[0]["device_ms"] is not None else None)}
    print(json.dumps(summary), flush=True)
    return rows


if __name__ == "__main__":
    main()
