"""The trace reader: host ops around a launch, the device's busy time and
its idle stretches, and a CPU profile read end to end (no device events,
so nothing is busy)."""

import torch
from torch.profiler import ProfilerActivity, profile

import pb_helpers  # noqa: F401  (the repository's root on the path)
from portbench.harness import trace


def test_enclosing_ops_outermost_first():
    ops = [(0, 10, "a"), (2, 5, "b"), (6, 9, "c"), (12, 20, "d")]
    got = trace._enclosing(ops, [(3, "p"), (7, "q"), (11, "r"), (15, "s")])
    assert got == {"p": ("a", "b"), "q": ("a", "c"), "r": (), "s": ("d",)}


def test_union_busy_and_gaps():
    k = [trace.Kernel(5, 10, "k1", (), False),
         trace.Kernel(8, 12, "k2", (), False),
         trace.Kernel(15, 16, "k3", (), True)]
    host = {1: [(0, 20, "module::flowNet"), (12, 14, "aten::copy_")]}
    busy, gaps = trace._union(k, 0, 20, host)
    assert busy == 8
    assert gaps == [(5, "module::flowNet"), (3, "aten::copy_"),
                    (4, "module::flowNet")]
    assert trace.device_seconds(k, lambda x: x.graph) == 1e-9


def test_read_a_cpu_profile():
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("module::flowNet"):
            torch.nn.functional.conv2d(x[None, None], torch.ones(1, 1, 3, 3))
    t = trace.read(prof)
    assert t.end > t.start and t.busy == 0 and t.kernels == []
    assert trace.breakdown(t) == {"device_ops": [], "idle_gaps": []}
