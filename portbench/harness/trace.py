"""Tracing a few windows of the timed epoch with ``torch.profiler``, and
reading the trace.

``Tracer`` starts the profiler before the epoch and steps it at each
window's VO forward (a forward pre-hook on the VO model): the first
``skip`` windows run untraced, one more warms the profiler up, and the next
``windows`` are recorded.  While it is on, the three networks' forwards are
``module::<name>`` ranges of the trace.

``read`` takes the raw events: every device activity (kernels, copies,
sets; not the device side of profiler ranges), each kernel with the host
call that launched it (the CUDA runtime event of the same correlation id)
and the host ops around that call on its thread.  From these come the
device's busy time (the union of its activities), each kernel's time by
name, the kernels of the networks' ranges, of the convolutions and of the
CUDA graph replays, and the idle gaps with what the main thread was doing.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, schedule

RANGE = "module::"
NETWORKS = ("flowNet", "stereoNet", "flowPoseNet")
CONV_OPS = ("aten::convolution", "aten::_convolution",
            "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")
GRAPH_LAUNCH = "cudaGraphLaunch"
# an idle stretch while the main thread runs no op: Python, or the wait for
# the prefetch thread
IDLE = "no op on the main thread"


class Tracer:
    """The profiler over windows skip + 1 .. skip + windows of an epoch of
    ``model``'s forwards."""

    def __init__(self, model, skip: int, windows: int):
        self.model, self.windows = model, windows
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(
            activities=activities,
            schedule=schedule(wait=skip, warmup=1, active=windows,
                              repeat=1))
        self._hooks = []

    def __enter__(self):
        named = {getattr(self.model, n): n for n in NETWORKS}
        opened = []

        def pre(module, args):
            name = named.get(module)
            if name is not None:
                r = torch.autograd.profiler.record_function(RANGE + name)
                r.__enter__()
                opened.append(r)

        def post(module, args, out):
            if module in named:
                opened.pop().__exit__(None, None, None)

        self._hooks = [
            torch.nn.modules.module.register_module_forward_pre_hook(pre),
            torch.nn.modules.module.register_module_forward_hook(post),
            self.model.register_forward_pre_hook(
                lambda m, a: self.prof.step())]
        self.prof.start()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        for h in self._hooks:
            h.remove()
        return False


class Kernel(NamedTuple):
    start: int
    end: int
    name: str
    stack: tuple      # host ops around its launch, outermost first
    graph: bool       # launched by a CUDA graph replay


class Trace(NamedTuple):
    start: int        # ns, the first and last event of the trace
    end: int
    busy: int         # ns of the union of device activities
    kernels: list     # of Kernel (device activities)
    gaps: list        # (ns, label) of each idle stretch


def _enclosing(ops, points):
    """For host ops (start, end, name) of one thread and points (time,
    key): {key: names of the ops open at that time, outermost first}."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = tuple(o[2] for o in stack)
    return out


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cudaGraphLaunch,
    cuLaunchKernel, cudaMemcpyAsync, ...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def read(prof) -> Trace:
    """The trace of ``prof`` from its raw events.  Only methods that
    PyTorch's events have had for many releases are used: the kind of an
    event is told by its device and its name."""
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    host = defaultdict(list)        # thread -> [(start, end, name)]
    launches = {}                   # correlation id -> (thread, time, name)
    device = []
    lo, hi = None, None
    for e in events:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        lo = start if lo is None else min(lo, start)
        hi = start + dur if hi is None else max(hi, start + dur)
        if e.device_type() == cuda:
            device.append(e)
        elif _is_launch(name):
            launches[e.correlation_id()] = (e.start_thread_id(), start, name)
        elif not name.startswith("ProfilerStep"):
            host[e.start_thread_id()].append((start, start + dur, name))
    # the device side of profiler ranges overlaps the kernels: not work
    ranges = {n for ops in host.values() for _, _, n in ops
              if not n.startswith("aten::")}
    device = [e for e in device if e.name() not in ranges
              and not e.name().startswith((RANGE, "ProfilerStep"))]

    def source(e):
        return launches.get(e.correlation_id()) or launches.get(
            e.linked_correlation_id())

    points = defaultdict(list)
    for i, e in enumerate(device):
        src = source(e)
        if src is not None:
            points[src[0]].append((src[1], i))
    stacks = {}
    for thread, pts in points.items():
        stacks.update(_enclosing(host.get(thread, []), pts))
    kernels = []
    for i, e in enumerate(device):
        src = source(e)
        kernels.append(Kernel(e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name(), stacks.get(i, ()),
                              src is not None and src[2].startswith(
                                  GRAPH_LAUNCH)))
    busy, gaps = _union(kernels, lo or 0, hi or 0, host)
    return Trace(lo or 0, hi or 0, busy, kernels, gaps)


def _main_thread(host):
    for thread, ops in host.items():
        if any(n.startswith(RANGE) for _, _, n in ops):
            return thread
    return max(host, key=lambda t: len(host[t])) if host else None


def _union(kernels, lo, hi, host):
    """The device's busy ns, and its idle stretches labelled by the
    innermost host op of the main thread at their middle."""
    spans = sorted((k.start, k.end) for k in kernels)
    busy, idle = 0, []
    cur_s = cur_e = None
    last = lo
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                last = cur_e
            if s > last:
                idle.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            idle.append((cur_e, hi))
    main = _main_thread(host)
    ops = host.get(main, [])
    names = _enclosing(ops, [((a + b) // 2, i) for i, (a, b) in
                             enumerate(idle)])
    gaps = [(b - a, (names.get(i) or (IDLE,))[-1])
            for i, (a, b) in enumerate(idle)]
    return busy, gaps


def device_seconds(kernels, keep) -> float:
    return sum(k.end - k.start for k in kernels if keep(k)) / 1e9


def in_networks(k: Kernel) -> bool:
    return any(n in (RANGE + m for m in NETWORKS) for n in k.stack)


def is_conv(k: Kernel) -> bool:
    """A kernel of a convolution of the networks (forward, in their
    ranges) or of the pose head's backward."""
    conv = any(n in CONV_OPS for n in k.stack)
    return conv and (in_networks(k) or "aten::convolution_backward"
                     in k.stack)


def top(pairs, n=10):
    """The n largest (name, seconds) of summed (seconds, name) pairs."""
    sums = defaultdict(float)
    for sec, name in pairs:
        sums[name] += sec
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:n]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": top(((k.end - k.start) / 1e9, k.name)
                              for k in trace.kernels),
            "idle_gaps": top((ns / 1e9, label) for ns, label in trace.gaps)}
