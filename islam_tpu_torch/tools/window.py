"""One profiled window of the Trainer on the card, and what the roofline
and copy tools read from its trace.

``profile`` builds the Trainer with ``profile_window.build_trainer`` (the
preset at 448x640, B=8, 3 windows an epoch), warms it up as
``profile_window`` does, keeps the warm epoch's window times, and runs the
epoch once more under ``torch.profiler`` with the shapes and the memory
(and, on request, the Python stack) recorded.  Each ``nn.Module`` forward of the VO model and
the denoiser is a ``module::<path>`` range of the trace, so an op finds its
module; an op of the backward finds the module of the forward op that made
its autograd node (the same sequence number).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile as torch_profile

MODULE_RANGE = "module::"
_BACKWARD_NODE = "autograd::engine::evaluate_function: "
DEVICE = torch.autograd.DeviceType.CUDA


class Window(NamedTuple):
    trainer: object
    epoch: int
    prof: object               # torch.profiler.profile, stopped
    windows: int               # windows in the profiled epoch
    wall_ms: list              # the warm epoch's window times
    correlation_launches: int  # in the profiled epoch
    correlation_shapes: list   # (B, C, H, W) of each correlation call


@contextmanager
def module_ranges(named):
    """While open, each forward of a module in ``named`` ({module: path})
    runs inside a ``module::<path>`` profiler range."""
    open_ranges = []

    def pre(module, args):
        path = named.get(module)
        if path is not None:
            r = torch.autograd.profiler.record_function(MODULE_RANGE + path)
            r.__enter__()
            open_ranges.append(r)

    def post(module, args, out):
        if module in named:
            open_ranges.pop().__exit__(None, None, None)

    h1 = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    h2 = torch.nn.modules.module.register_module_forward_hook(post)
    try:
        yield
    finally:
        h1.remove()
        h2.remove()


def _named_modules(trainer):
    named = {m: "VONet." + n if n else "VONet"
             for n, m in trainer.model.named_modules()}
    if trainer.denoiser is not None:
        named.update({m: "denoiser." + n if n else "denoiser"
                      for n, m in trainer.denoiser.named_modules()})
    return named


def profile(epoch=0, bf16=False, concat_free=False, with_stack=False):
    """The profiled window (see the module's docstring).  Needs the card."""
    from islam_tpu_torch import profile_window
    from islam_tpu_torch.models import pwcnet
    from islam_tpu_torch.ops import correlation as corr
    from islam_tpu_torch.tools.flops import recording_correlation

    trainer, _ = profile_window.build_trainer(epoch, bf16=bf16,
                                              concat_free=concat_free)
    profile_window.warm_up(trainer, epoch)
    wall_ms = [s * 1e3 for s in trainer.window_seconds[epoch]]
    kw = {}
    if with_stack:
        kw = dict(with_stack=True,
                  experimental_config=torch.profiler._ExperimentalConfig(
                      verbose=True))
    shapes = []
    launches = corr.LAUNCHES + corr.LAUNCHES_ALL
    with mock.patch.object(pwcnet, "correlation",
                           recording_correlation(shapes)), \
            module_ranges(_named_modules(trainer)), \
            torch_profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA],
                          record_shapes=True, profile_memory=True,
                          **kw) as prof:
        trainer.run_epoch(epoch)
    launches = corr.LAUNCHES + corr.LAUNCHES_ALL - launches
    return Window(trainer, epoch, prof, len(trainer.window_seconds[epoch]),
                  wall_ms, launches, shapes)


# ---- reading the trace ----

def device_events(events):
    """The device's activities (kernels, copies, sets) of a trace; not the
    device-side spans of profiler ranges (``module::`` and others), which
    overlap the kernels they hold."""
    return [e for e in events if e.device_type == DEVICE
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(MODULE_RANGE)]


def device_ms(events) -> float:
    return sum(e.time_range.elapsed_us() for e in device_events(events)) / 1e3


def op_kernels(evt):
    """The device kernels ``evt`` and the ops under it launched."""
    out = list(evt.kernels)
    for c in evt.cpu_children:
        out += op_kernels(c)
    return out


def op_device_ms(evt) -> float:
    return sum(k.duration for k in op_kernels(evt)) / 1e3


def ancestors(evt):
    p = evt.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def dtypes_by_id(prof):
    """{op id: the dtypes of its arguments} from the profiler's raw events
    (the op events themselves keep only shapes)."""
    return {k.correlation_id(): k.dtypes()
            for k in prof.profiler.kineto_results.events()}


def allocated_bytes(evt) -> int:
    """The bytes an op allocated and kept, on the device or else on the
    host (the profiler's memory records, ``profile_memory``): a new output's
    size, rounded up to the card allocator's 512-byte blocks; 0 for an
    in-place op."""
    return max(evt.device_memory_usage, evt.cpu_memory_usage, 0)


class Modules:
    """The module path of an op of the trace: the innermost ``module::``
    range around it, or, in the backward, that of the forward op with its
    autograd node's sequence number, marked '(backward)'."""

    def __init__(self, events):
        self.forward = {}
        for e in events:
            if e.sequence_nr >= 0 and e.device_type != DEVICE:
                path = self._range(e)
                if path:
                    self.forward.setdefault((e.thread, e.sequence_nr), path)

    @staticmethod
    def _range(evt):
        for a in ancestors(evt):
            if a.name.startswith(MODULE_RANGE):
                return a.name[len(MODULE_RANGE):]
        return ""

    def __call__(self, evt) -> str:
        path = self._range(evt)
        if path:
            return path
        for a in ancestors(evt):
            if a.name.startswith(_BACKWARD_NODE):
                path = self.forward.get((a.fwd_thread, a.sequence_nr), "")
                return path + " (backward)"
        return ""
