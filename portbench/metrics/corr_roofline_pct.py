"""The main path's correlation kernel (``csrc/correlation_sm90.cu``,
``corr_sm90_kernel``) against its bound: the five calls of a VO forward at
the shapes the plain reference records, inputs read and output written
once or 81 multiply-adds a channel and pixel at the H100's peaks, over the
kernel's device time by name, in %."""

from portbench.harness import peaks, trace

KERNEL = "corr_sm90_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    s = trace.device_seconds(ctx.trace.kernels, lambda k: KERNEL in k.name)
    if not s:
        return None
    bound = sum(peaks.corr_bound_seconds(x) for x in ctx.work.corr_shapes)
    return 100.0 * bound * ctx.traced / s
