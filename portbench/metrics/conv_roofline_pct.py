"""The networks' convolutions against the H100's roofline: the least time
their FLOPs and bytes (counted on the plain reference at the cell's
shapes) take at 67 TFLOP/s float32 or 3.35 TB/s, over the device time of
the kernels launched under the convolution ops (the forwards in the
networks' ranges, and the pose head's backward), in %."""

from portbench.harness import peaks, trace


def read(ctx):
    if ctx.trace is None:
        return None
    s = trace.device_seconds(ctx.trace.kernels, trace.is_conv)
    if not s:
        return None
    bound = peaks.roof_seconds(ctx.work.conv_flops, ctx.work.conv_bytes)
    return 100.0 * bound * ctx.traced / s
