"""Device time of the kernels launched inside the program's ``islam::imu``
range (``train.window_loss``: the denoiser and the preintegration of a
window), a traced window, in ms; nothing where the program opens no such
range."""

from portbench.harness import trace

RANGE = "islam::imu"


def read(ctx):
    if ctx.trace is None:
        return None
    s = trace.device_seconds(ctx.trace.kernels, lambda k: RANGE in k.stack)
    return 1e3 * s / ctx.traced if s else None
