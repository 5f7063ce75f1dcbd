"""Device time of the kernels launched inside the three networks'
forwards (``module::flowNet``, ``stereoNet``, ``flowPoseNet`` ranges of the
trace), a traced window, in ms."""

from portbench.harness import trace


def read(ctx):
    if ctx.trace is None:
        return None
    s = trace.device_seconds(ctx.trace.kernels, trace.in_networks)
    return 1e3 * s / ctx.traced if s else None
