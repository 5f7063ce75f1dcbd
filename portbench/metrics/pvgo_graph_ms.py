"""Device time of the kernels that the detached PVGO solve's CUDA graph
replays launched (their launch is a ``cudaGraphLaunch``), a traced
window, in ms."""

from portbench.harness import trace


def read(ctx):
    if ctx.trace is None:
        return None
    s = trace.device_seconds(ctx.trace.kernels, lambda k: k.graph)
    return 1e3 * s / ctx.traced if s else None
