"""The 90th percentile of the timed epoch's per-window wall times
(``Trainer.window_seconds``, device synced a window) outside the traced
windows, in ms: the latency of one fused window.  A per-layer reading: a
run holds some 45 windows, so its tail rests on four or five of them, and
it moves with the host as the rate does."""

import numpy as np


def read(ctx):
    secs = ctx.untraced_seconds
    return float(np.percentile(np.asarray(secs) * 1e3, 90)) if secs else None
