"""The whole step against the card's float32 peak: the window's useful
FLOPs (counted on the plain reference at the cell's shapes) times the
untraced windows of the timed epoch, over their wall time
(``Trainer.window_seconds``), over 67 TFLOP/s, in %."""

from portbench.harness import peaks


def read(ctx):
    secs = ctx.untraced_seconds
    if not secs:
        return None
    return (100.0 * ctx.work.flops * len(secs) / sum(secs)
            / peaks.FLOAT32_FLOP_PER_S)
