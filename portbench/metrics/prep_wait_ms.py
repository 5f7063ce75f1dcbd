"""The main thread's wait for a window's inputs (``Trainer.prep_seconds``:
all of their preparation where the prefetch thread had not finished it),
the mean over the timed epoch's windows, in ms."""


def read(ctx):
    waits = ctx.epoch["prep_seconds"]
    return 1e3 * sum(waits) / len(waits) if waits else None
