"""The pose head's backward (``Trainer.backward_seconds``, CUDA events
around it), the mean over the timed epoch's windows, in ms; nothing in an
epoch that trains nothing."""


def read(ctx):
    b = ctx.epoch["backward_seconds"]
    return 1e3 * sum(b) / len(b) if b else None
