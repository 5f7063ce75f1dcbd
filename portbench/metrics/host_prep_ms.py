"""The host's preparation of a window (``Trainer.prep_split_seconds``:
image decoding plus the transforms and the collate, on whichever thread
made it), the mean over the timed epoch's windows, in ms."""


def read(ctx):
    splits = ctx.epoch["prep_split_seconds"]
    if not splits:
        return None
    return 1e3 * sum(s["decode"] + s["transforms"] for s in splits) / len(
        splits)
