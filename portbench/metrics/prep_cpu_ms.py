"""CPU time of the thread that prepared a window, over its decode and
transforms (``Trainer.prep_split_seconds``' ``cpu``: ``time.thread_time``
over the interval ``host_prep_ms`` reads by wall clock), the mean over the
timed epoch's windows, in ms; nothing where the records do not hold it.
``host_prep_ms`` less this is the time that thread was not running."""


def read(ctx):
    splits = ctx.epoch["prep_split_seconds"]
    if not splits or not all("cpu" in s for s in splits):
        return None
    return 1e3 * sum(s["cpu"] for s in splits) / len(splits)
