"""Images decoded to prepare a window (``Trainer.prep_split_seconds``'
``images``: the ``read_image`` calls of that window's preparation), the
mean over the timed epoch's windows; nothing where the records do not
count them."""


def read(ctx):
    splits = ctx.epoch["prep_split_seconds"]
    if not splits or not all("images" in s for s in splits):
        return None
    return sum(s["images"] for s in splits) / len(splits)
