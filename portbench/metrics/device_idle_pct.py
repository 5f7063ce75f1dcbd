"""The share of the traced windows in which no operation ran on the card:
100 minus the union of the device's activities over the trace's span, in
%."""


def read(ctx):
    t = ctx.trace
    if t is None or t.end <= t.start:
        return None
    return 100.0 * (1.0 - t.busy / (t.end - t.start))
