"""One reader a per-layer metric, found by the metric's name: ``read(ctx)``
returns the metric's value, or None where its run has nothing to read."""
