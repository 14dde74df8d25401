"""The share of the window in which nothing ran on the card: 1 - (the
union of the card's intervals in the profiler's trace) / the window."""

UNIT, LAYER, SOURCE, MOVES = "frac", "device", "device_trace", \
    "steps_per_s"


def read(ctx):
    if not ctx.trace or not ctx.trace["window_s"]:
        return None
    return ctx.trace["idle_frac"]
