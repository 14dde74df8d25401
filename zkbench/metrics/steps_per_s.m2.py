"""Guest steps of the traced window's finished jobs over its whole time
(``window.py``), in machine2's cell: there the host's run-to-run spread
is too wide for an end-to-end bound, so the rate is read here, under
the profiler's synchronizing scopes, and moves ``setup_s``, whose
warm-up proves two jobs a rung."""

UNIT, LAYER, SOURCE, MOVES = "steps/s", "job loop", "host_clock", \
    "setup_s"


def read(ctx):
    return ctx.steps_per_s or None
