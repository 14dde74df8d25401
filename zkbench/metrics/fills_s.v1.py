"""Seconds a job spends in machine v1's trace fills (scope ``fills``:
kernel K5 and its host part)."""

UNIT, LAYER, SOURCE, MOVES = "s", "machine v1 fills", "program_span", \
    "steps_per_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k == "fills")
