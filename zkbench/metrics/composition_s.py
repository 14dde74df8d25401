"""Seconds a job spends in the composition (scope ``composition``: the
LDE, the constraint kernels, the combine and its commitment)."""

UNIT, LAYER, SOURCE, MOVES = "s", "prover stark composition", \
    "program_span", "steps_per_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k == "composition")
