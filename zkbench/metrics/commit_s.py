"""Seconds a job spends committing its traces (scopes ``commit:pre``,
``commit:main``, ``commit:inter``, summed)."""

UNIT, LAYER, SOURCE, MOVES = "s", "prover pcs commits", "program_span", \
    "steps_per_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k.startswith("commit:"))
