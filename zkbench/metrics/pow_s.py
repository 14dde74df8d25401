"""Seconds a job spends grinding the proof of work on the host (scope
``pow``)."""

UNIT, LAYER, SOURCE, MOVES = "s", "prover stark proof of work", \
    "program_span", "steps_per_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k == "pow")
