"""Seconds a job spends in machine2's family fills (scope ``fills``:
host numpy fills, table counts, the upload)."""

UNIT, LAYER, SOURCE, MOVES = "s", "machine2 family fills", \
    "program_span", "setup_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k == "fills")
