"""Seconds a job spends in the guest's emulation (the prover's scope
``emulate``: the SDK's for machine v1, the harness's for machine2)."""

UNIT, LAYER, SOURCE, MOVES = "s", "sdk prover and vm emulator", \
    "program_span", "steps_per_s"


def read(ctx):
    return ctx.scope_mean(lambda k: k == "emulate")
