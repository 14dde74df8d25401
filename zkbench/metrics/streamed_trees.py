"""Trees a job commits column-streamed, as the prover's memory route
notes them (``prof.notes["streamed"]``), averaged over the jobs."""

UNIT, LAYER, SOURCE, MOVES = "trees", "prover config memory route", \
    "program_counter", "peak_reserved_frac"


def read(ctx):
    seen = [len(j.notes["streamed"]) for j in ctx.jobs
            if "streamed" in j.notes]
    return sum(seen) / len(seen) if seen else None
