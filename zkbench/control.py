"""The control of a cell's correctness check, on the card.

    python zkbench/control.py --workload <cell> --seeds <n> <n> <n> [...]

In one process, after the mix's warm-up jobs: for each seed, the
seed's first block of jobs (one at each rung of the mix) proved by the
prover with the configuration's guarantee broken (the FRI queries one
fewer than the configuration states, so one fewer query's worth of
conjectured security), then judged by the plain reference under the
configuration's own parameters.  Each seed prints one JSON line with
its compared numbers; the check works when every seed reads
``proofs_rejected`` 1 or more.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_pcs(fields: dict) -> dict:
    """The configuration's parameters with one FRI query fewer."""
    return dict(fields, n_queries=int(fields["n_queries"]) - 1)


def readings(cell, seeds) -> list:
    from harness.session import prover_pcs
    from harness.spec import load_module
    from reference import check
    job = load_module("traffic", cell.traffic["job"])
    machine = load_module("machines", cell.config["machine"])
    entry = machine.Entry(cell, job.guest(),
                          prover_pcs(control_pcs(cell.config["pcs"])), "cuda")
    block = len(cell.traffic["rungs"])
    out = []
    for i, seed in enumerate(seeds):
        warm, ns = job.schedule(seed, cell.traffic, count=block)
        if i == 0:
            for n in warm:
                entry.prove(job.public_input(n))
        t = time.perf_counter()
        proved = [(n, *entry.prove(job.public_input(n))) for n in ns]
        prove_s = time.perf_counter() - t
        compared, _bad = check.judge(machine.REFERENCE, proved,
                                     cell.config["pcs"],
                                     job.SOURCE.read_text(), "cuda")
        out.append({"seed": seed, "ns": ns, "prove_s": prove_s,
                    "control": control_pcs(cell.config["pcs"]),
                    "compared": compared})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from harness import spec
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for rec in readings(spec.load_cell(args.workload), args.seeds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
