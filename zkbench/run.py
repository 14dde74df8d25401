"""The benchmark of the PyTorch and CUDA prover (``nexus_zkvm_tpu_torch``).

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: a closed
loop of seeded fib proof jobs for ``--seconds``, then the checks, and
prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
a ``breakdown``, and ``compared`` last: each compared number beside
its limit, also the last lines on standard error).  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
ones.  Exits non-zero, printing no result, without a card, with fewer
cards than the cell asks for, or when JAX or the JAX package is loaded.
Build and kernel caches stay inside the checkout (``build/kernels``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import guard, spec
    cell = spec.load_cell(args.workload)
    # one process with few threads: the prover's host work is Python and
    # numpy on one thread, and idle pool threads only contend with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    found = guard.loaded_forbidden()
    if found:
        print(f"loaded at start: {', '.join(found)}", file=sys.stderr)
        return 4
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    bad = guard.reference_faults(HERE / "reference")
    if bad:
        print(f"the reference imports the measured package: {bad}",
              file=sys.stderr)
        return 3

    from harness import session
    result = session.run(cell, args.seed, args.seconds, bool(args.trace))

    found = guard.loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
