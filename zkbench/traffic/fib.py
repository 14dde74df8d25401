"""Jobs of the fib guest (``traffic/fib.s``): n from the public input,
fib(n) to the public output, 5 n + 10 guest steps.

A mix names its ``rungs``: a job at rung k runs between 2^(k-1) + 1 and
2^k guest steps, so its trace is padded to 2^k rows, as a job of
"about 2^k steps" is (on average three quarters full).  Jobs come in
blocks of one job a rung, each block in a seeded order.  Each rung's
octave is cut into ``strata`` equal slices; a seed takes them in pairs
mirrored about the octave's middle, (i, strata - 1 - i), and draws n
within each slice, so any seed's first 2m blocks hold about the same
guest steps: the seed changes the order and the values, not the work.
The warm-up proves the least and the largest n of every rung, so every
shape the mix uses is met in set-up.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "KEYS", "steps", "n_band", "rung_of", "block",
           "schedule", "sample", "public_input", "guest"]

SOURCE = Path(__file__).resolve().parent / "fib.s"

# the mix keys this builder reads; a mix with any other is refused
KEYS = {"job", "rungs", "strata", "checked_per_rung", "why"}


def steps(n: int) -> int:
    return 5 * int(n) + 10


def n_band(rung: int) -> tuple:
    """The least and largest n whose steps lie in (2^(rung-1), 2^rung]."""
    lo = max(0, -(-((1 << (rung - 1)) + 1 - 10) // 5))
    hi = ((1 << rung) - 10) // 5
    if lo > hi:
        raise ValueError(f"empty octave at rung {rung}")
    return lo, hi


def rung_of(n: int) -> int:
    """The rung whose octave holds n's steps."""
    return max(1, steps(n) - 1).bit_length()


def block(mix: dict) -> int:
    """Jobs a block: one a rung.  The window ends on a block's end."""
    return len(mix["rungs"])


def schedule(seed: int, mix: dict, count: int = 2048) -> tuple:
    """([warm-up n, ...], [n of job 0, 1, ...]) for ``seed``."""
    rungs = [int(k) for k in mix["rungs"]]
    strata = int(mix["strata"])
    if strata < 2 or strata % 2:
        raise ValueError("strata must be even and at least 2")
    rng = np.random.default_rng(int(seed))
    warm = [n for k in rungs for n in n_band(k)]
    streams = {k: [] for k in rungs}

    def draw(k):
        if not streams[k]:
            lo, hi = n_band(k)
            edges = np.linspace(lo, hi + 1, strata + 1)
            for p in rng.permutation(strata // 2):
                pair = [int(p), strata - 1 - int(p)]
                if rng.integers(2):
                    pair.reverse()
                for i in pair:
                    a = int(math.ceil(edges[i]))
                    b = max(a, int(math.ceil(edges[i + 1])) - 1)
                    streams[k].append(int(rng.integers(a, b + 1)))
        return streams[k].pop(0)
    ns = []
    while len(ns) < count:
        ns += [draw(rungs[int(i)]) for i in rng.permutation(len(rungs))]
    return warm, ns[:count]


def sample(seed: int, mix: dict, ns: list) -> list:
    """Indices into ``ns`` (a window's finished jobs) that the checks
    read: ``checked_per_rung`` drawn from the seed at each rung, the job
    with the most steps among those of its rung."""
    rng = np.random.default_rng([int(seed), 1])
    per = int(mix["checked_per_rung"])
    longest = max(range(len(ns)), key=lambda i: ns[i]) if ns else None
    picked = []
    for k in sorted({rung_of(n) for n in ns}):
        at = [i for i, n in enumerate(ns) if rung_of(n) == k]
        first = [longest] if longest in at else []
        rest = [i for i in at if i != longest]
        picked += first + [int(i) for i in rng.choice(
            rest, size=min(per, len(at)) - len(first), replace=False)]
    return sorted(picked)


def public_input(n: int) -> bytes:
    return struct.pack("<I", int(n) & 0xFFFFFFFF)


def guest():
    """The guest as the prover's SDK assembles it."""
    from nexus_zkvm_tpu_torch.sdk import Guest
    return Guest.from_asm(SOURCE.read_text())
