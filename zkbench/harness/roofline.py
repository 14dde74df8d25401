"""The least time the card needs for a proof's K1 (circle FFT) and K2
(Blake2s Merkle) work, counted from the proof's shapes alone, so the
same work is counted whatever implements it.

Peaks of one NVIDIA H100 SXM: HBM at 3.35 TB/s (published) and 32-bit
integer operations at 33.5 Top/s (assumed: NVIDIA publishes no int32
rate; half the float32 rate of 67 TFLOP/s).  An M31 product costs 6
operations and an add 3; a Blake2s compression 968 (10 rounds of 8 G
mixes of 12 operations, and 8 for the feed-forward).

What a proof needs:

* K1: each committed column (preprocessed, with one is_first column a
  distinct size; main; four a LogUp batch) interpolated once at its
  2^n rows and evaluated once on its 2^(n + blowup) commitment domain;
  the columns of the components of each size n, and one is_first
  column, evaluated once on the 2^(n + 2) composition domain; the
  composition's four coordinates interpolated once on each such domain,
  then evaluated on the 2^(nmax + 2 + blowup) domain of their
  commitment.  A transform of 2^k inputs on 2^m points takes
  k·2^(m - 1) butterflies (one product and two adds); an interpolation
  also scales its 2^n outputs.
* K2: a tree of C columns over 2^s leaves hashes each leaf's 4·C bytes
  (max(1, ceil(C / 16)) compressions) and climbs 2^s - 1 parents (one
  compression of two 32-byte digests each).  FRI's layer trees are not
  counted, so K2's share can only read low.

Each input byte is read once and each output byte written once;
recomputations that a streamed route makes are not counted.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "least_s",
           "interpolate_cost", "evaluate_cost", "tree_cost", "trees",
           "k1_work", "k2_work"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12     # assumed
MUL, ADD = 6, 3
BUTTERFLY = MUL + 2 * ADD
COMPRESS = 80 * 12 + 8


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def interpolate_cost(cols: int, n: int) -> tuple:
    """(bytes, operations) of interpolating ``cols`` columns of 2^n."""
    N = 1 << n
    return (8 * cols * N, cols * (n * (N >> 1) * BUTTERFLY + N * MUL))


def evaluate_cost(cols: int, k: int, m: int) -> tuple:
    """(bytes, operations) of evaluating ``cols`` columns of 2^k
    coefficients on 2^m points."""
    return (4 * cols * ((1 << k) + (1 << m)),
            cols * k * (1 << (m - 1)) * BUTTERFLY)


def tree_cost(cols: int, s: int) -> tuple:
    """(bytes, operations) of a Merkle tree of ``cols`` columns over 2^s
    leaves."""
    S = 1 << s
    blocks = max(1, -(-cols // 16))
    nbytes = 4 * cols * S + 32 * S + 96 * (S - 1)
    return nbytes, COMPRESS * (S * blocks + S - 1)


def trees(shapes, blowup: int) -> dict:
    """(role, trace log n) -> committed columns, from each component's
    (n, preprocessed, main, LogUp batches); the composition's tree is
    ("comp", nmax + 2)."""
    out = {}
    for n in sorted({s[0] for s in shapes}, reverse=True):
        out[("pre", n)] = 1                       # is_first
    for n, pre, main, logup in shapes:
        for role, c in (("pre", pre), ("main", main), ("inter", 4 * logup)):
            if c:
                out[(role, n)] = out.get((role, n), 0) + c
    out[("comp", max(s[0] for s in shapes) + 2)] = 4
    return out


def k1_work(shapes, blowup: int) -> float:
    """Least seconds of a proof's circle FFTs."""
    total = 0.0
    for (role, n), c in trees(shapes, blowup).items():
        if role != "comp":
            total += least_s(*interpolate_cost(c, n))
        total += least_s(*evaluate_cost(c, n, n + blowup))
    for n in {s[0] for s in shapes}:
        cols = 1 + sum(pre + main + 4 * logup
                       for m, pre, main, logup in shapes if m == n)
        total += least_s(*evaluate_cost(cols, n, n + 2))
        total += least_s(*interpolate_cost(4, n + 2))
    return total


def k2_work(shapes, blowup: int) -> float:
    """Least seconds of a proof's trace, interaction and composition
    Merkle trees."""
    return sum(least_s(*tree_cost(c, n + blowup))
               for (_role, n), c in trees(shapes, blowup).items())
