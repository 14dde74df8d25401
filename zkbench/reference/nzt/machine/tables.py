"""Lookup-table components: range checks, byte bitwise ops, byte shifts.

Counterpart of the reference's RangeCheck chips + multiplicity
extensions (`nexus-zkvm/prover/src/chips/range_check/mod.rs:1-28`,
`prover/src/extensions/multiplicity.rs:41`) and the bitwise tables
(`prover/src/extensions/bitwise_table/mod.rs:75,273`).

Each table is a Component whose value tuples are **preprocessed**
(recomputed by the verifier) and whose only main column is the
multiplicity; it consumes -mult * tuple from its relation.  The SHL8 /
SHR8 byte-shift tables replace the reference's committed-exponent shift
gadget (`prover/src/chips/instructions/i/sll.rs` Exp1_3/Exp columns)
with pure lookups:

  SHL8: (b, r, hi, lo)  with  b * 2^r = hi * 256 + lo,  r in [0, 8)
  SHR8: (b, r, q, rem)  with  b = q * 2^r + rem, rem < 2^r
"""

from __future__ import annotations

import numpy as np

from ..air import Component

__all__ = ["RangeTable", "BitOpTable", "ShiftTable", "count_multiplicity"]


class _Table(Component):
    """Base: preprocessed tuple columns + one main multiplicity col."""
    n_main = 1
    relation = None          # override
    log_rows = None          # natural table size

    def tuple_columns(self) -> list:
        raise NotImplementedError

    def preprocessed(self, log_size: int):
        cols = []
        n = 1 << log_size
        for i, vals in enumerate(self.tuple_columns()):
            col = np.zeros(n, np.uint32)
            col[:min(len(vals), n)] = vals[:n]
            cols.append((f"{self.name}_t{i}", col))
        return cols

    def evaluate(self, ctx):
        mult = ctx.main(0)
        vals = [ctx.pre(i) for i in range(len(self.tuple_columns()))]
        ctx.add_fraction(-mult, self.relation, vals)


class RangeTable(_Table):
    """Values [0, 2^bits); relation `r{2^bits}`."""

    def __init__(self, bits: int):
        self.bits = bits
        self.name = f"range{1 << bits}"
        self.relation = f"r{1 << bits}"
        self.log_rows = bits

    def tuple_columns(self):
        return [np.arange(1 << self.bits, dtype=np.uint32)]


class BitOpTable(_Table):
    """(x, y, x op y) over 4-bit nibbles; 2^8 rows.

    Nibble decomposition keeps the largest table small so the
    composition/FRI domain is set by the trace, not the tables — the
    reference compresses its byte tables the same way with EXPAND_BITS
    (`nexus-zkvm/prover/src/extensions/bitwise_table/mod.rs:75`).
    """

    def __init__(self, op: str):
        assert op in ("and", "xor")
        self.op = op
        self.name = f"{op}4"
        self.relation = f"{op}4"
        self.log_rows = 8

    def tuple_columns(self):
        x = np.repeat(np.arange(16, dtype=np.uint32), 16)
        y = np.tile(np.arange(16, dtype=np.uint32), 16)
        z = (x & y) if self.op == "and" else (x ^ y)
        return [x, y, z]


class ShiftTable(_Table):
    """Byte shift tables; relation `shl8`/`shr8`.

    SHL8 covers r in [0, 9) (a full-byte shift r=8 arises as 8 - r for
    r = 0 in the right-shift carry path); SHR8 covers r in [0, 8).
    """

    def __init__(self, direction: str):
        assert direction in ("l", "r")
        self.direction = direction
        self.name = f"sh{direction}8"
        self.relation = f"sh{direction}8"
        self.n_shamt = 9 if direction == "l" else 8
        self.log_rows = 12 if direction == "l" else 11

    def tuple_columns(self):
        b = np.repeat(np.arange(256, dtype=np.uint32), self.n_shamt)
        r = np.tile(np.arange(self.n_shamt, dtype=np.uint32), 256)
        if self.direction == "l":
            prod = b.astype(np.uint64) << r
            return [b, r, (prod >> 8).astype(np.uint32),
                    (prod & 0xFF).astype(np.uint32)]
        q = b >> r
        rem = b - (q << r)
        return [b, r, q, rem]


def count_multiplicity(table: _Table, emitted: np.ndarray,
                       log_size: int) -> np.ndarray:
    """Main (multiplicity) column from the flat array of emitted tuple
    *row indices* (vectorized bincount over all emitting columns)."""
    mult = np.bincount(emitted.reshape(-1),
                       minlength=1 << log_size).astype(np.uint32)
    assert len(mult) == 1 << log_size, "emitted value outside table"
    return mult

