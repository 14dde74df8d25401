"""Column schema helper: named column groups -> main-trace indices.

Counterpart of the reference's `Column` enum + `ColumnsEnum` derive
(`nexus-zkvm/prover/src/column.rs:23-667`, offsets computed by the
proc macro in `prover/macros/`): here a schema is a plain list of
(name, width) pairs; both the vectorized fill and the constraint
evaluation address columns by name.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Schema"]


class Schema:
    def __init__(self, spec):
        self.spec = list(spec)
        self.index = {}
        off = 0
        for name, width in self.spec:
            assert name not in self.index
            self.index[name] = (off, width)
            off += width
        self.n_cols = off

    def slot(self, name: str, i: int = 0) -> int:
        off, width = self.index[name]
        assert 0 <= i < width, f"{name}[{i}] out of range {width}"
        return off + i

    def width(self, name: str) -> int:
        return self.index[name][1]

    def alloc(self, n_rows: int) -> dict:
        """name -> (n_rows,) or (n_rows, width) zeroed uint32 arrays."""
        out = {}
        for name, width in self.spec:
            shape = (n_rows,) if width == 1 else (n_rows, width)
            out[name] = np.zeros(shape, np.uint32)
        return out

    def to_columns(self, filled: dict) -> list:
        """Flatten a fill dict into the ordered column list."""
        cols = []
        for name, width in self.spec:
            arr = filled[name]
            if width == 1:
                cols.append(np.asarray(arr, np.uint32).reshape(-1))
            else:
                for i in range(width):
                    cols.append(np.asarray(arr[:, i], np.uint32))
        return cols


class Cols:
    """Felt accessor over a ctx for a schema: c('name', i, off=0)."""

    def __init__(self, ctx, schema: Schema):
        self.ctx = ctx
        self.s = schema

    def __call__(self, name: str, i: int = 0, off: int = 0):
        return self.ctx.main(self.s.slot(name, i), off)

    def lo(self, name: str):
        """16-bit low half from byte columns: b0 + 256*b1."""
        return self(name, 0) + self(name, 1) * 256

    def hi(self, name: str):
        return self(name, 2) + self(name, 3) * 256

    def word(self, name: str, k: int = 4):
        """Combine k byte columns into one value (must stay < P)."""
        acc = self(name, 0)
        for i in range(1, k):
            acc = acc + self(name, i) * (1 << (8 * i))
        return acc
