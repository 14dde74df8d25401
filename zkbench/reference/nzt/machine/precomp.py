"""Proven precompile circuits.

Counterpart of the reference's `PrecompileInstruction::circuit()`
(`nexus-zkvm/precompiles/src/traits.rs:38-46`): a precompile is a
custom R-type instruction `rd = f(rs1, rs2)`; its circuit is a
standalone component, sized to the number of precompile rows, that
consumes the CPU's `precomp` dispatch relation
(idx, b_lo, b_hi, c_lo, c_hi, a_lo, a_hi) and proves the arithmetic —
the same dispatch architecture as the M-extension and keccak
components (prover2-style per-instruction machines).

A precompile that executes natively but has no circuit makes the trace
*unprovable* (`build_machine_traces` rejects it with a clear error)
rather than silently unsound.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from .schema import Schema, Cols

__all__ = ["PRECOMP_SCHEMA", "DummyDivComponent",
           "proven_precompile_components"]

PRECOMP_SCHEMA = Schema([
    ("pf", 1),                   # active flag (0 on padding rows)
    ("b", 4), ("c", 4), ("a", 4), ("r", 4),
    ("p", 8),                    # product bytes of a * c
    ("g", 7), ("gh", 7),         # product carries (byte + 3 bits)
    ("dz", 1), ("dzi", 1),       # zero-divisor flag + inverse aux
    ("dbw", 2), ("dh", 4),       # r < c borrow compare
    ("cr", 1),                   # recombination carry
])


class DummyDivComponent(Component):
    """a = b / c unsigned, a = 0 when c = 0 — the proven circuit for
    the reference's `dummy_div` example precompile
    (`nexus-zkvm/precompiles/examples/dummy_div`)."""
    name = "pre_dummy_div"
    n_main = PRECOMP_SCHEMA.n_cols
    INDEX = 0

    def evaluate(self, ctx):
        c = Cols(ctx, PRECOMP_SCHEMA)
        pf, dz = c("pf"), c("dz")
        ctx.constraint(pf * (pf - 1))
        ctx.constraint(dz * (dz - 1))
        ctx.constraint(dz * (1 - pf))          # dz only on active rows
        ctx.constraint(c("cr") * (c("cr") - 1))
        for i in range(2):
            ctx.constraint(c("dbw", i) * (c("dbw", i) - 1))

        b_lo, b_hi = c.lo("b"), c.hi("b")
        c_lo, c_hi = c.lo("c"), c.hi("c")
        a_lo, a_hi = c.lo("a"), c.hi("a")
        r_lo, r_hi = c.lo("r"), c.hi("r")

        # consume the CPU dispatch tuple
        ctx.add_fraction(-pf, "precomp",
                         [self.INDEX, b_lo, b_hi, c_lo, c_hi,
                          a_lo, a_hi])

        # schoolbook product p = a * c, byte carries range-checked
        for k in range(7):
            s_k = None
            for i in range(max(0, k - 3), min(3, k) + 1):
                t = c("a", i) * c("c", k - i)
                s_k = t if s_k is None else s_k + t
            g_k = c("g", k) + 256 * c("gh", k)
            prev = (c("g", k - 1) + 256 * c("gh", k - 1)) if k else 0
            ctx.constraint(s_k + prev - c("p", k) - 256 * g_k)
            ctx.add_fraction(1, "r256", [c("g", k)])
            ctx.add_fraction(1, "r8", [c("gh", k)])
        ctx.constraint(c("p", 7) - c("g", 6) - 256 * c("gh", 6))
        for name in ("b", "c", "a", "r"):
            for i in range(4):
                ctx.add_fraction(1, "r256", [c(name, i)])
        for i in range(8):
            ctx.add_fraction(1, "r256", [c("p", i)])

        p_lo = c("p", 0) + 256 * c("p", 1)
        p_hi = c("p", 2) + 256 * c("p", 3)
        ph_lo = c("p", 4) + 256 * c("p", 5)
        ph_hi = c("p", 6) + 256 * c("p", 7)

        # b = a*c + r with r < c (nonzero divisor)
        nz = pf * (1 - dz)
        ctx.constraint(nz * (p_lo + r_lo - b_lo - (1 << 16) * c("cr")))
        ctx.constraint(nz * (p_hi + r_hi + c("cr") - b_hi))
        ctx.constraint(nz * ph_lo)
        ctx.constraint(nz * ph_hi)
        # r < c via borrow compare: must borrow out
        ctx.constraint(nz * (r_lo - c_lo + (1 << 16) * c("dbw", 0)
                             - c.lo("dh")))
        ctx.constraint(nz * (r_hi - c_hi - c("dbw", 0)
                             + (1 << 16) * c("dbw", 1) - c.hi("dh")))
        ctx.constraint(nz * (1 - c("dbw", 1)))
        for i in range(4):
            ctx.add_fraction(1, "r256", [c("dh", i)])

        # zero divisor: a = 0 (dummy_div semantics), r pinned to 0
        zsum = c_lo + c_hi
        ctx.constraint(dz * zsum)
        ctx.constraint(pf * (zsum * c("dzi") - (1 - dz)))
        for i in range(4):
            ctx.constraint(dz * c("a", i))
            ctx.constraint(dz * c("r", i))


    def witness(self, b, cc, a):
        """Per-row witness columns beyond b/c/a (vectorized numpy)."""
        out = {}
        dz = cc == 0
        out["dz"] = dz
        zsum = ((cc & 0xFFFF) + (cc >> np.uint64(16))) \
            % np.uint64((1 << 31) - 1)
        out["dzi"] = np.where(dz, 0, _inv(zsum))
        r = np.where(dz, 0, b - a * cc)
        out["r"] = r
        # product p = a * cc with byte carries
        ab = [(a >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
        cb = [(cc >> np.uint64(8 * j)) & np.uint64(0xFF)
              for j in range(4)]
        gprev = np.zeros_like(b)
        p = np.zeros((8, len(b)), np.uint64)
        g = np.zeros((7, len(b)), np.uint64)
        gh = np.zeros((7, len(b)), np.uint64)
        for k in range(7):
            s_k = gprev.copy()
            for i in range(max(0, k - 3), min(3, k) + 1):
                s_k = s_k + ab[i] * cb[k - i]
            p[k] = s_k & np.uint64(0xFF)
            gk = s_k >> np.uint64(8)
            g[k] = gk & np.uint64(0xFF)
            gh[k] = gk >> np.uint64(8)
            gprev = gk
        p[7] = gprev
        out["p"], out["g"], out["gh"] = p, g, gh
        nzm = ~dz
        p_lo = p[0] + 256 * p[1]
        out["cr"] = np.where(nzm, (p_lo + (r & np.uint64(0xFFFF)))
                             >> np.uint64(16), 0)
        dbw0 = np.where(nzm, (r & np.uint64(0xFFFF))
                        < (cc & np.uint64(0xFFFF)), False).astype(
                            np.uint64)
        dh_lo = ((r & np.uint64(0xFFFF)) - (cc & np.uint64(0xFFFF))
                 + (dbw0 << np.uint64(16))) & np.uint64(0xFFFF)
        dbw1 = np.where(nzm, 1, 0).astype(np.uint64)
        dh_hi = ((r >> np.uint64(16)) - (cc >> np.uint64(16)) - dbw0
                 + (dbw1 << np.uint64(16))) & np.uint64(0xFFFF)
        out["dbw"] = np.stack([dbw0, dbw1])
        out["dh"] = np.stack([
            np.where(nzm, dh_lo & np.uint64(0xFF), 0),
            np.where(nzm, dh_lo >> np.uint64(8), 0),
            np.where(nzm, dh_hi & np.uint64(0xFF), 0),
            np.where(nzm, dh_hi >> np.uint64(8), 0)])
        return out


def _inv(vals):
    from ..ops.field import np_m31_inv
    v = np.asarray(vals, np.uint64)
    out = np.zeros_like(v)
    m = v != 0
    if m.any():
        out[m] = np_m31_inv(v[m])
    return out


# The proven-circuit registry: the verifier derives the component set
# from this module (deterministic framework code, like the opcode set).
_CIRCUITS = [DummyDivComponent]


def proven_precompile_components():
    return [cls() for cls in sorted(_CIRCUITS, key=lambda c: c.INDEX)]

