"""Keccak-f[1600] permutation component (the keccakf custom
instruction's circuit).

Counterpart of the reference keccak extension
(`nexus-zkvm/prover/src/extensions/keccak/`): their design splits
rounds across two components with byte-level bitwise/rotate lookup
tables; this one is **bit-decomposed** — TPU-first because it needs no
lookup tables at all, every constraint is a short polynomial over
boolean columns:

* state layout: each permutation occupies a 32-row block; rows 0..23
  hold the state *before* round r as 1600 boolean columns `a`; row 24
  holds the final state; rows 25..31 are dead padding.
* theta: C[x][z] = xor of 5 bits via a carry helper t in {0,1,2}:
  sum_y a[x][y][z] = c + 2 t with c boolean — one helper column per
  (x, z).  D and A^D stay as low-degree expressions.
* rho/pi are free (index relabeling); chi+iota land in the committed
  `ap` columns and the next row's `a` through a degree-4 transition
  constraint gated by `ar` = active AND round-row.
* round constants are preprocessed bit columns (verifier-recomputed).
* memory: one access pair per state word — row 0 *consumes*
  (addr + 4k, in_word, ts_prev) from the `mem` relation (binding the
  input state to RAM) and row 24 *emits* (addr + 4k, out_word, clk)
  (binding the output); the CPU dispatches via the `keccak` relation
  (clk, addr_lo, addr_hi), so fabricated permutations cannot balance.

All fills vectorized over (permutation, round) with numpy.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from ..vm.keccak import _RC, _ROT
from .schema import Schema, Cols

__all__ = ["KeccakComponent", "KECCAK_SCHEMA", "BLOCK_LOG", "BLOCK"]

BLOCK_LOG = 5
BLOCK = 1 << BLOCK_LOG          # rows per permutation block
N_ROUNDS = 24

KECCAK_SCHEMA = Schema([
    ("a", 1600),                # state bits (z-major within lane)
    ("ap", 1600),               # after theta (committed; rho/pi wired)
    ("th", 320),                # theta carry helpers, index 64x + z
    ("act", 1),                 # block active flag
    ("ar", 1),                  # act AND preprocessed round flag
    ("ka", 4),                  # state address bytes (8/8/8/6-ish)
    ("kq", 1),                  # ka0 = 4 * kq alignment quotient
    ("kc", 1),                  # dispatch clk
    ("mtsp", 50),               # per-word previous access ts
    ("mtsd", 200),              # (clk - ts_prev - 1) limbs 8/8/8/6
])

# lane bit index: lane (x + 5y), bit z -> column 64*(x + 5y) + z
def _bit(x, y, z):
    return 64 * ((x % 5) + 5 * (y % 5)) + (z % 64)


class KeccakComponent(Component):
    name = "keccak"
    n_main = KECCAK_SCHEMA.n_cols

    def preprocessed(self, log_size: int):
        n = 1 << log_size
        row = np.arange(n) % BLOCK
        p_round = (row < N_ROUNDS).astype(np.uint32)
        p_first = (row == 0).astype(np.uint32)
        p_last = (row == N_ROUNDS).astype(np.uint32)
        p_cont = (row != BLOCK - 1).astype(np.uint32)
        cols = [("kk_round", p_round), ("kk_first", p_first),
                ("kk_last", p_last), ("kk_cont", p_cont)]
        # round-constant bits at the row of their round
        rc = np.zeros((n, 64), np.uint32)
        for r in range(N_ROUNDS):
            bits = _RC[r]
            for z in range(64):
                if (bits >> z) & 1:
                    rc[row == r, z] = 1
        for z in range(64):
            cols.append((f"kk_rc{z}", rc[:, z]))
        return cols

    # -- static index wiring (computed once at import) -----------------
    @staticmethod
    def _wiring():
        # theta sum: (5, 320) gather of A
        th_sum = np.zeros((5, 320), np.int64)
        for x in range(5):
            for z in range(64):
                for y in range(5):
                    th_sum[y, 64 * x + z] = _bit(x, y, z)
        # D inputs: (320,) indices into the 320-entry C vector
        d1 = np.zeros(320, np.int64)
        d2 = np.zeros(320, np.int64)
        for x in range(5):
            for z in range(64):
                d1[64 * x + z] = 64 * ((x - 1) % 5) + z
                d2[64 * x + z] = 64 * ((x + 1) % 5) + ((z - 1) % 64)
        # per-bit theta-D index: bit i -> 64*x + z
        dmap = np.zeros(1600, np.int64)
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    dmap[_bit(x, y, z)] = 64 * x + z
        # chi sources: target bit (x,y,z) reads B[(x,y,z)], B[x+1], B[x+2]
        # where B[(bx,by,bz)] = AP[_bit(x', y', z')] via the rho/pi map
        b_src = np.zeros(1600, np.int64)
        for x in range(5):
            for y in range(5):
                rot = _ROT[x][y]
                for z in range(64):
                    b_src[_bit(y, (2 * x + 3 * y) % 5, z)] = \
                        _bit(x, y, (z - rot) % 64)
        chi0 = np.zeros(1600, np.int64)
        chi1 = np.zeros(1600, np.int64)
        chi2 = np.zeros(1600, np.int64)
        rc_sel = np.zeros(1600, np.int64)   # -1 = no rc, else z
        rc_sel[:] = -1
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    i = _bit(x, y, z)
                    chi0[i] = b_src[i]
                    chi1[i] = b_src[_bit(x + 1, y, z)]
                    chi2[i] = b_src[_bit(x + 2, y, z)]
                    if x == 0 and y == 0:
                        rc_sel[i] = z
        return th_sum, d1, d2, dmap, chi0, chi1, chi2, rc_sel

    def evaluate(self, ctx):
        from ..air.expr import Felt
        c = Cols(ctx, KECCAK_SCHEMA)
        p_round, p_first, p_last, p_cont = (ctx.pre(i) for i in range(4))
        act, ar = c("act"), c("ar")
        ctx.constraint(act * (act - 1))
        ctx.constraint(ar - act * p_round)
        ctx.constraint(p_cont * (c("act", 0, 1) - act))

        be = ctx.be
        idx = _INDEX

        def stack(fs):
            return Felt(np.stack([f.v for f in fs]), fs[0].kind, be,
                        fs[0].deg)

        def gather(f, name):
            return Felt(f.v[idx[name]], f.kind, be, f.deg)

        # stacked state columns; contexts with a matrix store serve a
        # contiguous block as ONE slice (a/ap/th are schema-contiguous)
        sa = KECCAK_SCHEMA.slot("a", 0)
        sp_ = KECCAK_SCHEMA.slot("ap", 0)
        st_ = KECCAK_SCHEMA.slot("th", 0)
        if hasattr(ctx, "main_block"):
            A = ctx.main_block(sa, sa + 1600)
            AP = ctx.main_block(sp_, sp_ + 1600)
            TH = ctx.main_block(st_, st_ + 320)
        else:
            A = stack([c("a", i) for i in range(1600)])
            AP = stack([c("ap", i) for i in range(1600)])
            TH = stack([c("th", i) for i in range(320)])
        if hasattr(ctx, "main_block"):
            A1 = ctx.main_block(sa, sa + 1600, off=1)
        else:
            # NP contexts (info/point): per-column masked reads — this
            # also registers the next-row masks during info collection
            A1 = stack([c("a", i, 1) for i in range(1600)])

        def xor2(u, v):
            return u + v - 2 * u * v

        # booleanity (vector constraints)
        ctx.constraint_vec((A * (A - 1)).as_qm31().v, 1600)
        ctx.constraint_vec((TH * (TH - 1) * (TH - 2)).as_qm31().v, 320)

        # theta: C = sum_y A - 2*TH, boolean
        s = gather(A, "th_sum0")
        for y in range(1, 5):
            s = s + gather(A, f"th_sum{y}")
        C = s - 2 * TH                               # (320, ...), deg 1
        # C only participates on round rows (the final-state row has no
        # theta helpers), so booleanity is ar-gated
        ctx.constraint_vec((ar * C * (C - 1)).as_qm31().v, 320)

        # ap = a ^ D  (gated, degree 4)
        D = xor2(gather(C, "d1"), gather(C, "d2"))   # deg 2
        ctx.constraint_vec(
            (ar * (AP - xor2(A, gather(D, "dmap")))).as_qm31().v, 1600)

        # chi + iota -> next row (iota folded onto the next-row side)
        b0, b1, b2 = (gather(AP, "chi0"), gather(AP, "chi1"),
                      gather(AP, "chi2"))
        e = xor2(b0, (1 - b1) * b2)
        rc = stack([ctx.pre(4 + z) for z in range(64)])
        rc_gather = gather(rc, "rc_full")
        # rc_m broadcasts over the *row* axes only; when rc_gather is
        # already a QM31 value (verifier point context) its trailing
        # axis is the coordinate axis and must NOT get a singleton
        # (qm31_mul_m31 appends the coord axis itself)
        row_nd = rc_gather.v.ndim - (1 if rc_gather.kind == "qm31" else 0)
        rc_m = Felt(idx["rc_mask"].reshape((1600,) + (1,) * (row_nd - 1)),
                    "m31", be, 0)
        rc_full = rc_gather * rc_m                   # 0 where no rc
        nxt = xor2(A1, rc_full)
        ctx.constraint_vec((ar * (nxt - e)).as_qm31().v, 1600)

        # -- dispatch + memory binding ---------------------------------
        ka = [c("ka", i) for i in range(4)]
        addrW = ka[0] + ka[1] * (1 << 8) + ka[2] * (1 << 16) \
            + ka[3] * (1 << 24)
        addr_lo = ka[0] + ka[1] * (1 << 8)
        addr_hi = ka[2] + ka[3] * (1 << 8)
        clk = c("kc")
        # addr/clk propagate down the block
        ctx.constraint(p_cont * act * (c("ka", 0, 1) - ka[0]))
        ctx.constraint(p_cont * act * (c("ka", 1, 1) - ka[1]))
        ctx.constraint(p_cont * act * (c("ka", 2, 1) - ka[2]))
        ctx.constraint(p_cont * act * (c("ka", 3, 1) - ka[3]))
        ctx.constraint(p_cont * act * (c("kc", 0, 1) - clk))
        ctx.constraint(act * (ka[0] - 4 * c("kq")))
        for i in range(3):
            ctx.add_fraction(1, "r256", [ka[i]])
        ctx.add_fraction(1, "r64", [ka[3]])
        ctx.add_fraction(1, "r64", [c("kq")])
        ctx.add_fraction(-p_first * act, "keccak", [clk, addr_lo, addr_hi])

        first = p_first * act
        last = p_last * act
        # word halves as weighted gathers over the stacked state
        lo_words, hi_words = None, None
        for j in range(16):
            wl = gather(A, f"lo{j}") * (1 << j)
            wh = gather(A, f"hi{j}") * (1 << j)
            lo_words = wl if lo_words is None else lo_words + wl
            hi_words = wh if hi_words is None else hi_words + wh
        for w in range(50):
            lo = Felt(lo_words.v[w], lo_words.kind, be, lo_words.deg)
            hi = Felt(hi_words.v[w], hi_words.kind, be, hi_words.deg)
            tsp = c("mtsp", w)
            ctx.add_fraction(-first, "mem", [addrW + 4 * w, lo, hi, tsp])
            ctx.add_fraction(last, "mem", [addrW + 4 * w, lo, hi, clk])
            d = c("mtsd", 4 * w) + c("mtsd", 4 * w + 1) * (1 << 8) \
                + c("mtsd", 4 * w + 2) * (1 << 16) \
                + c("mtsd", 4 * w + 3) * (1 << 24)
            ctx.constraint(first * (clk - tsp - 1 - d))
            for i in range(3):
                ctx.add_fraction(1, "r256", [c("mtsd", 4 * w + i)])
            ctx.add_fraction(1, "r64", [c("mtsd", 4 * w + 3)])


def _build_index() -> dict:
    """Every static gather of ``evaluate``, by name (int64 numpy)."""
    th_sum, d1, d2, dmap, chi0, chi1, chi2, rc_sel = \
        KeccakComponent._wiring()
    out = {f"th_sum{y}": th_sum[y] for y in range(5)}
    out.update(d1=d1, d2=d2, dmap=dmap, chi0=chi0, chi1=chi1, chi2=chi2,
               rc_full=np.where(rc_sel >= 0, rc_sel, 0),
               rc_mask=(rc_sel >= 0).astype(np.int64))
    for j in range(16):
        lo = np.array([64 * (w // 2) + 32 * (w % 2) + j
                       for w in range(50)], np.int64)
        out[f"lo{j}"], out[f"hi{j}"] = lo, lo + 16
    return out


_INDEX = _build_index()

