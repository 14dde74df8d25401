"""M-extension component: MUL/MULH/MULHSU/MULHU/DIV/DIVU/REM/REMU.

Counterpart of the reference's M chips over the Karatsuba limb gadget
(`nexus-zkvm/prover/src/chips/instructions/m/`, `nexani.rs`) and
prover2's per-instruction components.  Architecture here follows
prover2: the CPU emits one `mext` relation tuple
(opid, b_lo, b_hi, c_lo, c_hi, a_lo, a_hi) per M-type row, and this
component — sized to the *number of M instructions*, not the full
trace — consumes each tuple and proves the arithmetic:

* 64-bit product via byte schoolbook: p = x * c with
  x = b (mul family) or x = quotient (div family); carries < 2^11
  committed as (byte, 3-bit) pairs.
* MULH/MULHSU signed corrections:  mulh(b,c) = mulhu(b,c)
  - sgn_b * c - sgn_c * b  (mod 2^32).
* DIVU/REMU: b = q*c + r with r < c (16-bit-limb borrow compare),
  q = 2^32-1 and r = b when c = 0.
* DIV/REM: on absolute values with RISC-V sign rules; the overflow
  case (-2^31 / -1) and division by zero handled by flags.

All tuple elements are 16-bit halves of range-checked byte columns, so
carry/borrow arithmetic is exact.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from ..vm.isa import Opcode
from .schema import Schema, Cols

__all__ = ["MExtComponent", "MEXT_SCHEMA", "M_OPS", "fill_mext"]

M_OPS = [Opcode.MUL, Opcode.MULH, Opcode.MULHSU, Opcode.MULHU,
         Opcode.DIV, Opcode.DIVU, Opcode.REM, Opcode.REMU]
_MIDX = {op: i for i, op in enumerate(M_OPS)}

MEXT_SCHEMA = Schema([
    ("mf", len(M_OPS)),          # one-hot op flags; all zero on padding
    ("b", 4), ("c", 4), ("a", 4),
    ("p", 8),                    # product bytes of x * c
    ("g", 7), ("gh", 7),         # carry bytes + high 3 bits
    ("qt", 4), ("rm", 4),        # quotient / remainder magnitudes
    ("sgn_b", 1), ("sgn_c", 1), ("b3l7", 1), ("c3l7", 1),
    ("bw", 2),                   # signed-hi correction borrows (0..2)
    ("babs", 4), ("cabs", 4),    # absolute values (signed div)
    ("ab", 2), ("ac", 2),        # abs-negation carries
    ("aa", 2),                   # result-negation carries
    ("neg_q", 1), ("neg_r", 1),  # result signs
    ("dz", 1), ("dzi", 1),       # divide-by-zero flag + inverse aux
    ("nzf", 1),                  # sdiv AND NOT dz (degree reducer)
    ("dbw", 2), ("dh", 4),       # r < divisor borrow compare
    ("cr", 2),                   # q*c + r recombination carries
])


class MExtComponent(Component):
    name = "mext"
    n_main = MEXT_SCHEMA.n_cols

    def evaluate(self, ctx):
        c = Cols(ctx, MEXT_SCHEMA)
        F = {op: c("mf", i) for op, i in _MIDX.items()}
        active = _s([F[o] for o in M_OPS])
        for op in M_OPS:
            ctx.constraint(F[op] * (F[op] - 1))
        ctx.constraint(active * (active - 1))
        for name in ("sgn_b", "sgn_c", "neg_q", "neg_r", "dz", "nzf"):
            ctx.constraint(c(name) * (c(name) - 1))
        for name in ("ab", "ac", "aa", "dbw", "cr"):
            for i in range(2):
                ctx.constraint(c(name, i) * (c(name, i) - 1))
        for i in range(2):   # correction borrows can reach 2
            ctx.constraint(c("bw", i) * (c("bw", i) - 1)
                           * (c("bw", i) - 2))

        b_lo, b_hi = c.lo("b"), c.hi("b")
        c_lo, c_hi = c.lo("c"), c.hi("c")
        a_lo, a_hi = c.lo("a"), c.hi("a")

        # consume the CPU's dispatch tuple
        opid = _s([F[op] * int(op) for op in M_OPS])
        ctx.add_fraction(-active, "mext",
                         [opid, b_lo, b_hi, c_lo, c_hi, a_lo, a_hi])

        mul_fam = _s([F[o] for o in (Opcode.MUL, Opcode.MULH,
                                     Opcode.MULHSU, Opcode.MULHU)])
        div_fam = _s([F[o] for o in (Opcode.DIV, Opcode.DIVU,
                                     Opcode.REM, Opcode.REMU)])
        sdiv = F[Opcode.DIV] + F[Opcode.REM]
        udiv = F[Opcode.DIVU] + F[Opcode.REMU]

        # -- sign decompositions ---------------------------------------
        sgn_need_b = _s([F[o] for o in (Opcode.MULH, Opcode.MULHSU,
                                        Opcode.DIV, Opcode.REM)])
        sgn_need_c = F[Opcode.MULH] + sdiv
        ctx.constraint(sgn_need_b * (c("b", 3) - 128 * c("sgn_b")
                                     - c("b3l7")))
        ctx.constraint(sgn_need_c * (c("c", 3) - 128 * c("sgn_c")
                                     - c("c3l7")))
        ctx.add_fraction(1, "r128", [c("b3l7")])
        ctx.add_fraction(1, "r128", [c("c3l7")])

        # -- absolute values (signed division) -------------------------
        # babs = sgn_b ? 2^32 - b : b   (same for c)
        for (v, av, sg, cy) in (("b", "babs", "sgn_b", "ab"),
                                ("c", "cabs", "sgn_c", "ac")):
            v_lo, v_hi = c.lo(v), c.hi(v)
            av_lo, av_hi = c.lo(av), c.hi(av)
            sgn = c(sg)
            ctx.constraint(sdiv * (
                (1 - sgn) * (av_lo - v_lo)
                + sgn * (v_lo + av_lo - (1 << 16) * c(cy, 0))))
            ctx.constraint(sdiv * (
                (1 - sgn) * (av_hi - v_hi)
                + sgn * (v_hi + av_hi + c(cy, 0)
                         - c(cy, 1) * (1 << 16) - (1 << 16))))
        # unsigned division operates directly on b/c; mul rows keep the
        # div-operand columns at zero so the shared product gadget sees
        # x = b, cc = c there
        for i in range(4):
            ctx.constraint(udiv * (c("babs", i) - c("b", i)))
            ctx.constraint(udiv * (c("cabs", i) - c("c", i)))
            ctx.constraint(mul_fam * c("qt", i))
            ctx.constraint(mul_fam * c("cabs", i))

        # -- 64-bit schoolbook product p = x * cc ----------------------
        # x = b (mul family) or qt (div family); cc = c or cabs
        x = [mul_fam * c("b", i) + div_fam * c("qt", i)
             for i in range(4)]
        cc = [mul_fam * c("c", j) + div_fam * c("cabs", j)
              for j in range(4)]
        for k in range(7):
            s_k = _s([x[i] * cc[k - i]
                      for i in range(max(0, k - 3), min(3, k) + 1)])
            g_k = c("g", k) + 256 * c("gh", k)
            prev = (c("g", k - 1) + 256 * c("gh", k - 1)) if k else 0
            ctx.constraint(s_k + prev - c("p", k) - 256 * g_k)
            ctx.add_fraction(1, "r256", [c("g", k)])
            ctx.add_fraction(1, "r8", [c("gh", k)])
        ctx.constraint(c("p", 7) - c("g", 6) - 256 * c("gh", 6))
        for i in range(8):
            ctx.add_fraction(1, "r256", [c("p", i)])
        # b/c/a must be range-checked here: the CPU dispatch tuple only
        # pins their 16-bit halves, and e.g. the sign split
        # b3 = 128*sgn_b + b3l7 reads byte 3 directly — without r256 on
        # each byte the hi-half decomposition (b2 + 256*b3) is malleable
        # and sgn_b/sgn_c could be flipped on div rows.
        for name in ("b", "c", "a", "qt", "rm", "babs", "cabs"):
            for i in range(4):
                ctx.add_fraction(1, "r256", [c(name, i)])

        p_lo = c("p", 0) + 256 * c("p", 1)
        p_hi = c("p", 2) + 256 * c("p", 3)
        ph_lo = c("p", 4) + 256 * c("p", 5)
        ph_hi = c("p", 6) + 256 * c("p", 7)

        # -- MUL / MULHU ----------------------------------------------
        ctx.constraint(F[Opcode.MUL] * (a_lo - p_lo))
        ctx.constraint(F[Opcode.MUL] * (a_hi - p_hi))
        ctx.constraint(F[Opcode.MULHU] * (a_lo - ph_lo))
        ctx.constraint(F[Opcode.MULHU] * (a_hi - ph_hi))

        # -- MULH / MULHSU: a = p_hi - sgn_b*c - sgn_c*b (mod 2^32) ---
        corr_lo = c("sgn_b") * c_lo + (F[Opcode.MULH] * c("sgn_c")) * b_lo
        corr_hi = c("sgn_b") * c_hi + (F[Opcode.MULH] * c("sgn_c")) * b_hi
        sh = F[Opcode.MULH] + F[Opcode.MULHSU]
        ctx.constraint(sh * (ph_lo - corr_lo + (1 << 16) * c("bw", 0)
                             - a_lo))
        ctx.constraint(sh * (ph_hi - corr_hi - c("bw", 0)
                             + (1 << 16) * c("bw", 1) - a_hi))

        # -- division: babs = qt*cabs + rm, rm < cabs ------------------
        # (p is qt*cabs for the div family)
        babs_lo, babs_hi = c.lo("babs"), c.hi("babs")
        cabs_lo, cabs_hi = c.lo("cabs"), c.hi("cabs")
        qt_lo, qt_hi = c.lo("qt"), c.hi("qt")
        rm_lo, rm_hi = c.lo("rm"), c.hi("rm")
        nz_div = div_fam * (1 - c("dz"))
        ctx.constraint(nz_div * (p_lo + rm_lo - babs_lo
                                 - (1 << 16) * c("cr", 0)))
        ctx.constraint(nz_div * (p_hi + rm_hi + c("cr", 0) - babs_hi
                                 - (1 << 16) * c("cr", 1)))
        ctx.constraint(nz_div * c("cr", 1))
        ctx.constraint(nz_div * ph_lo)          # product fits 32 bits
        ctx.constraint(nz_div * ph_hi)
        # rm < cabs via borrow compare: must borrow
        ctx.constraint(nz_div * (rm_lo - cabs_lo
                                 + (1 << 16) * c("dbw", 0) - c.lo("dh")))
        ctx.constraint(nz_div * (rm_hi - cabs_hi - c("dbw", 0)
                                 + (1 << 16) * c("dbw", 1) - c.hi("dh")))
        ctx.constraint(nz_div * (1 - c("dbw", 1)))
        for i in range(4):
            ctx.add_fraction(1, "r256", [c("dh", i)])
        # divide-by-zero: q = all-ones, r = b (result not negated)
        z = c_lo + c_hi
        dzf = c("dz")
        ctx.constraint(div_fam * (dzf * z))
        ctx.constraint(div_fam * (z * c("dzi") - (1 - dzf)))
        dq = F[Opcode.DIV] + F[Opcode.DIVU]
        dr = F[Opcode.REM] + F[Opcode.REMU]
        for i in range(4):
            ctx.constraint(dq * dzf * (c("a", i) - 255))
            ctx.constraint(dr * dzf * (c("a", i) - c("b", i)))
            ctx.constraint(div_fam * dzf * (c("qt", i) - 255))
            ctx.constraint(div_fam * dzf * (c("rm", i) - c("b", i)))
        # nzf = sdiv AND NOT dz (committed to keep tie degrees <= 4)
        ctx.constraint(sdiv * (c("nzf") - (1 - dzf)))
        ctx.constraint((1 - sdiv) * c("nzf"))
        # overflow (-2^31 / -1) needs no flag: qt = 2^31 = -2^31 mod
        # 2^32 with neg_q = 0 (sx = 0) reconstructs correctly.

        # -- result signs ----------------------------------------------
        # neg_q = sgn_b ^ sgn_c when q != 0; neg_r = sgn_b when r != 0
        sx = c("sgn_b") + c("sgn_c") - 2 * c("sgn_b") * c("sgn_c")
        ctx.constraint(c("nzf") * (c("neg_q") - sx) * qt_lo)
        ctx.constraint(c("nzf") * (c("neg_q") - sx) * qt_hi)
        ctx.constraint(c("nzf") * (c("neg_r") - c("sgn_b")) * rm_lo)
        ctx.constraint(c("nzf") * (c("neg_r") - c("sgn_b")) * rm_hi)
        ctx.constraint(udiv * c("neg_q"))
        ctx.constraint(udiv * c("neg_r"))
        # a = +-magnitude (two's complement via carry pair `aa`),
        # gated off on divide-by-zero rows (handled above)
        for (fam, mag_lo, mag_hi, neg) in (
                (dq, qt_lo, qt_hi, c("neg_q")),
                (dr, rm_lo, rm_hi, c("neg_r"))):
            gate = fam * (1 - dzf)
            ctx.constraint(gate * ((1 - neg) * (a_lo - mag_lo)
                                   + neg * (mag_lo + a_lo
                                            - (1 << 16) * c("aa", 0))))
            ctx.constraint(gate * ((1 - neg) * (a_hi - mag_hi)
                                   + neg * (mag_hi + a_hi + c("aa", 0)
                                            - (1 << 16) * c("aa", 1)
                                            - (1 << 16))))


def _s(fs):
    acc = fs[0]
    for f in fs[1:]:
        acc = acc + f
    return acc


def fill_mext(trace, log_size: int):
    """Rows = M-type steps only (vectorized); returns (fill, emits)."""
    s = trace.steps
    opc = s["opcode"]
    m_mask = np.isin(opc, [int(o) for o in M_OPS])
    idx = np.nonzero(m_mask)[0]
    n = len(idx)
    N = 1 << log_size
    assert n <= N
    f = MEXT_SCHEMA.alloc(N)
    if n == 0:
        return f, _mext_emits(f)
    opcs = opc[idx]
    b = s["b_val"][idx].astype(np.uint64)
    cv = s["c_val"][idx].astype(np.uint64)
    a = s["a_val"][idx].astype(np.uint64)
    for op, i in _MIDX.items():
        f["mf"][:n, i] = opcs == int(op)

    def put4(name, vals):
        v = np.asarray(vals, np.uint64)
        for i in range(4):
            f[name][:n, i] = (v >> (8 * i)) & 0xFF

    put4("b", b)
    put4("c", cv)
    put4("a", a)

    sdiv = np.isin(opcs, [int(Opcode.DIV), int(Opcode.REM)])
    udiv = np.isin(opcs, [int(Opcode.DIVU), int(Opcode.REMU)])
    div_fam = sdiv | udiv
    mul_fam = ~div_fam
    sgn_need_b = np.isin(opcs, [int(Opcode.MULH), int(Opcode.MULHSU),
                                int(Opcode.DIV), int(Opcode.REM)])
    sgn_need_c = np.isin(opcs, [int(Opcode.MULH)]) | sdiv
    sgn_b = np.where(sgn_need_b, b >> 31, 0)
    sgn_c = np.where(sgn_need_c, cv >> 31, 0)
    f["sgn_b"][:n] = sgn_b
    f["sgn_c"][:n] = sgn_c
    f["b3l7"][:n] = np.where(sgn_need_b, (b >> 24) & 0x7F, 0)
    f["c3l7"][:n] = np.where(sgn_need_c, (cv >> 24) & 0x7F, 0)

    M32 = np.uint64(0xFFFFFFFF)
    babs = np.where(sdiv & (sgn_b == 1), ((~b) + 1) & M32, b)
    cabs = np.where(sdiv & (sgn_c == 1), ((~cv) + 1) & M32, cv)
    babs = np.where(div_fam, babs, 0)
    cabs = np.where(div_fam, cabs, 0)
    put4("babs", babs)
    put4("cabs", cabs)
    # abs-negation carries: v_lo + av_lo = 2^16 * ab0 ; ...
    # negation carries: v + av = 2^32 exactly, so the hi equation
    # v_hi + av_hi + c0 = 2^16 * (1 + c1) always has c1 = 0
    for (v, av, sg, cy, gate) in ((b, babs, sgn_b, "ab", sdiv),
                                  (cv, cabs, sgn_c, "ac", sdiv)):
        on = gate & (sg == 1)
        lo_sum = (v & 0xFFFF) + (av & 0xFFFF)
        f[cy][:n, 0] = np.where(on, lo_sum >> 16, 0)

    dz = div_fam & (cv == 0)
    f["dz"][:n] = dz
    zsum = ((cv & 0xFFFF) + (cv >> 16)) % np.uint64((1 << 31) - 1)
    f["dzi"][:n] = np.where(div_fam & ~dz, _inv(zsum), 0)

    qt = np.zeros(n, np.uint64)
    rm = np.zeros(n, np.uint64)
    nz = div_fam & ~dz
    with np.errstate(divide="ignore", invalid="ignore"):
        qt[nz] = babs[nz] // np.where(cabs[nz] == 0, 1, cabs[nz])
        rm[nz] = babs[nz] - qt[nz] * cabs[nz]
    qt[dz] = 0xFFFFFFFF
    rm[dz] = b[dz]
    put4("qt", qt)
    put4("rm", rm)

    # schoolbook product p = x * cc
    x = np.where(mul_fam, b, qt)
    cc = np.where(mul_fam, cv, cabs)
    xb = [(x >> (8 * i)) & 0xFF for i in range(4)]
    cb = [(cc >> (8 * j)) & 0xFF for j in range(4)]
    gprev = np.zeros(n, np.uint64)
    for k in range(7):
        s_k = gprev.copy()
        for i in range(max(0, k - 3), min(3, k) + 1):
            s_k += xb[i] * cb[k - i]
        f["p"][:n, k] = s_k & 0xFF
        g_k = s_k >> 8
        f["g"][:n, k] = g_k & 0xFF
        f["gh"][:n, k] = g_k >> 8
        gprev = g_k
    f["p"][:n, 7] = gprev

    # mulh borrow pair
    sh = np.isin(opcs, [int(Opcode.MULH), int(Opcode.MULHSU)])
    corr_lo = sgn_b * (cv & 0xFFFF) \
        + np.where(opcs == int(Opcode.MULH), sgn_c, 0) * (b & 0xFFFF)
    corr_hi = sgn_b * (cv >> 16) \
        + np.where(opcs == int(Opcode.MULH), sgn_c, 0) * (b >> 16)
    ph_lo = f["p"][:n, 4].astype(np.uint64) \
        + 256 * f["p"][:n, 5].astype(np.uint64)
    ph_hi = f["p"][:n, 6].astype(np.uint64) \
        + 256 * f["p"][:n, 7].astype(np.uint64)
    lhs = ph_lo.astype(np.int64) - corr_lo.astype(np.int64)
    bw0 = np.where(sh, ((a & 0xFFFF).astype(np.int64) - lhs) >> 16, 0)
    f["bw"][:n, 0] = bw0
    lhs_hi = ph_hi.astype(np.int64) - corr_hi.astype(np.int64) - bw0
    f["bw"][:n, 1] = np.where(
        sh, ((a >> 16).astype(np.int64) - lhs_hi) >> 16, 0)

    # q*c + r = b recombination carries
    p_lo = f["p"][:n, 0].astype(np.uint64) \
        + 256 * f["p"][:n, 1].astype(np.uint64)
    cr0 = np.where(nz, (p_lo + (rm & 0xFFFF)) >> 16, 0)
    f["cr"][:n, 0] = cr0

    # rm < cabs borrow compare
    dbw0 = np.where(nz, (rm & 0xFFFF) < (cabs & 0xFFFF),
                    False).astype(np.uint64)
    dh_lo = ((rm & 0xFFFF) - (cabs & 0xFFFF)
             + (dbw0 << np.uint64(16))) & np.uint64(0xFFFF)
    dbw1 = np.where(nz, 1, 0).astype(np.uint64)
    dh_hi = ((rm >> np.uint64(16)) - (cabs >> np.uint64(16)) - dbw0
             + (dbw1 << np.uint64(16))) & np.uint64(0xFFFF)
    f["dbw"][:n, 0] = dbw0
    f["dbw"][:n, 1] = dbw1
    f["dh"][:n, 0] = np.where(nz, dh_lo & 0xFF, 0)
    f["dh"][:n, 1] = np.where(nz, dh_lo >> 8, 0)
    f["dh"][:n, 2] = np.where(nz, dh_hi & 0xFF, 0)
    f["dh"][:n, 3] = np.where(nz, dh_hi >> 8, 0)

    # result signs + negation carries
    sx = sgn_b ^ sgn_c
    neg_q = np.where(sdiv & ~dz & (qt != 0), sx, 0)
    neg_r = np.where(sdiv & ~dz & (rm != 0), sgn_b, 0)
    f["neg_q"][:n] = neg_q
    f["neg_r"][:n] = neg_r
    f["nzf"][:n] = sdiv & ~dz
    dq = np.isin(opcs, [int(Opcode.DIV), int(Opcode.DIVU)])
    mag = np.where(dq, qt, rm)
    neg = np.where(dq, neg_q, neg_r)
    on = div_fam & ~dz & (neg == 1)
    lo_sum = (mag & 0xFFFF) + (a & 0xFFFF)
    f["aa"][:n, 0] = np.where(on, lo_sum >> 16, 0)
    # second negation carry is always 0 (see `ab`/`ac` note above)

    return f, _mext_emits(f)


def _mext_emits(f):
    out256, out128, out8 = [], [], []
    for name in ("g", "p"):
        for i in range(f[name].shape[1]):
            out256.append(f[name][:, i].astype(np.int64))
    for name in ("b", "c", "a", "qt", "rm", "babs", "cabs", "dh"):
        for i in range(4):
            out256.append(f[name][:, i].astype(np.int64))
    for name in ("b3l7", "c3l7"):
        out128.append(f[name].astype(np.int64))
    for i in range(7):
        out8.append(f["gh"][:, i].astype(np.int64))
    return {"r256": np.concatenate(out256),
            "r128": np.concatenate(out128),
            "r8": np.concatenate(out8)}


def _inv(vals):
    from ..ops.field import np_m31_inv
    v = np.asarray(vals, np.uint64)
    out = np.zeros_like(v)
    m = v != 0
    if m.any():
        out[m] = np_m31_inv(v[m])
    return out
