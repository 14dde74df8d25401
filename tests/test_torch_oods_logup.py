"""K8's work partition and lazy sums, and K6's batched inversion, emulated.

K8 (csrc/oods.cu) samples every OODS group of a proof in one launch: a
descriptor a group (`stark.oods_plan`), units of R rows by H high
indices taken by a persistent grid, each thread summing its lo words
over hi in uint64 without reducing (folded every 4 words).  The
emulation below walks every unit, thread and slot with the kernel's
index math, checks that each word of each group is read once, that a
unit's row sums gather only words of one row (a thread's slots, then a
warp's lanes), and that no uint64 sum wraps, at words of p - 1 and p;
its samples are held to `oods_dot_plain` and to the JAX package's
`_oods_dot_factored`.

K6 (csrc/logup.cu) inverts the norms of a row's denominators a chunk of
LOGUP_CHUNK pairs at a time (Montgomery's trick), a zero norm replaced
by 1 in the product chain and its inverse forced to 0.  The emulation
runs that order over every row and is held to `logup_columns_plain`
(zero denominators at the first, middle and last place of a chunk, and
across chunk boundaries) and to the JAX package's
`_gen_interaction_body` on a fib component.  The card tests
(`tests/test_torch_cuda.py`) hold the kernels to the same plain
versions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_machine import FIB10_SRC, _both, _cols
from nexus_zkvm_tpu.air.component import generate_interaction as rgen
from nexus_zkvm_tpu.air.lookups import draw_relations as rdraw
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.prover import stark as RS
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import tape as tape_mod
from nexus_zkvm_tpu_torch.air.component import (
    LOGUP_CHUNK, M31_COL, M31_CONST, QM31_COL, QM31_CONST, component_info,
    logup_columns_plain)
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.ops import field as F
from nexus_zkvm_tpu_torch.ops.field import np_qm31_mul
from nexus_zkvm_tpu_torch.prover.stark import (
    OODS_CHUNK, OODS_FIELDS, OODS_LO_BITS, _oods_basis_factors,
    _relation_widths, oods_dot_groups, oods_dot_groups_plain,
    oods_dot_plain, oods_plan)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

P = (1 << 31) - 1
THREADS = 256                    # kThreads of csrc/oods.cu
STEP = 8                         # its kStep: high indices a load
D = {name: i for i, name in enumerate(OODS_FIELDS)}


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def fold(s):
    """csrc/oods.cu `fold`: s mod 2^32 + 2 (s >> 32), exact mod p."""
    return (s & np.uint64(0xFFFFFFFF)) + np.uint64(2) * (s >> np.uint64(32))


def add_no_wrap(s, t):
    new = s + t
    assert (new >= s).all(), "a uint64 sum wrapped"
    return new


def emulate_basis(table, facts, E):
    """Pass 1: entry e finds its group by the kernel's search (the last
    with basis <= e), then multiplies the factors of its index's set bits
    (B_lo over factors 0..k-1, B_hi over k..n-1)."""
    e = np.arange(E)
    gi = np.searchsorted(table[:, D["basis"]], e, side="right") - 1
    k, n = table[gi, D["k"]], table[gi, D["log_n"]]
    idx = e - table[gi, D["basis"]]
    hi = idx >= (1 << k)
    idx = np.where(hi, idx - (1 << k), idx)
    f0, nbits = np.where(hi, k, 0), np.where(hi, n - k, k)
    out = np.zeros((E, 4), np.uint64)
    out[:, 0] = 1
    for b in range(int(nbits.max(initial=0))):
        sel = (b < nbits) & (((idx >> b) & 1) == 1)
        for i in np.flatnonzero(sel):
            out[i] = np_qm31_mul(out[i], facts[gi[i]][f0[i] + b]
                                 .astype(np.uint64))
    return out


def emulate_oods(groups, chunk=OODS_CHUNK):
    """csrc/oods.cu over numpy: (sum of rows, 4) uint32 samples of the
    groups [(batch (R, 2^n) uint32, rows or None, factors (n, 4))]."""
    rows = [list(range(len(b))) if r is None else list(r)
            for b, r, _f in groups]
    order, table, E, U = oods_plan([(len(r), len(f)) for r, (_b, _r, f)
                                    in zip(rows, groups)], chunk)
    facts = [np.asarray(groups[g][2], np.uint32) for g in order]
    basis = emulate_basis(table, facts, E)
    rows_cat = np.concatenate(rows)
    n_out = len(rows_cat)
    per = (1 << OODS_LO_BITS) // THREADS
    w = np.arange(THREADS * per)             # slot i of thread t: t + 256 i
    reads = [np.zeros(b.shape, np.int64) for b, _r, _f in groups]
    acc = np.zeros((n_out, 4), np.uint64)
    unit0 = table[:, D["unit0"]]
    for u in range(U):
        gi = np.searchsorted(unit0, u, side="right") - 1
        d = table[gi]
        batch = groups[order[gi]][0]
        n, k, H, R = (int(d[D[x]]) for x in ("log_n", "k", "H", "R"))
        loc = u - int(d[D["unit0"]])
        r0 = loc // int(d[D["n_chunks"]]) * R
        rows_here = min(R, int(d[D["n_rows"]]) - r0)
        h0 = loc % int(d[D["n_chunks"]]) * H
        assert R << k == THREADS * per
        rl, lo = w >> k, w & ((1 << k) - 1)
        on = rl < rows_here
        ridx = np.zeros_like(w)
        ridx[on] = rows_cat[d[D["rows"]] + r0 + rl[on]]
        bhi = basis[d[D["basis"]] + (1 << k) + h0:][:H]
        s = np.zeros((len(w), 4), np.uint64)
        for h in range(0, H, STEP):
            for j in range(STEP):
                if h + j < H:
                    col = ((h0 + h + j) << k) + lo[on]
                    x = np.zeros(len(w), np.uint64)
                    x[on] = batch[ridx[on], col]
                    np.add.at(reads[order[gi]], (ridx[on], col), 1)
                    s = add_no_wrap(s, x[:, None] * bhi[h + j][None, :])
                if j % 4 == 3:
                    s = fold(s)
        v = np_qm31_mul(s % np.uint64(P), basis[d[D["basis"]] + lo])
        v[~on] = 0
        # a thread's slots of one row, then a warp's lanes of it, then one
        # atomic a coordinate; every member of a sum lies in its row
        V, RL, ON = (a.reshape(per, THREADS, *a.shape[1:])
                     for a in (v, rl, on))
        run, start = np.zeros((THREADS, 4), np.uint64), 0
        for i in range(per):
            run = (run + V[i]) % np.uint64(P)
            if i == per - 1 or k < 8 or ((i + 1) >> (k - 8)) != (i >> (k - 8)):
                assert (RL[start:i + 1] == RL[i]).all()
                seg = 1 << k if k < 5 else 32
                rows_seg = RL[i].reshape(-1, seg)
                assert (rows_seg == rows_seg[:, :1]).all()
                assert (ON[i].reshape(-1, seg) == ON[i].reshape(-1, seg)[:, :1]).all()
                sums = run.reshape(-1, seg, 4).sum(axis=1) % np.uint64(P)
                for lead in range(0, THREADS, seg):
                    if ON[i][lead]:
                        o = d[D["rows"]] + r0 + RL[i][lead]
                        acc[o] = add_no_wrap(acc[o], sums[lead // seg])
                run, start = np.zeros((THREADS, 4), np.uint64), i + 1
    for (b, _r, _f), cnt, rw in zip(groups, reads, rows):
        want = np.bincount(rw, minlength=len(b))[:, None]
        assert (cnt == want).all(), "a word read more or less than listed"
    return (acc % np.uint64(P)).astype(np.uint32)


def _groups(rng, specs, words=None):
    """[(batch, rows, factors)] of specs [(batch rows, log_n, rows or
    None)]; words: None for random words in [0, p], else that word."""
    out = []
    for R, n, rows in specs:
        b = (rng.integers(0, P + 1, (R, 1 << n), dtype=np.uint32)
             if words is None else np.full((R, 1 << n), words, np.uint32))
        out.append((b, rows, rng.integers(0, P, (n, 4), dtype=np.uint32)))
    return out


def _plain(groups):
    return to_u32(oods_dot_groups_plain([(from_u32(b, "cpu"), r, f)
                                         for b, r, f in groups]))


# shared batches, row subsets out of order, every lo/hi split
SPECS = [
    [(3, 4, None)],
    [(5, 12, [4, 0, 2]), (5, 12, None), (2, 0, None), (7, 1, [6, 1])],
    [(40, 3, list(range(39, -1, -3))), (9, 9, None), (2, 11, [1]),
     (3, 14, [2, 0]), (70, 5, None)],
    [(1, 10, None), (33, 2, None), (4, 8, [3, 3, 0])],
]


@pytest.mark.parametrize("chunk", [OODS_CHUNK, 8, 2])
@pytest.mark.parametrize("case", range(len(SPECS)))
def test_oods_emulation_equals_plain(case, chunk):
    rng = np.random.default_rng(100 * case + chunk)
    groups = _groups(rng, SPECS[case])
    assert np.array_equal(emulate_oods(groups, chunk), _plain(groups))


@pytest.mark.parametrize("word", [P - 1, P])
def test_oods_lazy_sums_never_wrap_at_the_extremes(word):
    """Words of p - 1 and p (a non-canonical zero) through every split;
    the emulation's uint64 sums are checked at every add.  Then the
    fold's bound itself: after a fold s < 3 * 2^32, and four products of
    p and p add at most 4 p^2 < 2^64 - 3 * 2^32."""
    rng = np.random.default_rng(word)
    groups = _groups(rng, [(2, 13, None), (3, 7, [2, 0]), (1, 11, None)],
                     words=word)
    assert np.array_equal(emulate_oods(groups, chunk=8), _plain(groups))
    s = (1 << 64) - 1
    for _ in range(64):
        s = (s & 0xFFFFFFFF) + 2 * (s >> 32)
        assert s < 3 << 32
        s += 4 * P * P
        assert s < 1 << 64


def test_oods_plan_fills_whole_steps_largest_units_first():
    """Short rows pack into one step (R 2^k = 2^OODS_LO_BITS words); long
    rows split at OODS_LO_BITS, their high indices in chunks; units ascend in
    launch order, the largest first; every group's units are counted."""
    shapes = [(3, 2), (244, 20), (5, 9), (4, 14), (3781, 5), (1, 0)]
    order, table, E, U = oods_plan(shapes, 256)
    assert sorted(order) == list(range(len(shapes)))
    words = table[:, D["R"]] * table[:, D["H"]] << table[:, D["k"]]
    assert (np.diff(words) <= 0).all()
    for row, g in zip(table, order):
        r, n = shapes[g]
        k = min(n, 10)
        assert (row[D["n_rows"]], row[D["log_n"]], row[D["k"]]) == (r, n, k)
        assert row[D["R"]] << k == 1 << 10 or k == 10
        assert row[D["H"]] * row[D["n_chunks"]] == 1 << (n - k)
        assert row[D["rows"]] == sum(s[0] for s in shapes[:g])
    n_units = -(-table[:, D["n_rows"]] // table[:, D["R"]]) * \
        table[:, D["n_chunks"]]
    assert np.array_equal(table[:, D["unit0"]],
                          np.concatenate([[0], np.cumsum(n_units)[:-1]]))
    assert U == n_units.sum()
    assert E == sum((1 << int(t[D["k"]])) + (1 << int(t[D["log_n"]] - t[D["k"]]))
                    for t in table)


@pytest.mark.parametrize("log_n,C", [(4, 3), (12, 2)])
def test_oods_emulation_equals_reference(log_n, C):
    """The JAX package's `_oods_dot_factored` at a real point's factors."""
    rng = np.random.default_rng(log_n)
    cols = rng.integers(0, P, (C, 1 << log_n), dtype=np.uint32)
    point = tuple(rng.integers(0, P, 4, dtype=np.uint32).astype(np.uint64)
                  for _ in range(2))
    factors = _oods_basis_factors(log_n, point)
    want = np.asarray(RS._oods_dot_factored(jnp.asarray(cols),
                                            jnp.asarray(factors)))
    got = emulate_oods([(cols, None, factors), (cols, [1, 0], factors)])
    assert np.array_equal(got[:C], want)
    assert np.array_equal(got[C:], want[[1, 0]])


def test_oods_dot_groups_on_the_cpu_is_the_plain_loop():
    rng = np.random.default_rng(7)
    groups = _groups(rng, SPECS[1])
    t = [(from_u32(b, "cpu"), r, f) for b, r, f in groups]
    want = torch.cat([oods_dot_plain(b if r is None else b[r], f)
                      for b, r, f in t])
    assert torch.equal(oods_dot_groups(t), want.to(torch.int32))
    with pytest.raises(ValueError):
        oods_dot_groups([(t[0][0], [5], t[0][2])])


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _operand(src, off, mode, M):
    """(value (M or 1, 4) int64, is M31) as csrc/logup.cu loads it."""
    if mode == M31_CONST:
        return F.qm31_from_m31(src[off:off + 1].to(torch.int64)), True
    if mode == M31_COL:
        return F.qm31_from_m31(src[off:off + M].to(torch.int64)), True
    if mode == QM31_CONST:
        return src[off:off + 4].to(torch.int64)[None, :], False
    return src[off:off + 4 * M].to(torch.int64).reshape(M, 4), False


def _r(c):
    """CM31 times R = 2 + i."""
    return torch.stack([F.m31_sub(F.m31_add(c[..., 0], c[..., 0]), c[..., 1]),
                        F.m31_add(F.m31_add(c[..., 1], c[..., 1]),
                                  c[..., 0])], dim=-1)


def over_norm(num, den, den_m31):
    """csrc/logup.cu `over_norm`: (t, m) with f = t / m; m = 0 iff den
    = 0."""
    if den_m31:
        return num, den[..., 0]
    A, Bq = den[..., :2], den[..., 2:]
    c = F.m31_sub(F.cm31_mul(A, A), _r(F.cm31_mul(Bq, Bq)))
    m = F.m31_add(F.m31_mul(c[..., 0], c[..., 0]),
                  F.m31_mul(c[..., 1], c[..., 1]))
    cj = torch.stack([c[..., 0], F.m31_neg(c[..., 1])], dim=-1)
    adj = torch.cat([F.cm31_mul(A, cj), F.m31_neg(F.cm31_mul(Bq, cj))],
                    dim=-1)
    return F.qm31_mul(num, adj), m


def emulate_logup(src, meta, M, chunk=LOGUP_CHUNK, guard_zeros=True):
    """csrc/logup.cu over every row at once: pairs a chunk at a time,
    one M31 inverse of the chunk's norms (zeros as 1, their inverses
    forced to 0 unless ``guard_zeros`` is off), then the running sums
    and the last column's prefix over rows."""
    table = meta.tolist()
    B = len(table[0])
    s = torch.zeros((M, 4), dtype=torch.int64)
    cols = []
    for b0 in range(0, B, chunk):
        ts, ms, before = [], [], []
        prod = torch.ones(M, dtype=torch.int64)
        for b in range(b0, min(B, b0 + chunk)):
            (n1, _), (d1, b1), (n2, _), (d2, b2) = (
                _operand(src, *table[k][b], M) for k in range(4))
            num = F.qm31_add(F.qm31_mul(n1, d2), F.qm31_mul(n2, d1))
            t, m = over_norm(num, F.qm31_mul(d1, d2), b1 and b2)
            t, m = t.expand(M, 4), m.expand(M)
            before.append(prod)
            prod = F.m31_mul(prod, torch.where(m == 0, 1, m)
                             if guard_zeros else m)
            ts.append(t)
            ms.append(m)
        if guard_zeros:
            assert bool((prod != 0).all())
        inv = F.m31_inv(prod)
        for j in reversed(range(len(ts))):
            mi = F.m31_mul(inv, before[j])
            if guard_zeros:
                mi = torch.where(ms[j] == 0, 0, mi)
            inv = F.m31_mul(inv, torch.where(ms[j] == 0, 1, ms[j])
                            if guard_zeros else ms[j])
            ts[j] = F.qm31_mul_m31(ts[j], mi)
        for j, t in enumerate(ts):
            s = F.qm31_add(s, t)
            if b0 + j < B - 1:
                cols.append(s.to(torch.int32))
    cols.append(torch.remainder(torch.cumsum(s, dim=0), P).to(torch.int32))
    return torch.stack(cols)


def _packed(rng, B, M, zero_pairs=()):
    """Random operands of B pairs over M rows, each of a random mode,
    every word in [1, p); the denominators of ``zero_pairs`` are 0: a
    column's at rows 0, M // 2 and M - 1, a constant everywhere."""
    pieces, meta, off = [], [], 0
    for k in range(4):
        for b in range(B):
            mode = int(rng.integers(0, 4))
            n = (1, M, 4, 4 * M)[mode]
            words = rng.integers(1, P, n, dtype=np.uint32)
            if k % 2 and b in zero_pairs:
                if mode in (M31_CONST, QM31_CONST):
                    words[:] = 0
                else:
                    w = 1 if mode == M31_COL else 4
                    for r in (0, M // 2, M - 1):
                        words[w * r:w * r + w] = 0
            pieces.append(words)
            meta.append((off, mode))
            off += n
    return (from_u32(np.concatenate(pieces), "cpu"),
            torch.tensor(meta, dtype=torch.int64).reshape(4, B, 2))


@pytest.mark.parametrize("B,M", [(1, 5), (7, 33), (LOGUP_CHUNK, 9),
                                 (LOGUP_CHUNK + 1, 9), (61, 17), (70, 3)])
def test_logup_emulation_equals_plain(B, M):
    rng = np.random.default_rng(B * 100 + M)
    src, meta = _packed(rng, B, M)
    assert torch.equal(emulate_logup(src, meta, M),
                       logup_columns_plain(src, meta, M))


C = LOGUP_CHUNK
ZERO_CASES = {
    "first": [0, C],
    "middle": [C // 2, C + C // 2],
    "last": [C - 1, 2 * C - 1],
    "boundaries": [C - 1, C, 2 * C + 2],
    "whole_chunk": list(range(C)) + [C + 3],
}


@pytest.mark.parametrize("where", list(ZERO_CASES))
def test_logup_zero_denominators(where):
    """Zero denominators (every operand mode) at the first, middle and
    last place of a chunk give f = 0, as the plain version's inv(0) = 0
    does; without the substitution the zero would poison its chunk."""
    B, M = 2 * C + 3, 6
    rng = np.random.default_rng(len(where))
    src, meta = _packed(rng, B, M, ZERO_CASES[where])
    want = logup_columns_plain(src, meta, M)
    assert torch.equal(emulate_logup(src, meta, M), want)
    assert not torch.equal(emulate_logup(src, meta, M, guard_zeros=False),
                           want)


@pytest.fixture(scope="module")
def fib10():
    return _both(FIB10_SRC)


def test_logup_emulation_equals_reference(fib10, monkeypatch, name="regfile"):
    """The emulation on the port's operands of a fib component against
    the JAX package's `generate_interaction` (`_gen_interaction_body`)."""
    (rv, rt), (tv, tt) = fib10
    rc, rlogs, rtr = rdriver.build_machine_traces(rv, rt)
    tc, tlogs, ttr = tdriver.build_machine_traces(tv, tt, device="cpu")
    i = [c.name for c in tc].index(name)
    widths = _relation_widths([component_info(c) for c in tc])
    pre = [a for _n, a in tc[i].preprocessed(tlogs[i])]
    want, _claimed = rgen(rc[i], rtr[i], pre or None, rdraw(RChannel(), widths),
                          rlogs[i])
    seen = []
    monkeypatch.setattr(tape_mod, "logup_columns",
                        lambda *a: seen.append(a) or logup_columns_plain(*a))
    main = from_u32(_cols(ttr[i]), "cpu")
    tape_mod.generate_interaction(
        tc[i], main, from_u32(np.stack(pre), "cpu") if pre else None,
        draw_relations(T.Blake2sChannel(), widths), tlogs[i], "cpu")
    (src, meta, M), = seen
    assert np.array_equal(to_u32(emulate_logup(src, meta, M)),
                          np.asarray(want, np.uint32))
