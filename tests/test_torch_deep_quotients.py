"""K3's partition, ring and lazy sums, and the epilogue K3 and K12 share,
emulated.

K3 (csrc/quotients.cu) gives each block a run of points and streams the
size group's columns through a ring of shared-memory stages, a stage
straddling role blocks where it falls across one; each thread sums raw
uint64 products for its points and folds them after every 4 columns.
The emulation below follows `quotients.quotient_plan` and the kernel's
own column-to-(block, row) walk, copies every stage's runs into the
ring in the kernel's issue order (a slot refilled only after its stage
was folded), checks that every (column, point) word is read exactly
once and that no uint64 sum wraps, at words of p - 1 and p.

The epilogue (`quotient_sum`) forms V = x dy - y dx + c0 (c0 = dx zy -
dy zx), each V's M31 norm and adjugate, one M31 inverse for all of a
thread's norms (Montgomery's trick, a zero norm replaced by 1 and its
inverse forced to 0), and the sum of num / V.  Both kernels' emulations
are held to `accumulate_blocks_plain` and `colsum_finalize_plain`, with
a zero V at the first, middle and last place of a thread's batch, and
to the JAX package's `_accumulate_blocks` and `colsum_finalize` on
XLA:CPU.  The card tests (`tests/test_torch_cuda.py`) hold the kernels
to the same plain versions.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nexus_zkvm_tpu.ops import quotients as RQ
from nexus_zkvm_tpu_torch.ops import quotients as TQ
from nexus_zkvm_tpu_torch.ops.circle import committed_points
from nexus_zkvm_tpu_torch.ops.field import (
    np_m31_pow, np_qm31_mul, np_qm31_sub)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
import torch_cpu  # noqa: F401  (one torch thread a test process)

P = (1 << 31) - 1
U = np.uint64
PLAN = TQ.QUOTIENT_PLAN
CSRC = Path(TQ.__file__).resolve().parents[1] / "csrc" / "quotients.cu"


def add_no_wrap(s, t):
    new = s + t
    assert (new >= s).all(), "a uint64 sum wrapped"
    return new


def fold(s):
    """quotients.cu `m31_fold64`: s mod 2^31 + (s >> 31)."""
    return (s & U(P)) + (s >> U(31))


# ---------------------------------------------------------------------------
# The epilogue
# ---------------------------------------------------------------------------

def sample_consts(consts):
    """quotients.cu `sample_consts`: dx, dy, A, B and c0 = dx zy - dy zx,
    each (S, 4)."""
    c = consts.astype(U)
    zx, zy, dx, dy, A, B = (c[:, i] for i in range(6))
    return dx, dy, A, B, np_qm31_sub(np_qm31_mul(dx, zy), np_qm31_mul(dy, zx))


def norm_adj(V):
    """qm31_lazy.cuh `norm_adj`: (A - B u) conj(c) and m = |c|^2 with
    c = A^2 - R B^2, for V = A + B u (..., 4)."""
    a0, a1, b0, b1 = (V[..., i] for i in range(4))
    sa0, sa1 = (a0 * a0 + a1 * (P - a1)) % P, 2 * a0 * a1 % P
    sb0, sb1 = (b0 * b0 + b1 * (P - b1)) % P, 2 * b0 * b1 % P
    c0 = (sa0 + 2 * P - (2 * sb0 + P - sb1) % P) % P       # - R (sb0 + sb1 i)
    c1 = (sa1 + 2 * P - (2 * sb1 + sb0) % P) % P
    m = (c0 * c0 + c1 * c1) % P
    adj = np.stack([(a0 * c0 + a1 * c1) % P, (a1 * c0 + a0 * (P - c1)) % P,
                    (b0 * (P - c0) + b1 * (P - c1)) % P,
                    (b0 * c1 + b1 * (P - c0)) % P], axis=-1)
    return adj, m


def invert_batch(m, guard=True):
    """qm31_lazy.cuh `invert_batch` along the last axis: one inverse of
    the chain's product; with ``guard`` a zero is 1 in the chain and its
    inverse 0."""
    chain, before = np.ones(m.shape[:-1], U), []
    for j in range(m.shape[-1]):
        before.append(chain)
        mj = np.where(m[..., j] == 0, U(1), m[..., j]) if guard else m[..., j]
        chain = chain * mj % P
    if guard:
        assert (chain != 0).all()
    inv = np_m31_pow(chain, P - 2)
    out = np.empty_like(m)
    for j in reversed(range(m.shape[-1])):
        mj = m[..., j]
        out[..., j] = inv * before[j] % P
        if guard:
            out[..., j] = np.where(mj == 0, U(0), out[..., j])
            mj = np.where(mj == 0, U(1), mj)
        inv = inv * mj % P
    return out


def epilogue(sums, xs, ys, consts, threads, points, guard=True):
    """quotients.cu `quotient_sum` for every thread: sums (M, S, 4)
    uint64 (congruent column sums, each checked below 2^64 as the kernel
    adds A y + B), point p = b (threads points) + q threads + t batched
    with the other points of its (b, t) and all samples.  Returns
    (M, 4) uint32."""
    M, S = sums.shape[:2]
    x, y = xs.astype(U), ys.astype(U)
    dx, dy, A, B, c0 = sample_consts(consts)
    ny = (P - y)[:, None, None]
    V = (x[:, None, None] * dy + ny * dx + c0) % P          # (M, S, 4)
    raw = add_no_wrap(add_no_wrap(sums, ny * A), P - B)
    adj, m = norm_adj(V)
    t = np_qm31_mul(raw % P, adj)
    run = threads * points
    nb = -(-M // run)
    # the kernel's batch: (block, thread) x (point q, sample s)
    mb = np.ones((nb * run, S), U)
    mb[:M] = m
    mb = mb.reshape(nb, points, threads, S).transpose(0, 2, 1, 3) \
        .reshape(nb, threads, points * S)
    inv = invert_batch(mb, guard).reshape(nb, threads, points, S) \
        .transpose(0, 2, 1, 3).reshape(nb * run, S)[:M]
    terms = t * inv[..., None] % P
    return (terms.sum(axis=1) % P).astype(np.uint32)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def kernel_column(rows, k):
    """`issue_stage`'s walk from the group's column k to (block, row)."""
    r = 0
    while k >= rows[r]:
        k -= rows[r]
        r += 1
    return r, k


def emulate_k3(blocks, xs, ys, consts, gcs, guard=True):
    """csrc/quotients.cu K3 over numpy: blocks (C_r, M) uint32, xs, ys
    (M,), consts (S, 6, 4), gcs (S, K, 4).  Returns (M, 4) uint32."""
    rows = [len(b) for b in blocks]
    M, (S, K) = len(xs), gcs.shape[:2]
    plan = TQ.quotient_plan(rows, M, S)
    run, nb, n = plan["run"], plan["blocks"], np.array(plan["n"])
    T, c, depth = PLAN["threads"], plan["cols"], plan["stages"]
    assert nb * run >= M > (nb - 1) * run and (n[:-1] == run).all()
    # each block's copy of a column: words p0 .. p0 + n_b of its row
    p0 = np.arange(nb) * run
    idx = p0[:, None] + np.arange(run)[None, :]
    on = np.arange(run)[None, :] < n[:, None]
    # ring[slot][i]: column i of the stage in `slot`, (nb, run) words a
    # block; what a short block leaves unwritten keeps the slot's old
    # words, as shared memory does
    ring = [[np.zeros((nb, run), np.uint32) if k < min(c, K) else None
             for k in range(c)] for _ in range(depth)]
    gs = np.zeros((depth, S, c, 4), U)
    held = [None] * depth                 # the stage each slot holds
    folded = set()
    reads = np.zeros((K, M), np.int64)

    def issue(st):
        slot = st % depth
        assert held[slot] is None or held[slot] in folded, \
            "a slot refilled before its stage was folded"
        held[slot] = st
        for i, (r, j) in enumerate(plan["where"][st]):
            k = st * c + i
            assert kernel_column(rows, k) == (r, j)
            ring[slot][i][on] = blocks[r][j][idx[on]]
            reads[k, idx[on]] += 1
        nk = len(plan["where"][st])
        gs[slot, :, :nk] = gcs[:, st * c:st * c + nk]

    sums = np.zeros((nb, run, S, 4), U)
    stages = len(plan["where"])
    for st in range(min(depth - 1, stages)):
        issue(st)
    for st in range(stages):
        if st + depth - 1 < stages:
            issue(st + depth - 1)
        slot = st % depth
        assert held[slot] == st
        nk = len(plan["where"][st])
        for k4 in range(0, nk, 4):
            for k in range(k4, min(k4 + 4, nk)):
                v = ring[slot][k].astype(U)[:, :, None, None]
                g = gs[slot, :, k][None, None]          # (1, 1, S, 4)
                live = (g != 0).any(axis=-1, keepdims=True)
                sums = add_no_wrap(sums, np.where(live, v * g, U(0)))
            sums = fold(sums)
        folded.add(st)
    assert (reads == 1).all(), "a word read more or less than once"
    sums = sums.reshape(nb * run, S, 4)[:M]
    return epilogue(sums, xs, ys, consts, T, plan["points"], guard)


def k3_case(rng, rows, log_m, S, word=None, zero_v=()):
    M, K = 1 << log_m, sum(rows)
    if word is None:
        blocks = [rng.integers(0, P, (r, M), dtype=np.uint32) for r in rows]
        gcs = rng.integers(0, P, (S, K, 4), dtype=np.uint32)
        for s in range(1, S):                  # columns absent from a sample
            gcs[s, rng.random(K) < 0.6] = 0
    else:
        blocks = [np.full((r, M), word, np.uint32) for r in rows]
        gcs = np.full((S, K, 4), P - 1, np.uint32)
    consts = rng.integers(0, P, (S, 6, 4), dtype=np.uint32)
    for s in zero_v:
        consts[s, 2:4] = 0                     # dx = dy = 0: V = 0
    xs, ys = committed_points(log_m)
    return blocks, xs, ys, consts, gcs


def plain_k3(blocks, xs, ys, consts, gcs):
    t = [from_u32(a, "cpu") for a in (xs, ys, consts, gcs)]
    return to_u32(TQ.accumulate_blocks_plain(
        [from_u32(b, "cpu") for b in blocks], *t))


# (role block rows, log M, samples): both of K3's shapes (S <= 2: 4
# points a thread, stages of 8 columns; S > 2: 1 point, 32 columns); K
# below, at and across a stage; the fib 2^20 proof's roles (1, 193,
# 244), so stages straddle role boundaries; M from one short block of 4
# points to 2^21
K3_CASES = [((3,), 2, 1), ((17,), 3, 2), ((1, 7, 9), 5, 3),
            ((1, 193, 244), 4, 2), ((1, 193, 244), 6, 3), ((40,), 9, 1),
            ((32, 1), 9, 4), ((5, 12), 10, 5), ((9, 3), 11, 2),
            ((14, 17), 12, 8), ((2, 1), 21, 1)]


@pytest.mark.parametrize("rows,log_m,S", K3_CASES)
def test_k3_emulation_equals_plain(rows, log_m, S):
    rng = np.random.default_rng(log_m * 10 + S)
    case = k3_case(rng, rows, log_m, S)
    assert np.array_equal(emulate_k3(*case), plain_k3(*case))


@pytest.mark.parametrize("word", [P - 1, P])
def test_k3_lazy_sums_never_wrap_at_the_extremes(word):
    """Words of p - 1 and p (a non-canonical zero) and coefficients of
    p - 1 through the fib proof's roles; the emulation's sums are
    checked at every add.  Then the bounds themselves: after a fold
    s < 2^33 + 2^31; four products of p and p - 1 keep it below 2^64, and
    so does the epilogue's A y + B after a last fold."""
    rng = np.random.default_rng(word)
    case = k3_case(rng, (1, 193, 244), 5, 3, word=word)
    assert np.array_equal(emulate_k3(*case), plain_k3(*case))
    bound = (1 << 33) + (1 << 31)
    s = (1 << 64) - 1
    for _ in range(64):
        s = (s & P) + (s >> 31)
        assert s < bound
        assert s + 4 * P * (P - 1) < 1 << 64
        s += 4 * P * (P - 1)
    assert bound + P * (P - 1) + P < 1 << 64


def test_k3_plan_matches_the_kernel():
    """QUOTIENT_PLAN is the kernels' shape (csrc/quotients.cu); every
    stage but the last is whole and a multiple of 4 columns, so the fold
    cadence within a stage is the group's; the runs cover M."""
    text = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert (const("kQThreads"), const("kQFewSamples"), const("kFThreads"),
            const("kFPoints")) == (PLAN["threads"], PLAN["few_samples"],
                                   PLAN["finalize_threads"],
                                   PLAN["finalize_points"])
    for key in ("points", "cols", "stages"):
        few, many = re.search(rf"{key} = S <= kQFewSamples \? (\d+) : "
                              rf"(\d+);", text).groups()
        assert (int(few), int(many)) == (PLAN["few"][key], PLAN["many"][key])
    for rows, M, S in (((1, 193, 244), 1 << 21, 2), ((3,), 4, 1),
                       ((73, 3781, 616), 64, 3), ((5, 12), 1000, 8)):
        plan = TQ.quotient_plan(rows, M, S)
        assert plan["cols"] % 4 == 0
        assert [len(s) for s in plan["where"][:-1]] == \
            [plan["cols"]] * (len(plan["where"]) - 1)
        assert sum(len(s) for s in plan["where"]) == sum(rows)
        assert sum(plan["n"]) == M and plan["run"] == \
            PLAN["threads"] * plan["points"]


@pytest.mark.parametrize("rows,log_m,S", [((1, 193, 244), 23, 2),
                                          ((193, 244), 24, 2),
                                          ((1, 193, 244), 24, 3),
                                          ((1, 772, 976), 23, 2),
                                          ((1544, 1952), 23, 2),
                                          ((386, 488), 24, 3)])
def test_k3_plan_addresses_at_the_largest_groups(rows, log_m, S):
    """K3's plan at the largest size groups: the fib proof's 438 columns
    at 2^23 points (a resident 2^22-row trace) and the main and
    interaction trees at 2^24 (a resident 2^23-row trace); segmented,
    the columns of four and eight 2^22-row CPU components at 2^23
    points and of two 2^23-row ones at 2^24, a block of up to 1,952
    columns (8.2 x 10^9 words: past 2^32) when nothing streams.  The grid
    fits 2^31 - 1 blocks, a stage's bulk copies expect fewer than 2^32
    bytes, and the first and last blocks' copies (column k of role
    block r from point p0: word k M + p0) lie inside their blocks, the
    last one past 2^31 words at 2^24 points, where the kernel's offset
    is 64-bit."""
    text = CSRC.read_text()
    assert "rb.ptr[r] + (long long)k * M + p0, 4u * n" in text
    M = 1 << log_m
    plan = TQ.quotient_plan(rows, M, S)
    nb, run = plan["blocks"], plan["run"]
    assert nb <= 0x7FFFFFFF and nb * run == M
    for st in plan["where"]:
        assert len(st) * (4 * run + 16 * S) < 1 << 32
    far = 0
    for b in (0, nb - 1):
        p0, n = b * run, plan["n"][b]
        for st in plan["where"]:
            for r, j in st:
                first, last = j * M + p0, j * M + p0 + n - 1
                assert 0 <= first <= last < rows[r] * M
                far = max(far, last)
    assert far == max(rows) * M - 1
    assert (far >= 1 << 31) == (max(rows) * M > 1 << 31)


# ---------------------------------------------------------------------------
# The epilogue: V, zero V, K12
# ---------------------------------------------------------------------------

def test_v_rewrite_is_the_plain_denominator():
    """x dy - y dx + (dx zy - dy zx) = dy (x - zx) - dx (y - zy) word for
    word, for constants without structure and points at 0, 1, p - 1."""
    rng = np.random.default_rng(5)
    consts = rng.integers(0, P, (6, 6, 4), dtype=np.uint32)
    consts[0] = P - 1
    consts[1, :, 1:] = 0
    x = np.concatenate([[0, 1, P - 1, 0], rng.integers(0, P, 60)]).astype(U)
    y = np.concatenate([[0, P - 1, 1, P - 1], rng.integers(0, P, 60)]) \
        .astype(U)
    dx, dy, _A, _B, c0 = sample_consts(consts)
    for s in range(len(consts)):
        new = (x[:, None] * dy[s] + (P - y)[:, None] * dx[s] + c0[s]) % P
        zx, zy = consts[s, 0].astype(U), consts[s, 1].astype(U)
        X = np.zeros((len(x), 4), U)
        Y = np.zeros((len(y), 4), U)
        X[:, 0], Y[:, 0] = x, y
        old = np_qm31_sub(np_qm31_mul(dy[s], np_qm31_sub(X, zx)),
                          np_qm31_mul(dx[s], np_qm31_sub(Y, zy)))
        assert np.array_equal(new, old)


def emulate_k12(acc, xs, ys, consts, guard=True):
    """csrc/quotients.cu K12 over numpy: acc (S, M, 4) canonical sums."""
    return epilogue(acc.transpose(1, 0, 2).astype(U), xs, ys, consts,
                    PLAN["finalize_threads"], PLAN["finalize_points"], guard)


def plain_k12(acc, xs, ys, consts):
    return to_u32(TQ.colsum_finalize_plain(
        *(from_u32(a, "cpu") for a in (acc, xs, ys, consts))))


@pytest.mark.parametrize("S,M", [(1, 1), (2, 257), (3, 1 << 10), (8, 300)])
def test_k12_emulation_equals_plain(S, M):
    rng = np.random.default_rng(S * 1000 + M)
    acc = rng.integers(0, P, (S, M, 4), dtype=np.uint32)
    consts = rng.integers(0, P, (S, 6, 4), dtype=np.uint32)
    xs, ys = (rng.integers(0, P, M, dtype=np.uint32) for _ in range(2))
    assert np.array_equal(emulate_k12(acc, xs, ys, consts),
                          plain_k12(acc, xs, ys, consts))


@pytest.mark.parametrize("kernel,S", [("K3", 2), ("K3", 4), ("K12", 4)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_zero_v_in_a_thread_batch(kernel, S, where):
    """A sample with dx = dy = 0 has V = 0 at every point, so its norm
    is 0 at the first, middle or last sample of each of a thread's
    points in its batch (K3 at 2 samples: 4 points a thread; at 4: one;
    K12: 2 points).  Its term is 0, as the plain version's qm31_inv(0) = 0
    gives; without the substitution the zero would poison the batch."""
    s = {"first": 0, "middle": S // 2, "last": S - 1}[where]
    rng = np.random.default_rng(7 + s + S)
    if kernel == "K3":
        case = k3_case(rng, (5, 12), 11, S, zero_v=(s,))
        emulate, plain = emulate_k3, plain_k3
    else:
        M = 700
        case = (rng.integers(0, P, (S, M, 4), dtype=np.uint32),
                *(rng.integers(0, P, M, dtype=np.uint32) for _ in range(2)),
                rng.integers(0, P, (S, 6, 4), dtype=np.uint32))
        case[3][s, 2:4] = 0
        emulate, plain = emulate_k12, plain_k12
    want = plain(*case)
    assert np.array_equal(emulate(*case), want)
    assert not np.array_equal(emulate(*case, guard=False), want)


# ---------------------------------------------------------------------------
# The JAX package
# ---------------------------------------------------------------------------

def _jax_consts(consts):
    return [jnp.asarray(consts[:, i]) for i in range(6)]


@pytest.mark.parametrize("rows,log_m,S", [((1, 7, 9), 5, 2)])
def test_k3_emulation_equals_reference(rows, log_m, S):
    """The JAX package's `_accumulate_blocks` on XLA:CPU, role blocks as
    the reference's stark.quotients2 passes them."""
    rng = np.random.default_rng(31 + log_m)
    blocks, xs, ys, consts, gcs = case = k3_case(rng, rows, log_m, S,
                                                 zero_v=(1,))
    names = [f"r{i}" for i in range(len(rows))]
    raw = RQ._accumulate_blocks(S, tuple(zip(names, rows)))
    want = np.asarray(jax.jit(raw)(
        {n: jnp.asarray(b) for n, b in zip(names, blocks)}, jnp.asarray(xs),
        jnp.asarray(ys), *_jax_consts(consts), jnp.asarray(gcs)))
    assert np.array_equal(emulate_k3(*case), want)
    assert np.array_equal(plain_k3(*case), want)


def test_k12_emulation_equals_reference():
    """The JAX package's `colsum_finalize` on XLA:CPU."""
    rng = np.random.default_rng(41)
    S, log_m = 2, 9
    acc = rng.integers(0, P, (S, 1 << log_m, 4), dtype=np.uint32)
    consts = rng.integers(0, P, (S, 6, 4), dtype=np.uint32)
    consts[1, 2:4] = 0
    xs, ys = committed_points(log_m)
    want = np.asarray(jax.jit(RQ.colsum_finalize(S))(
        jnp.asarray(acc), jnp.asarray(xs), jnp.asarray(ys),
        *_jax_consts(consts)))
    assert np.array_equal(emulate_k12(acc, xs, ys, consts), want)
    assert np.array_equal(plain_k12(acc, xs, ys, consts), want)


def test_accumulate_blocks_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    blocks, xs, ys, consts, gcs = k3_case(rng, (2, 5), 4, 2)
    t = [from_u32(a, "cpu") for a in (xs, ys, consts, gcs)]
    got = TQ.accumulate_blocks([from_u32(b, "cpu") for b in blocks], *t)
    assert np.array_equal(to_u32(got), plain_k3(blocks, xs, ys, consts, gcs))
