"""The port's constraint tapes against the JAX package.

Every component of the fib10, mixed and keccak machine programs and
chip_smoke's two synthetic components go through both packages on the
same seeded numpy inputs, uint32-exact:

* composition: the port's domain tape (the plain interpreter of kernel
  K7 and its epilogue) against the body of the reference's
  `run_constraints_domain` (`nexus_zkvm_tpu/air/component.py:601`:
  `DomainEvalContext`, evaluate, `_finalize_logup`, `finalize_acc`);
* interaction: the port's gen tape and LogUp columns (K7's operands,
  K6's plain version) against the body of the reference's
  `generate_interaction` (`_gen_interaction_body`, :346).

The reference bodies run eagerly on XLA:CPU: its stored AOT programs
would compile one XLA program per component and size first, which
costs minutes.  Then the traps of recording keccak-style evaluate()
code, the tape cache, the OODS dot (kernel K8's plain version) and the
opening gather (K9's) against the reference.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from test_torch_machine import FIB10_SRC, KECCAK_SRC
from nexus_zkvm_tpu.air import Component as RComponent
from nexus_zkvm_tpu.air import component as RC
from nexus_zkvm_tpu.air.lookups import draw_relations as rdraw
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.ops import merkle as RM
from nexus_zkvm_tpu.prover import stark as RS
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import Component
from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.air.tape import (
    ID, MAIN, PRE, INTER, ISF, TapeBackend, Recorder, air_eval_composition,
    domain_tape, gen_tape, generate_interaction, tape_stats)
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.ops.field import np_qm31_add, np_qm31_mul
from nexus_zkvm_tpu_torch.ops import merkle as TM
from nexus_zkvm_tpu_torch.prover.stark import (
    _relation_widths, oods_dot, oods_dot_plain)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace

P = (1 << 31) - 1
LOG = 3                      # trace rows 2^3, evaluation rows 2^5
SOURCES = {"fib10": FIB10_SRC, "mixed": chip_smoke.MIXED_SRC,
           "keccak": KECCAK_SRC}
# build_components gives the same 17 components for every program
MACHINE = ["cpu", "program", "regfile", "ram_touched", "mem_init",
           "output_check", "mext", "keccak", "pre_dummy_div", "range256",
           "range128", "range64", "range8", "and4", "xor4", "shl8", "shr8"]


class Traps(Component):
    """keccak.py's recording traps in miniature: payloads stacked with
    np.stack (:146) and gathered by index arrays (:155), a raw numpy 0/1
    mask wrapped as a Felt (:209), main_block's vector payloads, vector
    constraints read as arr[b], and an odd number of LogUp fractions
    (the last batch holds one)."""
    name = "traps"
    n_main = 6

    def evaluate(self, ctx):
        felt = type(ctx.main(0))
        cols = [ctx.main(i) for i in range(4)]
        S = felt(np.stack([f.v for f in cols]), "m31", ctx.be, 1)
        G = felt(S.v[np.array([3, 0, 2, 2])], "m31", ctx.be, 1)
        row_nd = G.v.ndim
        M = felt(np.array([1, 0, 1, 1]).reshape((4,) + (1,) * (row_nd - 1)),
                 "m31", ctx.be, 0)
        if hasattr(ctx, "main_block"):
            B, B1 = ctx.main_block(2, 6), ctx.main_block(2, 6, off=1)
        else:
            B = felt(np.stack([ctx.main(i).v for i in range(2, 6)]), "m31",
                     ctx.be, 1)
            B1 = felt(np.stack([ctx.main(i, 1).v for i in range(2, 6)]),
                      "m31", ctx.be, 1)
        ctx.constraint(cols[0] * cols[1] - 3)
        ctx.constraint_vec((G * M + B * B1 - 1).as_qm31().v, 4)
        ctx.add_fraction(cols[0], "vals", [cols[1], cols[2]])
        ctx.add_fraction(1, "vals", [cols[3]])
        ctx.add_fraction(-cols[2], "vals", [felt(G.v[1], "m31", ctx.be, 1)])


def _synthetic():
    comps = chip_smoke.make_components() + [Traps()]
    ref = [type(c.__class__.__name__, (RComponent,),
                {"name": c.name, "n_main": c.n_main,
                 "evaluate": type(c).evaluate})() for c in comps]
    return ref, comps


@pytest.fixture(scope="module")
def programs():
    """name -> (reference components, port components)."""
    out = {}
    for prog, src in SOURCES.items():
        rv, _rt = rk_trace(rasm.assemble(src), backend="python")
        tv, _tt = tk_trace(tasm.assemble(src), backend="python")
        out[prog] = (rdriver.build_components(rv, 1)[0],
                     tdriver.build_components(tv, 1)[0])
    out["synthetic"] = _synthetic()
    return out


def _relations(ref_comps, comps):
    widths = _relation_widths([component_info(c) for c in comps])
    return rdraw(RChannel(), widths), draw_relations(T.Blake2sChannel(),
                                                     widths)


def _pick(programs, prog, name):
    rc, tc = programs[prog]
    i = [c.name for c in tc].index(name)
    assert rc[i].name == name
    rrel, trel = _relations(rc, tc)
    return rc[i], tc[i], rrel, trel


CASES = ([(p, n) for p in SOURCES for n in MACHINE]
         + [("synthetic", n) for n in ("wide_squares", "vals_table",
                                        "traps")])


def _u32(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint32)


@pytest.mark.parametrize("prog,name", CASES)
def test_composition_equals_reference(programs, prog, name):
    rcomp, comp, rrel, trel = _pick(programs, prog, name)
    info = component_info(comp)
    rng = np.random.default_rng(CASES.index((prog, name)))
    N = 1 << (LOG + 2)
    main, pre = _u32(rng, (info.n_main, N)), _u32(rng, (info.n_pre, N))
    inter = _u32(rng, (info.n_logup_cols, N, 4))
    isf = _u32(rng, (1, N))
    claimed, alpha, shift = (_u32(rng, 4).astype(np.uint64)
                             for _ in range(3))
    invv, start = _u32(rng, N), _u32(rng, (N, 4))

    ctx = RC.DomainEvalContext(
        jnp.asarray(main), jnp.asarray(pre if info.n_pre else main[:1]),
        jnp.asarray(inter), jnp.asarray(isf[0]), rrel,
        jnp.asarray(claimed.astype(np.uint32)),
        jnp.asarray(alpha.astype(np.uint32)),
        params=RC._params_flat(rcomp))
    rcomp.evaluate(ctx)
    RC._finalize_logup(ctx)
    ctx.finalize_acc()
    acc = np.asarray(ctx.acc.as_qm31().v, np.uint64)
    want = np_qm31_add(start, np_qm31_mul(
        np.broadcast_to(shift, acc.shape),
        (acc * invv[:, None].astype(np.uint64)) % P))

    tape = domain_tape(comp, LOG, trel)
    assert tape.n_constraints == info.n_constraints
    # the one window [0, N): blocks of natural rows -hneg .. N + hpos
    hneg, hpos = domain_halo(info)
    rows = np.arange(-hneg, N + hpos) % N
    mats = {MAIN: from_u32(main[:, rows], "cpu"),
            PRE: from_u32(pre[:, rows], "cpu") if info.n_pre else None,
            INTER: (from_u32(inter.transpose(0, 2, 1).reshape(-1, N)[:, rows],
                             "cpu") if info.n_logup_cols else None),
            ISF: from_u32(isf[:, rows], "cpu")}
    got = from_u32(start, "cpu")
    air_eval_composition(tape, mats, tape.uniforms(trel, claimed), 0, N,
                         hneg, alpha, shift, from_u32(invv, "cpu"), got)
    assert np.array_equal(to_u32(got), want.astype(np.uint32))


@pytest.mark.parametrize("prog,name", CASES)
def test_operands_equal_reference(programs, prog, name):
    """The gen tape's operands through K6's plain version: the LogUp
    columns and claimed sum of the reference's generate_interaction."""
    rcomp, comp, rrel, trel = _pick(programs, prog, name)
    info = component_info(comp)
    rng = np.random.default_rng(1000 + CASES.index((prog, name)))
    M = 1 << LOG
    main, pre = _u32(rng, (info.n_main, M)), _u32(rng, (info.n_pre, M))
    cols = RC._gen_interaction_body(
        rcomp, jnp.asarray(main), jnp.asarray(pre) if info.n_pre else None,
        rrel, LOG, RC._params_flat(rcomp))
    got, claimed = generate_interaction(
        comp, from_u32(main, "cpu"),
        from_u32(pre, "cpu") if info.n_pre else None, trel, LOG, "cpu")
    if not info.n_logup_cols:
        assert got is None and not len(cols)
        return
    assert np.array_equal(to_u32(got), np.asarray(cols, np.uint32))
    assert np.array_equal(to_u32(claimed), np.asarray(cols[-1][-1],
                                                      np.uint32))


# ---------------------------------------------------------------------------
# K7's instruction stream (the schedule air/tape_cuda.py writes out as
# code), run by a numpy model
# ---------------------------------------------------------------------------

def _run_program(tape, mats, table, N):
    """What the instruction stream computes, instruction by instruction
    over all N rows at once: operand words decoded, slots as registers,
    emits weighted from ``table`` (the uniforms and, for a domain tape,
    the weights), stores into the packed buffer.  Returns the (N, 4)
    accumulator or the operand buffer."""
    from nexus_zkvm_tpu_torch.air import tape as tp
    rows = np.arange(N)
    slots = np.zeros((max(1, tape.n_slots), N), np.uint64)
    acc = np.zeros((N, 4), np.uint64)
    e = np.zeros((N, 4), np.uint64)
    stores, _meta, words = tape.layout(N) if tape.kind == "gen" else \
        (None, None, 0)
    out = np.zeros(words, np.uint32)

    def fetch(w):
        kind, idx = w >> 30, w & 0x3FFFFFFF
        if kind == 0:
            return slots[idx]
        if kind == 1:
            return np.full(N, table[idx], np.uint64)
        role, col, off = tape.loads[idx]
        return mats[role][col, (rows + off * tape.stride) & (N - 1)] \
            .astype(np.uint64)

    def weight(at):
        return np.broadcast_to(table[at:at + 4].astype(np.uint64), (N, 4))
    for code, dst, a, b in tape.program.view(np.uint32).astype(np.int64):
        x = fetch(a)
        if code == tp.K_ADD:
            slots[dst] = (x + fetch(b)) % P
        elif code == tp.K_SUB:
            slots[dst] = (x + P - fetch(b)) % P
        elif code == tp.K_MUL:
            slots[dst] = (x * fetch(b)) % P
        elif code == tp.K_NEG:
            slots[dst] = (P - x) % P
        elif code == tp.K_EMIT1:
            acc = (acc + weight(dst) * x[:, None]) % P
        elif code == tp.K_EMITQ_LO:
            e[:, 0], e[:, 1] = x, fetch(b)
        elif code == tp.K_EMITQ_HI:
            e[:, 2], e[:, 3] = x, fetch(b)
            acc = np_qm31_add(acc, np_qm31_mul(weight(dst), e))
        else:
            base, step = stores[dst, 1:]
            if step:
                out[base + step * rows] = x
            else:
                out[base] = x[0]
    return acc if tape.kind == "domain" else out


PROGRAM_CASES = ([("fib10", n) for n in MACHINE]
                 + [("synthetic", n) for n in ("wide_squares", "vals_table",
                                                "traps")])


@pytest.mark.parametrize("prog,name", PROGRAM_CASES)
def test_kernel_program_equals_interpreter(programs, prog, name):
    """Both tapes' K7 instruction streams (depth-first order, liveness
    slots, emit weights, stores), which the generated kernels are written
    from, compute what the plain interpreter does on the same seeded
    rows."""
    from nexus_zkvm_tpu_torch.air.tape import (
        air_eval_operands_plain, air_eval_plain, composition_uniforms)
    _rc, comp, _rr, trel = _pick(programs, prog, name)
    info = component_info(comp)
    rng = np.random.default_rng(2000 + PROGRAM_CASES.index((prog, name)))
    ran = 0
    for kind, log_n in (("domain", LOG + 2), ("gen", LOG)):
        N = 1 << log_n
        mats = {MAIN: _u32(rng, (info.n_main, N)),
                PRE: _u32(rng, (info.n_pre, N)),
                INTER: _u32(rng, (4 * info.n_logup_cols, N)),
                ISF: _u32(rng, (1, N))}
        tmats = {r: from_u32(m, "cpu") if len(m) else None
                 for r, m in mats.items()}
        if kind == "domain":
            tape = domain_tape(comp, LOG, trel)
            if tape is None:
                continue
            claimed, alpha = (_u32(rng, 4).astype(np.uint64) for _ in "ab")
            uni = tape.uniforms(trel, claimed)
            got = _run_program(tape, mats, composition_uniforms(
                tape, uni, alpha), N)
            want = air_eval_plain(tape, tmats, uni, N, alpha=alpha).numpy()
        else:
            tape = gen_tape(comp, LOG, trel)
            if tape is None:
                continue
            tmats[INTER] = None
            uni = tape.uniforms(trel, None)
            got = _run_program(tape, mats, uni, N)
            want = to_u32(air_eval_operands_plain(tape, tmats, uni, N))
        assert np.array_equal(got.astype(np.uint32), want), kind
        ran += 1
    assert ran


# ---------------------------------------------------------------------------
# recording traps, the cache
# ---------------------------------------------------------------------------

def test_raw_numpy_payload_is_a_constant():
    """A payload that is not node ids (keccak.py:209's mask) records as
    constants, which fold: x * 0 -> 0, x * 1 -> x."""
    rec = Recorder()
    be = TapeBackend(rec)
    x = rec.load(MAIN, np.arange(3), 0)
    ids = np.empty(3, ID)
    ids["n"] = x
    out = be.ids(be.m31_mul(ids, np.array([1, 0, 1])))
    assert out[0] == x[0] and out[2] == x[2]
    assert rec.op[out[1]] == 0 and rec.val[out[1]] == 0     # CONST 0


def test_stack_gather_and_vectors_keep_node_ids():
    """np.stack of payloads (keccak.py:146), gathers by index arrays
    (:155) and main_block's vectors stay node-id arrays; one numpy call
    records a whole vector operation."""
    from nexus_zkvm_tpu_torch.air.tape import TapeDomainContext
    ctx = TapeDomainContext({}, {})
    S = np.stack([ctx.main(i).v for i in range(4)])
    assert S.dtype == ID and S.shape == (4,)
    G = S[np.array([3, 3, 0])]
    assert G.dtype == ID and list(G["n"]) == [S["n"][3]] * 2 + [S["n"][0]]
    B = ctx.main_block(0, 1600)
    n0 = ctx.rec.n
    prod = B * B
    assert prod.v.dtype == ID and prod.v.shape == (1600,)
    assert ctx.rec.n - n0 == 1600
    ctx.constraint_vec(prod.as_qm31().v, 1600)
    assert ctx.n_constraints == 1600 and ctx.emits[0].shape == (1600, 4)


def test_finalize_logup_takes_the_generic_branch_in_order():
    """The tape contexts emit the LogUp constraints after evaluate()'s,
    one per batch (the padded last batch included): the counts of
    component_info."""
    comp = Traps()
    info = component_info(comp)
    widths = _relation_widths([info])
    tape = domain_tape(comp, LOG, draw_relations(T.Blake2sChannel(), widths))
    assert info.n_logup_cols == 2
    assert tape.n_constraints == info.n_constraints == 1 + 4 + 2
    assert len(tape.emits) == tape.n_constraints


def test_tape_cache_reuses_the_tape_across_challenges():
    comp = chip_smoke.make_components()[0]
    widths = _relation_widths([component_info(comp)])
    ch1, ch2 = T.Blake2sChannel(), T.Blake2sChannel()
    ch2.mix_u32s(np.arange(4, dtype=np.uint32))
    r1, r2 = draw_relations(ch1, widths), draw_relations(ch2, widths)
    assert not np.array_equal(r1["vals"].z, r2["vals"].z)
    assert domain_tape(comp, LOG, r1) is domain_tape(comp, LOG, r2)
    assert gen_tape(comp, LOG, r1) is gen_tape(comp, LOG, r2)
    u1 = domain_tape(comp, LOG, r1).uniforms(r1, np.zeros(4, np.uint64))
    u2 = domain_tape(comp, LOG, r1).uniforms(r2, np.zeros(4, np.uint64))
    assert not np.array_equal(u1, u2)


def test_tape_stats_report_length_and_slots():
    comp = chip_smoke.make_components()[0]
    widths = _relation_widths([component_info(comp)])
    st = tape_stats(comp, LOG, draw_relations(T.Blake2sChannel(), widths))
    assert st["domain"]["outputs"] == component_info(comp).n_constraints
    assert 0 < st["domain"]["slots"] < st["domain"]["instructions"]
    assert st["gen"]["outputs"] > 0


# ---------------------------------------------------------------------------
# OODS dot (K8) and the opening gather (K9)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n,C", [(4, 3), (12, 2)])
def test_oods_dot_equals_reference(log_n, C):
    rng = np.random.default_rng(log_n)
    cols = _u32(rng, (C, 1 << log_n))
    point = tuple(_u32(rng, 4).astype(np.uint64) for _ in range(2))
    factors = RS._oods_basis_factors(log_n, point)
    assert np.array_equal(factors, T.prover.stark._oods_basis_factors(
        log_n, point))
    want = np.asarray(RS._oods_dot_factored(jnp.asarray(cols),
                                            jnp.asarray(factors)))
    basis = np.asarray(RS._oods_basis_factors(log_n, point))
    full = np.zeros((1, 4), np.uint64)
    full[0, 0] = 1
    for f in basis.astype(np.uint64):
        full = np.concatenate([full, np_qm31_mul(f[None], full)])
    want2 = np.asarray(RS._oods_dot(jnp.asarray(cols),
                                    jnp.asarray(full.astype(np.uint32))))
    got = oods_dot(from_u32(cols, "cpu"), factors)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(got.numpy().astype(np.uint32), want2)
    assert torch.equal(got, oods_dot_plain(from_u32(cols, "cpu"), factors))


def _dec_equal(g, w) -> bool:
    return (len(g.column_values) == len(w.column_values)
            and all(np.array_equal(np.asarray(a, np.uint32),
                                   np.asarray(b, np.uint32))
                    for a, b in zip(g.column_values, w.column_values))
            and np.array_equal(np.asarray(g.sibling_hashes, np.uint32),
                               np.asarray(w.sibling_hashes, np.uint32)))


def test_gather_equals_reference_fused_openings():
    """Two matrix trees, three openings gathered in one buffer, against
    the reference's decommit_many_fused."""
    rng = np.random.default_rng(11)
    mats = [_u32(rng, (5, 64)), _u32(rng, (3, 16))]
    ttrees = [TM.commit_matrix(from_u32(m, "cpu")) for m in mats]
    rtrees = [RM.commit_matrix(jnp.asarray(m)) for m in mats]
    qs = [sorted(set(rng.integers(0, 64, 4).tolist())),
          sorted(set(rng.integers(0, 16, 3).tolist())),
          sorted(set(rng.integers(0, 64, 4).tolist()))]
    which = [0, 1, 0]
    got = TM.finalize_decommitments(TM.decommit_many_fused(
        [(ttrees[w], q) for w, q in zip(which, qs)]))
    want = RM.finalize_decommitments(RM.decommit_many_fused(
        [(rtrees[w], q) for w, q in zip(which, qs)], pad_q=8))
    assert all(_dec_equal(g, w) for g, w in zip(got, want))
    for (w, q), d in zip(zip(which, qs), got):
        assert TM.verify_decommitment(ttrees[w].root(),
                                      [mats[w].shape[1]] * len(mats[w]), q, d)


def test_gather_equals_reference_mixed_tree():
    """A mixed-depth tree: per-depth column values and the siblings."""
    rng = np.random.default_rng(12)
    depths = (6, 4, 6, 2)
    cols = [_u32(rng, 1 << d) for d in depths]
    ttree = TM.commit([from_u32(c, "cpu") for c in cols])
    rtree = RM.commit([jnp.asarray(c) for c in cols])
    q = sorted(set(rng.integers(0, 64, 5).tolist()))
    got = TM.decommit(ttree, q)
    assert _dec_equal(got, RM.decommit(rtree, q))
    assert TM.verify_decommitment(ttree.root(), [len(c) for c in cols], q,
                                  got)
