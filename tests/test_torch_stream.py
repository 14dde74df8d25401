"""The large-trace memory mode of the PyTorch port against the JAX package.

Column-streamed commits (kernel K10's plain version), chunked
interpolation, opened values recomputed from coefficients, the
streamed quotients' column sums (K11, K12), halo-extended natural LDE
blocks and the composition's row passes (K7 over row windows), each
against its JAX counterpart or the port's resident route, uint32-exact;
then whole proofs under a forced ``MemoryConfig``: the e2e fixture
against the JAX package's streamed proof, and the fib n = 10 machine
proof against the reference digest, each with the route the prover
noted on its profile.
"""

import copy
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.ops import quotients as RQ
from nexus_zkvm_tpu.ops.circle import bit_reverse_indices
from nexus_zkvm_tpu.prover import pcs as rpcs, prove as rprove
from nexus_zkvm_tpu.prover import stark as rstark
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import tape as tp
from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.ops import blake2s, cfft, circle, merkle
from nexus_zkvm_tpu_torch.ops import quotients as TQ
from nexus_zkvm_tpu_torch.prover import pcs, stark
from nexus_zkvm_tpu_torch.sdk.serialize import proof_to_bytes
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.utils.profile import profiled
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace
import test_torch_machine as tmach
import test_torch_stark as tstark

P = (1 << 31) - 1


def rand(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# commitments and openings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,chunk_cols", [(100, 64), (64, 64), (17, 64),
                                          (70, 16), (5, 16)])
def test_stream_commit_equals_reference(C, chunk_cols):
    """Root and every layer: the JAX `_stream_commit`, the port's, and
    the port's `commit_matrix` on the committed evaluations."""
    n, s = 6, 7
    coeffs = rand(np.random.default_rng(C), (C, 1 << n))
    want = rpcs._stream_commit(jnp.asarray(coeffs), n, s,
                               chunk_cols=chunk_cols)
    t = from_u32(coeffs, "cpu")
    got = pcs._stream_commit(t, s, chunk_cols)
    whole = merkle.commit_matrix(
        cfft.evaluate(t, s)[:, circle.dev_bit_reverse(s, "cpu")])
    assert got.matrix is None
    for d in range(s + 1):
        ref = np.asarray(want.layers[d], np.uint32)
        assert np.array_equal(to_u32(got.layers[d]), ref), d
        assert np.array_equal(to_u32(whole.layers[d]), ref), d


@pytest.mark.parametrize("widths", [(16, 16, 3), (32, 7), (5,)])
def test_leaves_stream_plain_equals_hash_rows(widths):
    """K10's plain version, chunk by chunk, gives the leaves of the
    whole committed-order matrix."""
    s, C = 6, sum(widths)
    mat = from_u32(rand(np.random.default_rng(C), (C, 1 << s)), "cpu")
    want = blake2s.hash_rows_plain(
        mat[:, circle.dev_bit_reverse(s, "cpu")].t())
    state, done = None, 0
    for c in widths:
        state = blake2s.leaves_stream_plain(state, mat[done:done + c], done,
                                            C, done + c == C)
        done += c
    assert torch.equal(state, want)


def test_opened_values_streamed_equals_reference():
    n, blowup, C = 6, 1, 70
    s = n + blowup
    rng = np.random.default_rng(6)
    cols = [rand(rng, 1 << n) for _ in range(C)]
    positions = sorted({int(p) for p in rng.integers(0, 1 << s, 9)})
    rc_ref = rpcs.commit_columns("t", cols, [n] * C, blowup)
    want = np.asarray(rpcs.opened_values_streamed(rc_ref, s, positions,
                                                  chunk_cols=32))
    rc = pcs.commit_columns("t", cols, [n] * C, blowup, "cpu")
    got = to_u32(pcs.opened_values_streamed(rc, s, positions, 32))
    assert np.array_equal(got, want)
    assert np.array_equal(got, to_u32(rc.evals[s])[:, positions])


@pytest.mark.parametrize("in_place", [False, True])
def test_interpolate_big_equals_reference(in_place):
    n, C = 6, 40
    nat = rand(np.random.default_rng(7), (C, 1 << n))
    want = np.asarray(rpcs._interpolate_big(jnp.asarray(nat), n,
                                            chunk_rows=16))
    src = from_u32(nat, "cpu").clone()
    got = pcs._interpolate_big(src, n, chunk_rows=16, in_place=in_place)
    assert np.array_equal(to_u32(got), want)
    assert (got.data_ptr() == src.data_ptr()) == in_place


# ---------------------------------------------------------------------------
# streamed quotients
# ---------------------------------------------------------------------------

def test_colsum_fold_finalize_equals_reference():
    """Three role blocks folded in column chunks (the last from layout
    order, as a fresh LDE chunk is), then finalized: equal to the JAX
    `colsum_fold` / `colsum_finalize` and the port's `accumulate_blocks`."""
    rng = np.random.default_rng(8)
    s, rows = 7, (1, 9, 20)
    K, M = sum(rows), 1 << s
    cols = rand(rng, (K, M))
    z = circle.oods_point_from_felt(rng.integers(0, P, 4).astype(np.uint64))
    z1 = circle.qm31_point_add(z, circle.m31_point_as_qm31(
        circle.subgroup_gen(s - 1)))
    felts = rand(rng, (K + 3, 4)).astype(np.uint64)
    mk = (lambda m: [m.PointSample(point=z, columns=list(range(K)),
                                   values=list(felts[:K])),
                     m.PointSample(point=z1, columns=[3, 11, 29],
                                   values=list(felts[K:]))])
    gamma = rng.integers(0, P, 4).astype(np.uint64)
    ra = RQ.prep_args_full(mk(RQ), gamma, 5, K)
    ta = TQ.prep_args_full(mk(TQ), gamma, 5, K)
    xs, ys = circle.dev_committed_points(s, "cpu")
    consts, gcs = from_u32(ta["consts"], "cpu"), from_u32(ta["gcs"], "cpu")

    fold = RQ.colsum_fold(2)
    acc_ref = jnp.zeros((2, M, 4), jnp.uint32)
    acc = torch.zeros((2, M, 4), dtype=torch.int32)
    t_cols = from_u32(cols, "cpu")
    layout = from_u32(cols[:, bit_reverse_indices(s)], "cpu")  # its own brev
    for lo, hi, brev in ((0, 1, False), (1, 10, False), (10, 26, True),
                         (26, 30, True)):
        acc_ref = fold(acc_ref, jnp.asarray(cols[lo:hi]),
                       jnp.asarray(ra["gcs_full"][:, lo:hi]))
        block = layout[lo:hi] if brev else t_cols[lo:hi]
        TQ.colsum_fold(acc, block, gcs[:, lo:hi].contiguous(), brev)
    assert np.array_equal(to_u32(acc), np.asarray(acc_ref))
    want = np.asarray(RQ.colsum_finalize(2)(
        acc_ref, jnp.asarray(to_u32(xs)), jnp.asarray(to_u32(ys)),
        ra["zx"], ra["zy"], ra["dx"], ra["dy"], ra["A"], ra["B"]))
    got = to_u32(TQ.colsum_finalize(acc, xs, ys, consts))
    assert np.array_equal(got, want)
    blocks = [t_cols[:1], t_cols[1:10], t_cols[10:]]
    assert np.array_equal(got, to_u32(TQ.accumulate_blocks(
        blocks, xs, ys, consts, gcs)))


# ---------------------------------------------------------------------------
# composition passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 16), (48, 64), (16, 48), (0, 64)])
def test_lde_natural_equals_reference(lo, hi):
    """Halo-extended natural blocks of rows [lo, hi) of the 2^6 domain,
    wrapping at the domain's start and end (`pcs.lde_window`, two
    columns at a time)."""
    ev, halo = 6, (8, 4)
    coeffs = rand(np.random.default_rng(lo + hi), (5, 1 << 4))
    want = np.concatenate([np.asarray(b) for b in rstark._lde_nat_ext(
        jnp.asarray(coeffs), ev, halo, (lo, hi))])
    cols = from_u32(coeffs, "cpu")
    got = pcs.lde_window(lambda a, b: cols[a:b], [(0, 2), (2, 4), (4, 5)],
                         5, ev, lo - halo[0], hi - lo + sum(halo), "cpu")
    assert np.array_equal(to_u32(got), want)


def _pass_components():
    """The fixture's squares component, and the CPU component of the
    fib guest (with its relations)."""
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    comps = [tstark.COMPONENTS[0], tdriver.build_components(view, 1)[0][0]]
    rel = draw_relations(T.Blake2sChannel(), stark._relation_widths(
        [component_info(c) for c in comps]))
    return comps, rel


@pytest.mark.parametrize("passes", [2, 4])
@pytest.mark.parametrize("which", [0, 1], ids=["squares", "cpu"])
def test_composition_range_passes_equal_one_pass(which, passes):
    """K7's composition (plain version) over 2 and 4 row windows, each
    from halo-extended blocks cut from the natural columns with their
    wrap, adds what the one window [0, N) adds."""
    comps, rel = _pass_components()
    comp = comps[which]
    info = component_info(comp)
    log_size = 3
    N = 1 << (log_size + 2)
    tape = tp.domain_tape(comp, log_size, rel)
    rng = np.random.default_rng(which)
    full = {tp.MAIN: rand(rng, (info.n_main, N)),
            tp.INTER: rand(rng, (4 * info.n_logup_cols, N)),
            tp.ISF: rand(rng, (1, N))}
    if info.n_pre:
        full[tp.PRE] = rand(rng, (info.n_pre, N))
    claimed, alpha, shift = (rng.integers(0, P, 4).astype(np.uint64)
                             for _ in range(3))
    uni = tape.uniforms(rel, claimed)
    invv = from_u32(rand(rng, N), "cpu")
    start = from_u32(rand(rng, (N, 4)), "cpu")
    hneg, hpos = domain_halo(info)

    def compose(k):
        out, L = start.clone(), N // k
        for lo in range(0, N, L):
            rows = np.arange(lo - hneg, lo + L + hpos) % N
            mats = {r: from_u32(m[:, rows], "cpu") for r, m in full.items()}
            tp.air_eval_composition(tape, mats, uni, lo, L, hneg, alpha,
                                    shift, invv, out)
        return out
    assert torch.equal(compose(passes), compose(1))


# ---------------------------------------------------------------------------
# whole proofs under a forced MemoryConfig
# ---------------------------------------------------------------------------

# streams every tree above 256 bytes (every size group of the fixture
# but the 2-column main tree at 2^5), 16-column chunks, the squares
# component's composition in 4 passes
FIXTURE_MEMORY = T.MemoryConfig(stream_commit_bytes=256, stream_chunk_bytes=1,
                                comp_nat_budget=3000)


@pytest.fixture(scope="module")
def streamed_proofs():
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NZT_STREAM_COMMIT_BYTES", "256")
        mp.setenv("NZT_COMP_SPLIT_EV", "7")
        mp.setenv("NZT_COMP_NAT_BUDGET", "3000")
        ref = rprove(tstark.COMPONENTS, tstark.LOG_SIZES,
                     tstark.make_traces(), RChannel(), tstark.RCFG)
    finally:
        mp.undo()
    with profiled() as prof:
        port = T.prove(tstark.COMPONENTS, tstark.LOG_SIZES,
                       tstark.make_traces(), T.Blake2sChannel(), tstark.TCFG,
                       device="cpu", memory=FIXTURE_MEMORY)
    return ref, port, prof.notes


def test_fixture_memory_route(streamed_proofs):
    """The route the prover noted: the fixture's big trees streamed, the
    squares component composed in 4 passes."""
    route = streamed_proofs[2]
    assert ("main", 7) in route["streamed"] and ("inter", 7) in \
        route["streamed"] and ("main", 5) not in route["streamed"]
    assert route["composition_passes"] == [4, 1]


def test_streamed_proof_equals_reference(streamed_proofs):
    ref, port, _route = streamed_proofs
    assert tstark.tree_eq(tstark.to_port_proof(ref), port)


def test_streamed_proof_verifies_and_rejects_tampering(streamed_proofs):
    _ref, port, _route = streamed_proofs
    verify = (lambda p: T.verify(tstark.COMPONENTS, p, T.Blake2sChannel(),
                                 tstark.TCFG, device="cpu"))
    assert verify(port)
    for tamper in (tstark._tamper_opening, tstark._tamper_sampled):
        bad = copy.deepcopy(port)
        tamper(bad)
        assert not verify(bad)


def test_streamed_machine_proof_matches_reference_digest():
    """The fib n = 10 machine proof with every tree above 4 KB streamed
    and the larger compositions in 2 to 8 passes: the reference's
    bytes."""
    memory = T.MemoryConfig(stream_commit_bytes=4096, stream_chunk_bytes=1,
                            comp_nat_budget=300_000)
    view, trace = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    with profiled() as prof:
        proof = tdriver.prove_machine(view, trace, tmach.TCFG, device="cpu",
                                      memory=memory)
    route = prof.notes
    assert ("main", proof.stark.log_sizes[0] + 1) in route["streamed"]
    passes = route["composition_passes"]
    assert passes[0] == 2 and max(passes) > 2
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        tmach.FIB10_PROOF_BLAKE2S
    assert tdriver.verify_machine(view, proof, tmach.TCFG, device="cpu")


@pytest.mark.parametrize("cpu_log,streamed,passes", [
    (20, [], 1), (21, [("main", 22), ("inter", 22)], 2),
    (22, [("main", 23), ("inter", 23)], 4)])
def test_default_memory_route_by_size(cpu_log, streamed, passes):
    """The default thresholds at the fib guest's CPU component sizes
    (its main and interaction columns alone fill their trees at 2^(n+1)):
    2^20 stays resident in one pass; 2^21 and 2^22 stream both trees and
    compose in passes."""
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    info = component_info(tdriver.build_components(view, 1)[0][0])
    m, s = T.MemoryConfig(), cpu_log + 1
    assert [(role, s) for role, cols in (("main", info.n_main),
                                         ("inter", 4 * info.n_logup_cols))
            if m.streams(cols * (4 << s))] == streamed
    assert m.comp_passes(stark._natural_rows(info), cpu_log + 2) == passes


def test_memory_config_chunks():
    m = T.MemoryConfig()
    assert [m.chunk_cols(s) for s in (20, 21, 22, 23, 24)] == \
        [64, 32, 16, 16, 16]
    assert m.comp_passes(438, 22) == 1 and m.comp_passes(438, 24) == 4
    assert not m.streams(244 * (4 << 21)) and m.streams(193 * (4 << 22))
