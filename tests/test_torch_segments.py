"""Segmented machine proofs of the port against the JAX package's.

`prove_machine(view, trace, segment_log=k)` splits an execution into
2^k-step segments, each its own CPU component (`cpu`, `cpu1`, ...),
chained through the shared relations.  The same programs go through
both packages (JAX on the CPU), every comparison exact:

* `build_machine_traces(segment_log=k)`: every component's columns,
  ragged last segments included;
* K5's plain version on each segment that does not start at step 0
  against the numpy host fill and its table counts;
* a segmented proof's bytes against a digest recorded from the JAX
  package (the live comparison is a `slow` test), and `verify_machine`
  rejecting it with a CPU component dropped or its log sizes
  reordered, as the JAX package's does;
* the segments share K7's generated sources (one build for all);
* the route an 80 GB card's thresholds give 1 to 8 segments of 2^22 and
  2^23 rows, the routes `chip_smoke.py --time-memory` measured;
* a streamed group's natural rows, which it no longer keeps, are
  evaluated from its coefficients equal to the rows committed.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.machine.cpu import fill_cpu as rfill_cpu
from nexus_zkvm_tpu.sdk.serialize import proof_to_bytes as rproof_to_bytes
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import tape as tp, tape_cuda
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.machine import cpu as tcpu, driver as tdriver
from nexus_zkvm_tpu_torch.machine import fill_dev
from nexus_zkvm_tpu_torch.prover import pcs, stark
from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
from nexus_zkvm_tpu_torch.sdk import proof_to_bytes
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

import test_torch_machine as tmach
from test_torch_memory_route import H100_80GB
import torch_cpu  # noqa: F401  (one torch thread a test process)

# blake2s of the JAX package's `prove_machine(view, trace, RCFG,
# segment_log=5)` proof of FIB10_SRC (58 steps: two CPU components of
# 2^5 rows, the second of 26 steps; 634,264 bytes) through `sdk.serialize.
# proof_to_bytes`, recorded on XLA:CPU; the slow test recomputes it
FIB10_SEG5_PROOF_BLAKE2S = \
    "2518e7af7696c356a2d63c067507bdae737c2d3e50cc67cd9c977f5f5555e4e9"
FIB10_SEG_LOG = 5
# the JAX package's `verify_machine` of that proof with its last CPU
# component's log size dropped, and with the first CPU component's log
# size swapped with ram_touched's (recorded with the digest)
JAX_VERDICTS = {"dropped": False, "reordered": False}


@pytest.fixture(scope="module")
def fib10():
    return tmach._both(tmach.FIB10_SRC)


@pytest.fixture(scope="module")
def mixed():
    return tmach._both(chip_smoke.MIXED_SRC)


# ---------------------------------------------------------------------------
# the segmented fill
# ---------------------------------------------------------------------------

# fib10: 58 steps; mixed: 449 (2^6-step segments: the last of one step)
SEGMENTINGS = [("fib10", 4), ("fib10", 5), ("mixed", 6), ("mixed", 7)]


@pytest.mark.parametrize("prog,seg_log", SEGMENTINGS)
def test_segmented_traces_equal_reference(prog, seg_log, request):
    """Every component of a segmented fill, CPU segments and the rest,
    equal to the JAX package's, a ragged last segment included."""
    (rv, rt), (tv, tt) = request.getfixturevalue(prog)
    rc, rlogs, rtr = rdriver.build_machine_traces(rv, rt, segment_log=seg_log)
    tc, tlogs, ttr = tdriver.build_machine_traces(tv, tt, segment_log=seg_log,
                                                  device="cpu")
    names = [c.name for c in tc]
    assert names == [c.name for c in rc] and tlogs == rlogs
    segs = -(-tt.n_steps // (1 << seg_log))
    assert names[:segs] == ["cpu"] + [f"cpu{i}" for i in range(1, segs)]
    assert tt.n_steps % (1 << seg_log)          # a ragged last segment
    for c, (r, t) in enumerate(zip(rtr, ttr)):
        assert np.array_equal(tmach._cols(t), tmach._cols(r)), names[c]


@pytest.mark.parametrize("prog,seg_log", SEGMENTINGS)
def test_segment_fill_plain_equals_host_fill(prog, seg_log, request):
    """K5's plain version on every segment after the first (its clk
    starts past 1) against both packages' numpy host fills and the
    table counts of their emits (`chip_smoke.fill_numpy`, which the card
    run holds K5 to)."""
    (rv, rt), (tv, tt) = request.getfixturevalue(prog)
    _c, _f, (lo, hi) = tdriver.build_components(tv, 1)
    rsegs = rt.split_by(1 << seg_log)
    for i, seg in enumerate(tt.split_by(1 << seg_log)[1:], start=1):
        assert int(seg.steps["clk"][0]) == 1 + (i << seg_log)
        log = tdriver._clog2(seg.n_steps, lo=4)
        mat, hist = fill_dev.fill_cpu_dev(seg, tv, log, lo, hi, device="cpu")
        want_mat, want_hist = chip_smoke.fill_numpy(seg, tv, log, lo, hi)
        assert np.array_equal(to_u32(mat), want_mat)
        assert np.array_equal(to_u32(hist), want_hist)
        rf, _e = rfill_cpu(rsegs[i], rv, log, lo, hi)
        assert np.array_equal(want_mat,
                              np.stack(tcpu.CPU_SCHEMA.to_columns(rf)))


def test_segments_share_k7_sources(fib10):
    """The CPU component's segments differ only by the `is_entry` param,
    a uniform: their tapes carry the family's name, so every segment's
    K7 pieces are the same sources (one nvcc build each, whatever the
    number of segments)."""
    _r, (tv, _tt) = fib10
    comps = tdriver.build_components(tv, 4)[0]
    rel = draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))
    assert [tp._family(c) for c in comps[:4]] == ["cpu"] * 4
    for fn in (tp.domain_tape, tp.gen_tape):
        tapes = [fn(c, 10, rel) for c in comps[:4]]
        assert {t.name for t in tapes} == {"cpu"}
        libs = {tuple(p.lib for p in tape_cuda.pieces(t)) for t in tapes}
        texts = {tuple(p.text for p in tape_cuda.pieces(t)) for t in tapes}
        assert len(libs) == len(texts) == 1
        # what differs is the uniform table: is_entry 1, then 0
        u0, u1 = (t.uniforms(rel, np.zeros(4, np.uint64)) for t in tapes[:2])
        assert (u0 != u1).any()
        assert {t.params["is_entry"] for t in tapes} == {0, 1}
    # the other components keep their own names
    assert [tp._family(c) for c in comps[4:]] == [c.name for c in comps[4:]]


# ---------------------------------------------------------------------------
# the segmented proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fib10_segmented(fib10):
    _r, (tv, tt) = fib10
    return tv, tdriver.prove_machine(tv, tt, tmach.TCFG,
                                     segment_log=FIB10_SEG_LOG, device="cpu")


def test_segmented_proof_equals_reference_digest(fib10_segmented):
    view, proof = fib10_segmented
    n_fixed = len(tdriver.build_components(view, 1)[0]) - 1
    assert proof.stark.log_sizes[:2] == [FIB10_SEG_LOG] * 2
    assert len(proof.stark.log_sizes) - n_fixed == 2
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        FIB10_SEG5_PROOF_BLAKE2S
    assert tdriver.verify_machine(view, proof, tmach.TCFG, device="cpu")


def _tampered(proof, view, how: str):
    """``proof`` with its last CPU component's log size dropped, or the
    first CPU component's swapped with ram_touched's."""
    bad = copy.deepcopy(proof)
    logs = list(proof.stark.log_sizes)
    n_fixed = len(tdriver.build_components(view, 1)[0]) - 1
    segs = len(logs) - n_fixed
    if how == "dropped":
        bad.stark.log_sizes = logs[:segs - 1] + logs[segs:]
    else:
        names = [c.name for c in tdriver.build_components(view, segs)[0]]
        i = names.index("ram_touched")
        assert logs[0] != logs[i]
        logs[0], logs[i] = logs[i], logs[0]
        bad.stark.log_sizes = logs
    return bad


@pytest.mark.parametrize("how", sorted(JAX_VERDICTS))
def test_segmented_proof_rejected_as_the_reference_does(fib10_segmented,
                                                        how):
    view, proof = fib10_segmented
    got = tdriver.verify_machine(view, _tampered(proof, view, how),
                                 tmach.TCFG, device="cpu")
    assert got is JAX_VERDICTS[how] is False


@pytest.mark.slow
def test_segmented_proof_equals_reference_live(fib10, fib10_segmented):
    (rv, rt), _t = fib10
    ref = rdriver.prove_machine(rv, rt, tmach.RCFG, segment_log=FIB10_SEG_LOG)
    want = rproof_to_bytes(ref)
    assert hashlib.blake2s(want).hexdigest() == FIB10_SEG5_PROOF_BLAKE2S
    assert proof_to_bytes(fib10_segmented[1]) == want
    for how, verdict in JAX_VERDICTS.items():
        assert bool(rdriver.verify_machine(
            rv, _tampered(ref, rv, how), tmach.RCFG)) is verdict


def test_chip_smoke_pins_the_segmented_program():
    """chip_smoke.py proves test_torch_machine's segmented program on the
    card against the same recorded digest (it imports nothing of the
    tests)."""
    assert chip_smoke.SEGMENTED_SRC == tmach.SEGMENTED_SRC
    assert chip_smoke.SEGMENTED_PROOF_BLAKE2S == tmach.SEGMENTED_PROOF_BLAKE2S
    assert chip_smoke.segmented_config() == tmach.TCFG
    assert chip_smoke.route_segments("default_s22") == ("default", 22)
    assert chip_smoke.route_segments("stream_forced") == ("stream_forced",
                                                          None)
    assert chip_smoke.route_segments("streamed_p4") == ("streamed_p4", None)


# ---------------------------------------------------------------------------
# the card's route for segments
# ---------------------------------------------------------------------------

def segments_route(memory, info, k: int, cpu_log: int) -> tuple:
    """(streamed roles, composition passes a CPU component) of k fib CPU
    components of 2^cpu_log rows: the main and interaction trees hold
    all k components' columns, each component composes alone."""
    s = cpu_log + 1
    streamed = tuple(role for role, cols in (
        ("main", info.n_main), ("inter", 4 * info.n_logup_cols))
        if memory.streams(k * cols * (4 << s)))
    return streamed, memory.comp_passes(stark._natural_rows(info),
                                        cpu_log + 2)


BOTH = ("main", "inter")
# the route an 80 GB card's thresholds give k segments of 2^22 and 2^23
# rows, as `chip_smoke.py --time-memory` measured it on an NVIDIA H100
# 80GB HBM3 (the prover's `streamed` and `composition_passes` notes):
# 2^22 x 1 and 2^23 x 1 (2^22 and 2^23 steps as one component), 2^22 x 4
# (2^24 steps, `default_s22`) and 2^23 x 2 (`default_s23`); 2^22 x 8
# (2^25 steps) ran out of memory before the route was noted, and it and
# the others follow from the same rule
CARD_SEGMENT_ROUTES = {
    (22, 1): ((), 2), (22, 2): (BOTH, 2), (22, 4): (BOTH, 2),
    (22, 8): (BOTH, 2), (23, 1): (BOTH, 4), (23, 2): (BOTH, 4),
    (23, 4): (BOTH, 4), (23, 8): (BOTH, 4)}


@pytest.mark.parametrize("cpu_log,k", sorted(CARD_SEGMENT_ROUTES))
def test_card_route_by_segments(cpu_log, k, fib10):
    _r, (tv, _t) = fib10
    info = component_info(tdriver.build_components(tv, 1)[0][0])
    m = T.MemoryConfig.for_bytes(H100_80GB)
    assert segments_route(m, info, k, cpu_log) == \
        CARD_SEGMENT_ROUTES[(cpu_log, k)]


# ---------------------------------------------------------------------------
# where a streamed group keeps its data
# ---------------------------------------------------------------------------

def test_streamed_group_natural_rows_from_coefficients():
    """A streamed natural-order group stacked from several blocks keeps
    its coefficients only: the natural rows of a component's columns (a
    slice of the group, read in place) are evaluated from them equal to
    the rows committed (37 rows: two of the 32-row chunks they are
    evaluated in), the callers' blocks untouched.  A group of one
    caller's block keeps it as its natural values and is not
    interpolated over."""
    rng = np.random.default_rng(16)
    n = 6
    blocks = [from_u32(rng.integers(0, (1 << 31) - 1, (k, 1 << n),
                                    dtype=np.uint32), "cpu")
              for k in (3, 37, 2)]
    want = [b.clone() for b in blocks]
    mem = T.MemoryConfig(stream_commit_bytes=64, stream_chunk_bytes=1,
                         comp_nat_budget=1 << 30)
    kept = list(blocks)
    rc = pcs.commit_blocks("main", kept, [n] * 3, 1, "cpu", memory=mem)
    assert rc.streamed(n + 1) and rc.natural[n][1] is None
    lo = 0
    for b, w in zip(blocks, want):
        cols = list(range(lo, lo + int(w.shape[0])))
        got, got_n = rc.natural_rows(cols)
        assert got_n == n and torch.equal(got, w)
        # a component's rows of the group are a view of it
        assert rc.coeff_rows(cols)[0].data_ptr() == \
            rc.coeff_batches[n][1][lo].data_ptr()
        assert torch.equal(b, w)            # the caller's block untouched
        lo += int(w.shape[0])
    # one block alone: the group is the caller's matrix itself
    one = [blocks[1]]
    rc1 = pcs.commit_blocks("main", one, [n], 1, "cpu", memory=mem)
    assert rc1.streamed(n + 1) and rc1.natural[n][1] is blocks[1]
    assert torch.equal(blocks[1], want[1])
    assert torch.equal(rc1.natural_rows(list(range(37)))[0], want[1])
