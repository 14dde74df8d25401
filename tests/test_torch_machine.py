"""The port's machine slice against the JAX package's.

Same programs through both packages (JAX on the CPU), every comparison
exact (uint32 equality):

* `build_machine_traces`: every component's columns equal the
  reference's host fill;
* the CPU trace fill (K5's plain version) equals the reference's device
  fill `fill_cpu_dev` and its host `fill_cpu` + `count_multiplicity`,
  and the kernel's generated tables equal cpu.py's;
* the LogUp columns (K6's plain version) equal the reference's
  `generate_interaction` for machine components;
* a port machine proof verifies, rejects other claims and round-trips
  through `proof_to_bytes`, and its bytes equal the reference's
  `prove_machine` proof: a recorded digest here, the live proof in the
  `slow` test (the reference takes minutes on XLA:CPU).
"""

import copy
import hashlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from nexus_zkvm_tpu.air.component import generate_interaction as rgen
from nexus_zkvm_tpu.air.lookups import draw_relations as rdraw
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.machine.cpu import fill_cpu as rfill_cpu
from nexus_zkvm_tpu.machine.fill_dev import fill_cpu_dev as rfill_dev
from nexus_zkvm_tpu.machine.tables import count_multiplicity as rcount
from nexus_zkvm_tpu.ops.fri import FriConfig as RFriConfig
from nexus_zkvm_tpu.prover import PcsConfig as RPcsConfig
from nexus_zkvm_tpu.sdk.serialize import proof_to_bytes as rproof_to_bytes
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.air.tape import generate_interaction
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.machine import cpu as tcpu, driver as tdriver
from nexus_zkvm_tpu_torch.machine import fill_dev
from nexus_zkvm_tpu_torch.machine.tables import _Table
from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
from nexus_zkvm_tpu_torch.sdk.serialize import (proof_to_bytes,
                                                proof_from_bytes)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace
import torch_cpu  # noqa: F401  (one torch thread a test process)

EXIT = chip_smoke.EXIT_ASM
FIB10_SRC = """
        addi t0, zero, 10
        addi a0, zero, 0
        addi a1, zero, 1
    loop:
        add  a2, a0, a1
        mv   a0, a1
        mv   a1, a2
        addi t0, t0, -1
        bne  t0, zero, loop
        lw   t1, 0x84(zero)
        sw   a0, 0(t1)
""" + EXIT
KECCAK_SRC = chip_smoke.KECCAK_SRC
PROGRAMS = {"fib10": FIB10_SRC, "mixed": chip_smoke.MIXED_SRC,
            "keccak": KECCAK_SRC}

RCFG = RPcsConfig(pow_bits=2, fri=RFriConfig(log_blowup=1, log_last_layer=0,
                                             n_queries=8))
TCFG = T.PcsConfig(pow_bits=2, fri=T.FriConfig(log_blowup=1,
                                               log_last_layer=0, n_queries=8))
# blake2s of the reference `prove_machine(view, trace, RCFG)` proof of
# FIB10_SRC through `sdk.serialize.proof_to_bytes` (715,520 bytes),
# recorded from the JAX package on XLA:CPU; the slow test recomputes it
FIB10_PROOF_BLAKE2S = \
    "2a6e5a1cfdc6a7df403c689784004ee7f063fb8dbd37736a1a3c1a3624bc8786"
# `tests/test_machine.py`'s segmented loop (test_segmented_constraints):
# blake2s of the reference `prove_machine(view, trace, RCFG,
# segment_log=4)` proof (856,168 bytes), recorded the same way
SEGMENTED_SRC = """
        addi t0, zero, 40
    loop:
        addi t0, t0, -1
        bne  t0, zero, loop
        lw   t1, 0x84(zero)
        sw   t0, 0(t1)
""" + EXIT
SEGMENTED_PROOF_BLAKE2S = \
    "fab8c4cc264ec28196de01b162e68a7f37d2888e38bd5e40bd983d5158d3cc92"
# blake2s of the reference `prove_machine(view, trace, RCFG)` proofs of
# KECCAK_SRC (718,088 bytes) and of examples/guests/div_precompile.s on
# the input (1000, 7) (630,000 bytes), recorded the same way
KECCAK_PROOF_BLAKE2S = \
    "3dc08e415375490790e71ce55ae1564aff1d8edb519f92fd8c185efe8de5c425"
DIV_PRECOMPILE_PROOF_BLAKE2S = \
    "ed00681129f79ba42f874d3f3d453e944b6c9173e10718df5ae680552ded62b5"


def _both(src):
    return (rk_trace(rasm.assemble(src), backend="python"),
            tk_trace(tasm.assemble(src), backend="python"))


@pytest.fixture(scope="module")
def fib10():
    return _both(FIB10_SRC)


@pytest.fixture(scope="module")
def mixed():
    return _both(chip_smoke.MIXED_SRC)


@pytest.fixture(scope="module")
def keccak():
    return _both(KECCAK_SRC)


def _cols(tr) -> np.ndarray:
    if isinstance(tr, torch.Tensor):
        return to_u32(tr)
    return np.stack([np.asarray(c, np.uint32) for c in tr])


# ---------------------------------------------------------------------------
# trace fill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prog", ["fib10", "mixed", "keccak"])
def test_build_machine_traces_equal(prog, request):
    (rv, rt), (tv, tt) = request.getfixturevalue(prog)
    rc, rlogs, rtr = rdriver.build_machine_traces(rv, rt, min_cpu_log=7)
    tc, tlogs, ttr = tdriver.build_machine_traces(tv, tt, min_cpu_log=7,
                                                  device="cpu")
    assert [c.name for c in tc] == [c.name for c in rc]
    assert tlogs == rlogs
    assert isinstance(ttr[0], torch.Tensor)     # the CPU fill's matrix
    for c, (r, t) in enumerate(zip(rtr, ttr)):
        assert np.array_equal(_cols(t), _cols(r)), tc[c].name


def _fill_inputs(view, trace):
    _c, fixed, (lo, hi) = tdriver.build_components(view, 1)
    return fixed, lo, hi, tdriver._clog2(len(trace.steps["clk"]), lo=4)


@pytest.mark.parametrize("prog", ["fib10", "mixed"])
def test_cpu_fill_plain_equals_host_fill(prog, request):
    """K5's plain version against the numpy host fill and the table
    counts of its emits, of both packages."""
    (rv, rt), (tv, tt) = request.getfixturevalue(prog)
    fixed, lo, hi, log = _fill_inputs(tv, tt)
    mat, hist = fill_dev.fill_cpu_dev(tt, tv, log, lo, hi, device="cpu")
    mat, hist = to_u32(mat), to_u32(hist)
    tf, temits = tcpu.fill_cpu(tt, tv, log, lo, hi)
    rf, remits = rfill_cpu(rt, rv, log, lo, hi)
    assert np.array_equal(mat, np.stack(tcpu.CPU_SCHEMA.to_columns(tf)))
    assert np.array_equal(mat, np.stack(tcpu.CPU_SCHEMA.to_columns(rf)))
    comps = tdriver.build_components(tv, 1)[0]
    tables = {c.relation: c for c in comps if isinstance(c, _Table)}
    lo_bin = 0
    for rel, size in fill_dev.RELATION_SIZES.items():
        t = tables[rel]
        want = rcount(t, remits.get(rel, np.zeros(0, np.int64)),
                      fixed[t.name])
        got = np.zeros_like(want)
        got[:size] += hist[lo_bin:lo_bin + size]
        assert np.array_equal(got, want), rel
        lo_bin += size


def test_cpu_fill_plain_equals_reference_dev_fill(mixed):
    """...and against the reference's device fill on XLA:CPU."""
    (rv, rt), (tv, tt) = mixed
    _f, lo, hi, log = _fill_inputs(tv, tt)
    mat, hist = fill_dev.fill_cpu_dev(tt, tv, log, lo, hi, device="cpu")
    rmat, rcounts = rfill_dev(rt, rv, log, lo, hi)
    assert np.array_equal(to_u32(mat), np.asarray(rmat, np.uint32))
    want = np.concatenate([np.asarray(rcounts[rel], np.uint32)
                           for rel in fill_dev.RELATION_SIZES])
    assert np.array_equal(to_u32(hist), want)


def test_cpu_fill_wrapper_takes_plain_path_on_cpu(mixed):
    _r, (tv, tt) = mixed
    _f, lo, hi, log = _fill_inputs(tv, tt)
    rows, params = fill_dev.step_rows(tt, tv, log, lo, hi)
    rows = from_u32(rows, "cpu")
    a = fill_dev.cpu_fill(rows, params)
    b = fill_dev.cpu_fill_plain(rows, params)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _header_array(text, name):
    m = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", text)
    return [int(v.rstrip("ul"), 0) for v in m.group(1).split(",")]


def test_committed_fill_header_is_current():
    """csrc/fill_tables.cuh is what cuda_header() generates now."""
    assert fill_dev.CUDA_HEADER.read_text() == fill_dev.cuda_header()


@pytest.mark.parametrize("name", sorted(fill_dev._OPSETS))
def test_generated_opcode_sets_match_cpu_tables(name):
    words = _header_array(fill_dev.CUDA_HEADER.read_text(), f"kSet_{name}")
    got = {op for op in range(256) if (words[op >> 6] >> (op & 63)) & 1}
    assert got == {int(o) for o in fill_dev._OPSETS[name]}


def test_generated_slots_and_flags_match_schema():
    text = fill_dev.CUDA_HEADER.read_text()
    for col, w in tcpu.CPU_SCHEMA.spec:
        assert f"constexpr int C_{col} = {tcpu.CPU_SCHEMA.slot(col)};" in text
    flags = _header_array(text, "kFlag")
    assert {op: i for op, i in enumerate(flags) if i >= 0} == \
        {int(op): i for op, i in tcpu._FLAG_IDX.items()}
    assert _header_array(text, "kSysCol") == \
        [tcpu.CPU_SCHEMA.slot(n) for n, _ in tcpu.SYS_FLAGS]


# ---------------------------------------------------------------------------
# LogUp columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prog,name", [("fib10", "ram_touched"),
                                       ("fib10", "regfile"),
                                       ("keccak", "keccak")])
def test_logup_columns_equal_reference(prog, name, request):
    (rv, rt), (tv, tt) = request.getfixturevalue(prog)
    rc, rlogs, rtr = rdriver.build_machine_traces(rv, rt)
    tc, tlogs, ttr = tdriver.build_machine_traces(tv, tt, device="cpu")
    i = [c.name for c in tc].index(name)
    widths = _relation_widths([component_info(c) for c in tc])
    rrel = rdraw(RChannel(), widths)
    trel = draw_relations(T.Blake2sChannel(), widths)
    pre = [a for _n, a in tc[i].preprocessed(tlogs[i])]
    want, rclaimed = rgen(rc[i], rtr[i], pre or None, rrel, rlogs[i])
    main = from_u32(_cols(ttr[i]), "cpu")
    pre_t = from_u32(np.stack(pre), "cpu") if pre else None
    got, claimed = generate_interaction(tc[i], main, pre_t, trel, tlogs[i],
                                        "cpu")
    assert np.array_equal(to_u32(got), np.asarray(want, np.uint32))
    assert np.array_equal(to_u32(claimed), np.asarray(rclaimed, np.uint32))


# ---------------------------------------------------------------------------
# machine proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fib10_proof(fib10):
    _r, (tv, tt) = fib10
    return tv, tdriver.prove_machine(tv, tt, TCFG, device="cpu")


def test_machine_proof_verifies(fib10_proof):
    view, proof = fib10_proof
    assert tdriver.verify_machine(view, proof, TCFG, device="cpu")


def test_machine_proof_rejects_other_claims(fib10_proof):
    view, proof = fib10_proof
    other, _t = tk_trace(tasm.assemble(chip_smoke.OTHER_SRC))
    assert not tdriver.verify_machine(other, proof, TCFG, device="cpu")
    bad_view = copy.deepcopy(view)
    bad_view.exit_code = 1
    assert not tdriver.verify_machine(bad_view, proof, TCFG, device="cpu")
    bad = copy.deepcopy(proof)
    dec = bad.stark.openings["main"][0][1]
    dec.column_values[0] = np.array(dec.column_values[0])
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % \
        ((1 << 31) - 1)
    assert not tdriver.verify_machine(view, bad, TCFG, device="cpu")


def test_machine_proof_bytes_round_trip(fib10_proof):
    view, proof = fib10_proof
    blob = proof_to_bytes(proof)
    back = proof_from_bytes(blob)
    assert proof_to_bytes(back) == blob
    assert tdriver.verify_machine(view, back, TCFG, device="cpu")


def test_machine_proof_equals_reference_digest(fib10_proof):
    _view, proof = fib10_proof
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        FIB10_PROOF_BLAKE2S


@pytest.mark.slow
def test_machine_proof_equals_reference_live(fib10, fib10_proof):
    (rv, rt), _t = fib10
    want = rproof_to_bytes(rdriver.prove_machine(rv, rt, RCFG))
    assert hashlib.blake2s(want).hexdigest() == FIB10_PROOF_BLAKE2S
    assert proof_to_bytes(fib10_proof[1]) == want


@pytest.fixture(scope="module")
def segmented():
    return _both(SEGMENTED_SRC)


@pytest.fixture(scope="module")
def segmented_proof(segmented):
    _r, (tv, tt) = segmented
    return tv, tdriver.prove_machine(tv, tt, TCFG, segment_log=4,
                                     device="cpu")


def test_segmented_machine_proof_equals_reference_digest(segmented_proof):
    """Segments of 2^4 rows: several CPU components, each opened."""
    view, proof = segmented_proof
    n_fixed = len(tdriver.build_components(view, 1)[0]) - 1
    assert len(proof.stark.log_sizes) - n_fixed > 2
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        SEGMENTED_PROOF_BLAKE2S
    assert tdriver.verify_machine(view, proof, TCFG, device="cpu")


@pytest.mark.slow
def test_segmented_machine_proof_equals_reference_live(segmented,
                                                       segmented_proof):
    (rv, rt), _t = segmented
    want = rproof_to_bytes(rdriver.prove_machine(rv, rt, RCFG,
                                                 segment_log=4))
    assert hashlib.blake2s(want).hexdigest() == SEGMENTED_PROOF_BLAKE2S
    assert proof_to_bytes(segmented_proof[1]) == want


@pytest.mark.slow
@pytest.mark.parametrize("guest", ["keccak", "div_precompile"])
def test_guest_machine_proof_equals_reference_digest(guest):
    from nexus_zkvm_tpu_torch.sdk import Guest, encode_u32s
    if guest == "keccak":
        view, trace = tk_trace(tasm.assemble(KECCAK_SRC), backend="python")
        want = KECCAK_PROOF_BLAKE2S
    else:
        g = Guest.from_asm(open(chip_smoke.ROOT / "examples" / "guests"
                                / "div_precompile.s").read())
        view, trace = tk_trace(g.program_words, entry=g.entry,
                               public_input=encode_u32s(1000, 7),
                               backend="python")
        want = DIV_PRECOMPILE_PROOF_BLAKE2S
    proof = tdriver.prove_machine(view, trace, TCFG, device="cpu")
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == want


def test_prove_takes_a_device_matrix():
    """A component's main trace given as one int32 tensor gives the
    same proof as the same trace as numpy columns."""
    comps = chip_smoke.make_components()
    logs = [6, chip_smoke.TABLE_LOG]
    as_cols = chip_smoke.make_traces(6)
    as_mat = [from_u32(np.stack(tr), "cpu") for tr in
              chip_smoke.make_traces(6)]
    p1 = T.prove(comps, logs, as_cols, T.Blake2sChannel(), TCFG, "cpu")
    p2 = T.prove(comps, logs, as_mat, T.Blake2sChannel(), TCFG, "cpu")
    assert chip_smoke.tree_eq(p1, p2)


def test_local_prover_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from nexus_zkvm_tpu_torch.sdk import LocalProver
    from nexus_zkvm_tpu_torch.sdk.io import encode_u32s
    prover = LocalProver(chip_smoke.fib_guest())
    assert prover.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prover.prove_with_input(public_input=encode_u32s(3))
