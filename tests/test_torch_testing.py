"""The port's constraint harness (`air/testing.py`) against the JAX one.

Machine v1's constraint and tamper cases of `tests/test_machine.py`
(the segmented loop and the tampered result, next pc and flag) run
through `nexus_zkvm_tpu_torch.air.testing.assert_constraints` on the
CPU: the verdicts and the ConstraintViolation messages (each violated
constraint's index, its first rows) equal the JAX harness's.  The JAX
harness compiles its evaluation graphs on XLA:CPU for minutes, so its
messages are recorded here and the `slow` test recomputes them live.
`relation_balance_report` is host numpy in both packages and runs live
against the JAX one.
"""

import numpy as np
import pytest

from nexus_zkvm_tpu.air import testing as rtesting
from nexus_zkvm_tpu.machine.cpu import CPU_SCHEMA as RCPU_SCHEMA
from nexus_zkvm_tpu.machine.driver import build_machine_traces as rbuild
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
from nexus_zkvm_tpu_torch.air import testing
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.air.testing import (ConstraintViolation,
                                              assert_constraints,
                                              relation_balance_report)
from nexus_zkvm_tpu_torch.machine.cpu import CPU_SCHEMA
from nexus_zkvm_tpu_torch.machine.driver import build_machine_traces
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm, k_trace
import torch_cpu  # noqa: F401  (one torch thread a test process)

EXIT = """
    addi a0, zero, 0
    addi a7, zero, 0x201
    ecall
"""
SEGMENTED_SRC = """
    addi t0, zero, 40
loop:
    addi t0, t0, -1
    bne  t0, zero, loop
    lw   t1, 0x84(zero)
    sw   t0, 0(t1)
""" + EXIT
TAMPER_SRC = """
    li t0, 41
    addi t1, t0, 1
    lw   t2, 0x84(zero)
    sw   t1, 0(t2)
""" + EXIT
# the JAX harness's messages for `tests/test_machine.py`'s `_tamper`
# cases (column, index into it; row 0 of the CPU component + 1),
# recorded from the JAX package on XLA:CPU
TAMPER_MESSAGES = {
    "a": "component cpu: constraints [94] violated (first rows: [0])",
    "npc": "component cpu: constraints [85] violated (first rows: [0])",
    "f": "component cpu: constraints [79, 92] violated (first rows: [0])",
}
P = (1 << 31) - 1


def _traces(src, **kw):
    view, trace = k_trace(asm.assemble(src))
    return build_machine_traces(view, trace, device="cpu", **kw)


def _ref_traces(src, **kw):
    view, trace = rk_trace(rasm.assemble(src))
    return rbuild(view, trace, **kw)


def _bump(traces, c, col, row=0):
    """The port's traces with component c's column ``col`` at ``row``
    plus 1 (the CPU component's trace is one int32 matrix)."""
    m = to_u32(traces[c]).copy()
    m[col, row] = (int(m[col, row]) + 1) % P
    traces[c] = from_u32(m, "cpu")
    return traces


def _message(comps, log_sizes, traces):
    try:
        assert_constraints(comps, log_sizes, traces, device="cpu")
    except ConstraintViolation as e:
        return str(e)
    return None


def test_dummy_relations_equal_reference():
    """The seeded stand-in randomness (seed 12345) is the JAX harness's."""
    comps, _l, _t = _traces(TAMPER_SRC)
    infos = [component_info(c) for c in comps]
    got = testing._dummy_relations(infos)
    want = rtesting._dummy_relations(infos)
    assert list(got) == list(want)
    for name in got:
        assert got[name].width == want[name].width
        assert np.array_equal(got[name].z, want[name].z)
        assert np.array_equal(got[name].alpha_pows, want[name].alpha_pows)


def test_segmented_constraints():
    """Multi-segment execution: chains connect across CPU components."""
    comps, log_sizes, traces = _traces(SEGMENTED_SRC, segment_log=4)
    assert sum(1 for c in comps if c.name.startswith("cpu")) > 2
    assert _message(comps, log_sizes, traces) is None
    assert relation_balance_report(comps, log_sizes, traces) == {}


def test_untampered_program_satisfies():
    comps, log_sizes, traces = _traces(TAMPER_SRC)
    assert _message(comps, log_sizes, traces) is None


@pytest.mark.parametrize("name", sorted(TAMPER_MESSAGES))
def test_tampered_caught(name):
    comps, log_sizes, traces = _traces(TAMPER_SRC)
    traces = _bump(list(traces), 0, CPU_SCHEMA.slot(name, 0))
    assert _message(comps, log_sizes, traces) == TAMPER_MESSAGES[name]


@pytest.mark.parametrize("name", sorted(TAMPER_MESSAGES))
def test_relation_balance_report_equals_reference(name):
    """The tampered trace's unbalanced tuples, port against JAX."""
    comps, log_sizes, traces = _traces(TAMPER_SRC)
    traces = _bump(list(traces), 0, CPU_SCHEMA.slot(name, 0))
    rcomps, rlogs, rtr = _ref_traces(TAMPER_SRC)
    col = RCPU_SCHEMA.slot(name, 0)
    rtr[0][col] = rtr[0][col].copy()
    rtr[0][col][0] = (int(rtr[0][col][0]) + 1) % P
    got = relation_balance_report(comps, log_sizes, traces)
    assert got == rtesting.relation_balance_report(rcomps, rlogs, rtr)


def test_claimed_sums_must_cancel():
    """A table multiplicity off by one keeps every component's own
    constraints but breaks the LogUp balance."""
    comps, log_sizes, traces = _traces(TAMPER_SRC)
    p = [c.name for c in comps].index("program")
    traces = list(traces)
    traces[p] = [traces[p][0].copy()]
    traces[p][0][0] += 1
    msg = _message(comps, log_sizes, traces)
    assert msg is not None and msg.startswith(
        "LogUp claimed sums do not cancel")
    report = relation_balance_report(comps, log_sizes, traces)
    assert set(report) == {"prog"}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(TAMPER_MESSAGES))
def test_tamper_messages_equal_reference_live(name):
    rcomps, rlogs, rtr = _ref_traces(TAMPER_SRC)
    col = RCPU_SCHEMA.slot(name, 0)
    rtr[0][col] = rtr[0][col].copy()
    rtr[0][col][0] = (int(rtr[0][col][0]) + 1) % P
    with pytest.raises(rtesting.ConstraintViolation) as e:
        rtesting.assert_constraints(rcomps, rlogs, rtr)
    assert str(e.value) == TAMPER_MESSAGES[name]
