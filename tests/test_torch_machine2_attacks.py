"""machine2's tamper and forgery cases through the port's harness.

The cases of `tests/test_machine2.py` (tampered ALU result, branch
taken bit, clk and flag; a dropped exec emit; the forged branch taken
bit, JALR wrap bit and immediate sign; a step moved into the wrong
family; a forged pc) on the port's traces, on the CPU: each is caught,
and the ConstraintViolation message (the violated constraints' indices
and first rows, or the LogUp imbalance) equals the JAX harness's.  The
JAX harness compiles for minutes on XLA:CPU, so its messages are
recorded here and the `slow` test recomputes them live on the same
edited reference traces; `relation_balance_report` runs live against
the JAX one.
"""

import numpy as np
import pytest

from nexus_zkvm_tpu.air import testing as rtesting
from nexus_zkvm_tpu.machine2 import build_machine2_traces as rbuild
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
from nexus_zkvm_tpu_torch.air.testing import (ConstraintViolation,
                                              assert_constraints,
                                              relation_balance_report)
from nexus_zkvm_tpu_torch.machine2 import (EXEC_FAMILIES,
                                           build_machine2_traces)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm, k_trace
from test_torch_machine2 import EXIT, PROGRAMS
import torch_cpu  # noqa: F401  (one torch thread a test process)

P = (1 << 31) - 1
# the JAX harness's messages on each case, recorded from the JAX package
# on XLA:CPU
MESSAGES = {
    "tamper/ex_alu/a":
        "component ex_alu: constraints [13] violated (first rows: [0])",
    "tamper/ex_branch/t":
        "component ex_branch: constraints [10, 24] violated "
        "(first rows: [0])",
    "tamper/ex_alu/clk":
        "component ex_alu: constraints [23, 28] violated (first rows: [0])",
    "tamper/ex_alu/f":
        "component ex_alu: constraints [6, 24] violated (first rows: [0])",
    "unbalanced_exec":
        "component ex_alu: constraints [6] violated (first rows: [0])",
    "forged_branch_taken":
        "component ex_branch: constraints [24] violated (first rows: [0])",
    "forged_jalr_wrap":
        "LogUp claimed sums do not cancel: "
        "[ 811328985  656855863 2065991152 1312538391]",
    "forged_imm_sign":
        "component ex_branch: constraints [25] violated (first rows: [0])",
    "wrong_family_routing":
        "component ex_bit: constraints [20, 21, 24, 25] violated "
        "(first rows: [0])",
    "pc_chain_forgery":
        "LogUp claimed sums do not cancel: "
        "[ 100810856 1417886947 1986317723 1182852314]",
}


def _columns(tr) -> list:
    """A trace as a list of uint32 numpy columns (a family's device
    matrix split into its rows)."""
    if isinstance(tr, list):
        return [np.array(c, np.uint32) for c in tr]
    return list(to_u32(tr).copy())


def _both(src):
    tv, tt = k_trace(asm.assemble(src))
    rv, rt = rk_trace(rasm.assemble(src))
    comps, log_sizes, traces = build_machine2_traces(tv, tt, device="cpu")
    rc, rlogs, rtr = rbuild(rv, rt)
    return comps, log_sizes, [_columns(t) for t in traces], \
        (rc, rlogs, [_columns(t) for t in rtr])


def _set(comps, traces, fam, col_name, row, val, idx=0):
    ci = [c.name for c in comps].index(fam)
    traces[ci][comps[ci].SCHEMA.slot(col_name, idx)][row] = val


def _get(comps, traces, fam, col_name, row, idx=0):
    ci = [c.name for c in comps].index(fam)
    return int(traces[ci][comps[ci].SCHEMA.slot(col_name, idx)][row])


def _real_row(comps, traces, fam, col_name="pad", value=0, idx=0):
    ci = [c.name for c in comps].index(fam)
    col = traces[ci][comps[ci].SCHEMA.slot(col_name, idx)]
    return int(np.flatnonzero(np.asarray(col) == value)[0])


def _tamper(fam, col):
    def edit(comps, traces):
        _set(comps, traces, fam, col, 0,
             (_get(comps, traces, fam, col, 0) + 1) % P)
    return "fib", edit


def _unbalanced(comps, traces):
    _set(comps, traces, "ex_alu", "pad", 0, 1)


def _branch_taken(comps, traces):
    row = _real_row(comps, traces, "ex_branch")
    _set(comps, traces, "ex_branch", "t", row,
         1 - _get(comps, traces, "ex_branch", "t", row))


def _jalr_wrap(comps, traces):
    row = _real_row(comps, traces, "ex_jump", "f", 1, idx=1)   # JALR flag
    _set(comps, traces, "ex_jump", "c32", row,
         1 - _get(comps, traces, "ex_jump", "c32", row))


def _imm_sign(comps, traces):
    row = _real_row(comps, traces, "ex_branch")
    _set(comps, traces, "ex_branch", "im_s", row,
         1 - _get(comps, traces, "ex_branch", "im_s", row))


def _wrong_family(comps, traces):
    """ex_alu's first real row appended to ex_bit as an AND."""
    names = [c.name for c in comps]
    alu_i, bit_i = names.index("ex_alu"), names.index("ex_bit")
    alu, bit = comps[alu_i].SCHEMA, comps[bit_i].SCHEMA
    tr_bit = traces[bit_i]
    n_bit = int((np.asarray(tr_bit[bit.slot("pad")]) == 0).sum())
    assert n_bit + 1 < len(tr_bit[0]), "need padding room"
    for name in ("clk", "pc", "imm", "opa", "opb", "opc", "b"):
        for i in range(alu.width(name)):
            tr_bit[bit.slot(name, i)][n_bit] = \
                traces[alu_i][alu.slot(name, i)][0]
    tr_bit[bit.slot("pad")][n_bit] = 0
    tr_bit[bit.slot("f", 0)][n_bit] = 1


def _pc_chain(comps, traces):
    _set(comps, traces, "ex_alu", "pc", 0,
         (_get(comps, traces, "ex_alu", "pc", 0) + 4) % 256)


CASES = {
    "tamper/ex_alu/a": _tamper("ex_alu", "a"),
    "tamper/ex_branch/t": _tamper("ex_branch", "t"),
    "tamper/ex_alu/clk": _tamper("ex_alu", "clk"),
    "tamper/ex_alu/f": _tamper("ex_alu", "f"),
    "unbalanced_exec": ("fib", _unbalanced),
    "forged_branch_taken": ("branch", _branch_taken),
    "forged_jalr_wrap": ("jump", _jalr_wrap),
    "forged_imm_sign": ("fib", _imm_sign),
    "wrong_family_routing": ("fib", _wrong_family),
    "pc_chain_forgery": ("fib", _pc_chain),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_attack_caught_as_reference(case):
    prog, edit = CASES[case]
    comps, log_sizes, traces, (rc, rlogs, rtr) = _both(PROGRAMS[prog] + EXIT)
    edit(comps, traces)
    edit(rc, rtr)
    # the families' matrices go back to the device form the driver gives
    traces = [from_u32(np.stack(t), "cpu") if i < len(EXEC_FAMILIES)
              else t
              for i, t in enumerate(traces)]
    with pytest.raises(ConstraintViolation) as e:
        assert_constraints(comps, log_sizes, traces, device="cpu")
    assert str(e.value) == MESSAGES[case]
    assert relation_balance_report(comps, log_sizes, traces) == \
        rtesting.relation_balance_report(rc, rlogs, rtr)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(CASES))
def test_attack_message_equals_reference_live(case):
    """The JAX harness on the edited reference traces gives the message
    recorded in MESSAGES."""
    prog, edit = CASES[case]
    rv, rt = rk_trace(rasm.assemble(PROGRAMS[prog] + EXIT))
    rc, rlogs, rtr = rbuild(rv, rt)
    rtr = [_columns(t) for t in rtr]
    edit(rc, rtr)
    with pytest.raises(rtesting.ConstraintViolation) as e:
        rtesting.assert_constraints(rc, rlogs, rtr)
    assert str(e.value) == MESSAGES[case]
