"""The port's machine2 (per-instruction-family) traces and constraints.

Same programs through both packages, on the CPU:

* `build_machine2_traces`: every component's name, log size and column
  equal the JAX package's (uint32), for the programs of
  `tests/test_machine2.py` and the fib guest (`examples/guests/fib.s`);
* every family's constraints hold under the port's harness
  (`air/testing.py`: the interaction from the port's constraint tapes
  and LogUp columns), and `relation_balance_report` equals the JAX
  package's (empty) on the same traces;
* the syscall and keccak-dispatch flows of `tests/test_machine2.py`.

The tamper and forgery cases are in `test_torch_machine2_attacks.py`,
the proof in `test_torch_machine2_proof.py`.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from nexus_zkvm_tpu.air.testing import (relation_balance_report as
                                        rbalance)
from nexus_zkvm_tpu.machine2 import build_machine2_traces as rbuild
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
from nexus_zkvm_tpu_torch.air.testing import (assert_constraints,
                                              relation_balance_report)
from nexus_zkvm_tpu_torch.machine2 import (EXEC_FAMILIES,
                                           build_machine2_traces)
from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
from nexus_zkvm_tpu_torch.utils.device import to_u32
from nexus_zkvm_tpu_torch.vm import asm, k_trace
import torch_cpu  # noqa: F401  (one torch thread a test process)

EXIT = """
    addi a0, zero, 0
    addi a7, zero, 0x201
    ecall
"""
# the programs of tests/test_machine2.py (PROGRAMS), each run + EXIT
PROGRAMS = {
    "alu": """
        li t0, 0x12345678
        li t1, 0xfedcba98
        add t2, t0, t1
        sub t3, t0, t1
        addi t4, t0, -999
        addi t5, t0, 2047
        lui  t6, 0xabcde
        auipc s2, 0x1
        auipc s3, 0xfffff
    """,
    "bitwise": """
        li t0, 0x12345678
        li t1, 0xfedcba98
        and t2, t0, t1
        or  t3, t0, t1
        xor t4, t0, t1
        andi t5, t0, 0xff
        ori  t6, t0, 0x0f
        xori s2, t0, -1
    """,
    "shift": """
        li t0, 0x80c01234
        sll t1, t0, zero
        slli t2, t0, 1
        slli t3, t0, 31
        srli t4, t0, 1
        srli t5, t0, 31
        srai t6, t0, 4
        srai s2, t0, 31
        li  t1, 13
        sll s3, t0, t1
        srl s4, t0, t1
        sra s5, t0, t1
    """,
    "cmp": """
        li t0, -5
        li t1, 5
        slt  t2, t0, t1
        slt  t3, t1, t0
        sltu t4, t0, t1
        sltu t5, t1, t0
        slti t6, t0, 1001
        sltiu s2, t0, 999
        slt  s3, t0, t0
    """,
    "branch": """
        li t0, -3
        li t1, 7
        beq t0, t0, l1
        nop
    l1: bne t0, t1, l2
        nop
    l2: blt t0, t1, l3
        nop
    l3: bge t1, t0, l4
        nop
    l4: bltu t1, t0, l5     # not taken (unsigned -3 is big)
        bgeu t0, t1, l5
        nop
    l5:
    """,
    "jump": """
        jal ra, f
        j   done
    f:  ret
    done:
    """,
    "memory": """
        addi a7, zero, 0x403    # heap pointer
        ecall
        mv   t1, a0
        li   t2, 0x818283f4
        sw   t2, 0(t1)
        lb   t3, 3(t1)
        lbu  t4, 1(t1)
        lh   t5, 2(t1)
        lhu  t6, 0(t1)
        sb   t2, 5(t1)
        sh   t2, 6(t1)
        lw   s2, 4(t1)
        lw   s3, 0x80(zero)     # RO region read
    """,
    "mext": """
        li t0, 0x12345678
        li t1, 0xfedcba98
        mul    t2, t0, t1
        mulh   t3, t0, t1
        mulhsu t4, t0, t1
        mulhu  t5, t0, t1
        li t4, -100
        li t5, 7
        div  s2, t4, t5
        rem  s3, t4, t5
        divu s4, t0, t5
        remu s5, t0, t5
        div  s6, t0, zero       # div-by-zero edge
    """,
    "fib": """
        addi t0, zero, 12
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
    """,
}
SYSCALLS_SRC = """
    addi a7, zero, 0x400    # private input
    ecall
    mv t0, a0
    addi a7, zero, 0x402    # stack pointer
    ecall
    addi a7, zero, 0x403    # heap pointer
    ecall
    addi a7, zero, 0x405    # memory advise
    ecall
    lw   t1, 0x84(zero)
    li   t2, 0xcafef00d
    sw   t2, 0(t1)
    addi a0, zero, 3
    addi a7, zero, 0x201
    ecall
"""
KECCAK_DISPATCH_SRC = """
    addi a7, zero, 0x403
    ecall
    mv   t1, a0
    li   t2, 0xdeadbeef
    sw   t2, 0(t1)
    keccakf x0, t1, x0
    lw   t3, 0(t1)
""" + EXIT


def _matrix(tr) -> np.ndarray:
    if isinstance(tr, torch.Tensor):
        return to_u32(tr)
    return np.stack([np.asarray(c, np.uint32) for c in tr])


def _port(src, **kw):
    view, trace = k_trace(asm.assemble(src), **kw)
    return view, build_machine2_traces(view, trace, device="cpu")


def _check(src, **kw):
    """`tests/test_machine2.py`'s `check` on the port: balanced
    relations, every constraint satisfied."""
    view, (comps, log_sizes, traces) = _port(src, **kw)
    report = relation_balance_report(comps, log_sizes, traces)
    assert not report, f"unbalanced relations: {report}"
    assert_constraints(comps, log_sizes, traces, device="cpu")
    return view, comps, log_sizes, traces


def _fib_guest_traces():
    from nexus_zkvm_tpu.sdk import Guest as RGuest, LocalProver as RProver
    src = (chip_smoke.ROOT / "examples" / "guests" / "fib.s").read_text()
    public = encode_u32s(10)
    rv, rt = RProver(RGuest.from_asm(src)).trace(public_input=public)
    tv, tt = LocalProver(chip_smoke.fib_guest(), device="cpu").trace(
        public_input=public)
    return (rv, rt), (tv, tt)


@pytest.mark.parametrize("name", sorted(PROGRAMS) + ["fib_guest",
                                                     "keccak_dispatch"])
def test_build_machine2_traces_equal(name):
    if name == "fib_guest":
        (rv, rt), (tv, tt) = _fib_guest_traces()
    else:
        src = KECCAK_DISPATCH_SRC if name == "keccak_dispatch" \
            else PROGRAMS[name] + EXIT
        rv, rt = rk_trace(rasm.assemble(src))
        tv, tt = k_trace(asm.assemble(src))
    rc, rlogs, rtr = rbuild(rv, rt)
    tc, tlogs, ttr = build_machine2_traces(tv, tt, device="cpu")
    assert [c.name for c in tc] == [c.name for c in rc]
    assert tlogs == rlogs
    for c, (r, t) in enumerate(zip(rtr, ttr)):
        if c < len(EXEC_FAMILIES):
            # a family's trace goes to the device once, as one matrix
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32
        assert np.array_equal(_matrix(t), _matrix(r)), tc[c].name
    assert rbalance(rc, rlogs, rtr) == relation_balance_report(tc, tlogs,
                                                               ttr)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_family_constraints(name):
    _check(PROGRAMS[name] + EXIT)


def test_syscalls_and_output():
    view, *_ = _check(SYSCALLS_SRC, private_input=bytes([9]))
    assert view.exit_code == 3


def test_keccak_dispatch():
    view, trace = k_trace(asm.assemble(KECCAK_DISPATCH_SRC))
    assert len(trace.machine_state["keccak_log"]) == 1
    comps, log_sizes, traces = build_machine2_traces(view, trace,
                                                     device="cpu")
    assert_constraints(comps, log_sizes, traces, device="cpu")


def test_family_shapes():
    """The families' widths (the JAX package's schemas)."""
    from nexus_zkvm_tpu.machine2.exec_components import \
        EXEC_FAMILIES as REXEC
    assert [f.name for f in EXEC_FAMILIES] == [f.name for f in REXEC]
    assert [f.n_main for f in EXEC_FAMILIES] == [f.n_main for f in REXEC]
    assert [tuple(int(o) for o in f.FLAGS) for f in EXEC_FAMILIES] == \
        [tuple(int(o) for o in f.FLAGS) for f in REXEC]


def test_galeshapley_through_machine2():
    """`tests/test_examples.py`'s `test_galeshapley` guest (stable
    matching) through machine2: traces equal to the JAX package's, every
    constraint satisfied."""
    from nexus_zkvm_tpu.sdk import Guest as RGuest
    from nexus_zkvm_tpu_torch.sdk import Guest
    men = [[0, 1, 2, 3], [1, 0, 3, 2], [2, 3, 0, 1], [3, 1, 2, 0]]
    women = [[3, 2, 1, 0], [0, 1, 2, 3], [1, 0, 3, 2], [2, 3, 0, 1]]
    public = encode_u32s(*[x for rows in (men, women) for r in rows
                           for x in r])
    src = (chip_smoke.ROOT / "examples" / "guests" / "galeshapley.s") \
        .read_text()
    rg, tg = RGuest.from_asm(src), Guest.from_asm(src)
    rv, rt = rk_trace(rg.program_words, entry=rg.entry, public_input=public,
                      backend="python")
    tv, tt = k_trace(tg.program_words, entry=tg.entry, public_input=public,
                     backend="python")
    assert tv.exit_code == 0
    rc, rlogs, rtr = rbuild(rv, rt)
    tc, tlogs, ttr = build_machine2_traces(tv, tt, device="cpu")
    assert tlogs == rlogs
    for r, t in zip(rtr, ttr):
        assert np.array_equal(_matrix(t), _matrix(r))
    assert relation_balance_report(tc, tlogs, ttr) == {}
    assert_constraints(tc, tlogs, ttr, device="cpu")
