"""The prover's self-test (`prove(..., selftest=True)`) against the JAX
package's (`NZT_PROVE_SELFTEST`).

The self-test recomputes every OODS sample column by column and holds
each component's verifier-side value at the OODS point to the prover's
domain accumulator interpolated and evaluated there, then the total to
the composition's sampled value.  On the two-component fixture of
tests/test_stark_e2e.py both packages run live and print the same
``[selftest]`` lines; on the fib n = 10 machine v1 proof (minutes of
XLA:CPU for the JAX package) the port's lines equal the JAX package's
recorded in FIB10_SELFTEST_LINES, and the `slow` test runs it live.  The
proof is the same with and without the self-test, a perturbed domain
accumulator reads BAD on its component alone (with the per-constraint
report), and a route the self-test cannot follow raises.
"""

import contextlib
import hashlib
import io
import os
import types

import numpy as np
import pytest
import torch

import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.parallel.context import use_mesh
from nexus_zkvm_tpu_torch.prover import stark
from nexus_zkvm_tpu_torch.sdk.serialize import proof_to_bytes
from nexus_zkvm_tpu_torch.utils.profile import profiled
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace
import test_torch_stark as ts
from test_torch_machine import FIB10_PROOF_BLAKE2S, FIB10_SRC, TCFG
import torch_cpu  # noqa: F401  (one torch thread a test process)

# the JAX package's `[selftest]` lines for `machine.driver.prove_machine`
# of FIB10_SRC at TCFG under NZT_PROVE_SELFTEST=1 (XLA:CPU); the slow
# test recomputes them
FIB10_SELFTEST_LINES = (
    "[selftest] sampling: 0 mismatches",
    "[selftest] comp 0 (cpu): OK  point=[ 133988254  594156151 1435741155 "
    " 637833645] domain@z=[ 133988254  594156151 1435741155  637833645]",
    "[selftest] comp 1 (program): OK  point=[ 611176989 1326668479  "
    "151964978  716433013] domain@z=[ 611176989 1326668479  151964978  "
    "716433013]",
    "[selftest] comp 2 (regfile): OK  point=[ 938512049 1357511431 "
    "1632354501  318597982] domain@z=[ 938512049 1357511431 1632354501  "
    "318597982]",
    "[selftest] comp 3 (ram_touched): OK  point=[ 917181813 1545580594 "
    "1623017251 1590472138] domain@z=[ 917181813 1545580594 1623017251 "
    "1590472138]",
    "[selftest] comp 4 (mem_init): OK  point=[ 267195797 1313239535  "
    "144384249  401262877] domain@z=[ 267195797 1313239535  144384249  "
    "401262877]",
    "[selftest] comp 5 (output_check): OK  point=[ 703656648  747443228 "
    "1857168710  347755978] domain@z=[ 703656648  747443228 1857168710  "
    "347755978]",
    "[selftest] comp 6 (mext): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] comp 7 (keccak): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] comp 8 (pre_dummy_div): OK  point=[0 0 0 0] "
    "domain@z=[0 0 0 0]",
    "[selftest] comp 9 (range256): OK  point=[1476481117  264333547  "
    "889396082  210601596] domain@z=[1476481117  264333547  889396082  "
    "210601596]",
    "[selftest] comp 10 (range128): OK  point=[1775982809  592906696 "
    "1289736825  284531373] domain@z=[1775982809  592906696 1289736825  "
    "284531373]",
    "[selftest] comp 11 (range64): OK  point=[ 889203508 1940507658  "
    "996659252   58178838] domain@z=[ 889203508 1940507658  996659252   "
    "58178838]",
    "[selftest] comp 12 (range8): OK  point=[1156830662 1674447637 "
    "1425356902 1133040935] domain@z=[1156830662 1674447637 1425356902 "
    "1133040935]",
    "[selftest] comp 13 (and4): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] comp 14 (xor4): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] comp 15 (shl8): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] comp 16 (shr8): OK  point=[0 0 0 0] domain@z=[0 0 0 0]",
    "[selftest] total=[ 543522711  474770547 1370856205 2026383530] "
    "comp_at_z=[ 543522711  474770547 1370856205 2026383530] match=True",
)


def _printed(fn):
    """(what ``fn()`` returned, the ``[selftest]`` lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[selftest]")]


def _jax_selftest(fn):
    """``fn()`` with the JAX package's self-test on, and its lines."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NZT_PROVE_SELFTEST", "1")
        return _printed(fn)


def _port_selftest(traces, memory=None):
    """The port's e2e proof with the self-test: (proof, report, lines)."""
    with profiled() as prof:
        proof, lines = _printed(lambda: T.prove(
            ts.COMPONENTS, ts.LOG_SIZES, traces, T.Blake2sChannel(),
            ts.TCFG, device="cpu", memory=memory, selftest=True))
    return proof, prof.notes["selftest"], lines


@pytest.fixture(scope="module")
def e2e():
    # a fresh trace list for each JAX prove (it clears the caller's)
    ref, ref_lines = _jax_selftest(lambda: ts.rprove(
        ts.COMPONENTS, ts.LOG_SIZES, ts.make_traces(), ts.RChannel(),
        ts.RCFG))
    return ref, ref_lines, _port_selftest(ts.make_traces())


def test_e2e_selftest_lines_equal_reference(e2e):
    _ref, ref_lines, (_proof, report, lines) = e2e
    assert len(ref_lines) == 2 + len(ts.COMPONENTS)
    assert lines == ref_lines
    assert report["lines"] == lines


def test_e2e_selftest_keeps_the_proof(e2e):
    ref, _ref_lines, (proof, _report, _lines) = e2e
    assert ts.tree_eq(proof, ts.tprove(ts.make_traces()))
    assert ts.tree_eq(ts.to_port_proof(ref), proof)


def test_e2e_selftest_report(e2e):
    _ref, _ref_lines, (_proof, report, _lines) = e2e
    assert report["sampling_mismatches"] == 0
    assert [c["name"] for c in report["components"]] == \
        [c.name for c in ts.COMPONENTS]
    for c in report["components"]:
        assert c["ok"] and c["point"] == c["domain"]
        assert c["constraints"] is None
    assert report["match"] and report["total"] == report["comp_at_z"]


@pytest.fixture(scope="module")
def fib10_selftest():
    view, trace = tk_trace(tasm.assemble(FIB10_SRC), backend="python")
    with profiled() as prof:
        proof, lines = _printed(lambda: tdriver.prove_machine(
            view, trace, TCFG, device="cpu", selftest=True))
    return proof, prof.notes["selftest"], lines


def test_fib10_selftest_lines_equal_recorded(fib10_selftest):
    _proof, report, lines = fib10_selftest
    assert tuple(lines) == FIB10_SELFTEST_LINES
    assert report["lines"] == lines
    assert report["sampling_mismatches"] == 0 and report["match"]
    assert all(c["ok"] for c in report["components"])


def test_fib10_selftest_keeps_the_proof(fib10_selftest):
    proof, _report, _lines = fib10_selftest
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        FIB10_PROOF_BLAKE2S


@pytest.mark.slow
def test_fib10_selftest_lines_equal_reference_live(fib10_selftest):
    from nexus_zkvm_tpu.machine import driver as rdriver
    from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
    from test_torch_machine import RCFG
    rv, rt = rk_trace(rasm.assemble(FIB10_SRC), backend="python")
    _proof, ref_lines = _jax_selftest(lambda: rdriver.prove_machine(
        rv, rt, RCFG))
    assert tuple(ref_lines) == FIB10_SELFTEST_LINES
    assert fib10_selftest[2] == ref_lines


def _bump(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its first value moved by 1 (mod p), the rest kept."""
    t = t.clone()
    flat = t.view(-1)
    flat[0] = (flat[0] + 1) % ((1 << 31) - 1)
    return t


@pytest.mark.parametrize("target", [0, 1])
def test_perturbed_accumulator_reads_bad_on_its_component(target,
                                                          monkeypatch):
    name = ts.COMPONENTS[target].name
    orig = stark._domain_accumulator

    def perturbed(component, *args):
        acc = orig(component, *args)
        return _bump(acc) if component.name == name else acc
    monkeypatch.setattr(stark, "_domain_accumulator", perturbed)
    proof, report, lines = _port_selftest(ts.make_traces())
    assert [c["ok"] for c in report["components"]] == \
        [c != target for c in range(len(ts.COMPONENTS))]
    bad = report["components"][target]
    assert bad["point"] != bad["domain"]
    # every constraint alone still agrees: the accumulator is at fault
    assert bad["constraints"] == []
    assert f"[selftest] comp {target} ({name}): BAD " \
        f"point={np.asarray(bad['point'], np.uint64)} " \
        f"domain@z={np.asarray(bad['domain'], np.uint64)}" in lines
    assert "[selftest]   all constraints match individually " \
        "(combination-order bug?)" in lines
    assert report["sampling_mismatches"] == 0 and report["match"]
    assert ts.tree_eq(proof, ts.tprove(ts.make_traces()))


@pytest.mark.parametrize("group", [1, 16])
@pytest.mark.parametrize("target, constraint", [(0, 1), (1, 0)])
def test_per_constraint_report_names_the_constraint(target, constraint,
                                                    group, monkeypatch):
    # ``group``: constraints evaluated over the domain at once
    monkeypatch.setattr(stark, "SELFTEST_CONSTRAINTS", group)
    name = ts.COMPONENTS[target].name
    orig_acc, orig_each = stark._domain_accumulator, \
        stark.composition_constraints

    def acc(component, *args):
        got = orig_acc(component, *args)
        return _bump(got) if component.name == name else got

    def each(component, *args):
        got = orig_each(component, *args)
        lo, hi = args[-2:]
        if component.name == name and lo <= constraint < hi:
            got = got.clone()
            got[constraint - lo] = _bump(got[constraint - lo])
        return got
    monkeypatch.setattr(stark, "_domain_accumulator", acc)
    monkeypatch.setattr(stark, "composition_constraints", each)
    _proof, report, lines = _port_selftest(ts.make_traces())
    bad = report["components"][target]
    assert not bad["ok"]
    assert [c["index"] for c in bad["constraints"]] == [constraint]
    got = bad["constraints"][0]
    assert got["domain"] != got["point"]
    assert any(ln.startswith(f"[selftest]   constraint {constraint}: "
                             f"domain@z=") for ln in lines)
    assert sum(not c["ok"] for c in report["components"]) == 1


@pytest.mark.parametrize("route", ["streamed", "passes", "mesh"])
def test_selftest_refuses_other_routes(route, monkeypatch):
    def committed(*_a, **_k):
        raise AssertionError("the prover committed before refusing")
    monkeypatch.setattr(stark.pcs, "commit_columns", committed)
    memory = {"streamed": T.MemoryConfig(stream_commit_bytes=1),
              "passes": T.MemoryConfig(comp_nat_budget=1),
              "mesh": T.MemoryConfig()}[route]
    mesh = types.SimpleNamespace(size=2, rank=0) if route == "mesh" \
        else None
    with use_mesh(mesh), pytest.raises(ValueError, match="self-test"):
        T.prove(ts.COMPONENTS, ts.LOG_SIZES, ts.make_traces(),
                T.Blake2sChannel(), ts.TCFG, device="cpu", memory=memory,
                selftest=True)


def test_no_selftest_notes_nothing():
    with profiled() as prof:
        _proof, lines = _printed(lambda: ts.tprove(ts.make_traces()))
    assert "selftest" not in prof.notes and lines == []
    assert "NZT_PROVE_SELFTEST" not in os.environ
