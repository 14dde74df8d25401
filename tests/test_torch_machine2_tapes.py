"""Kernel K7's generated sources for the machine2 families, on the CPU.

Each of the 12 family components' two constraint tapes (composition,
LogUp operands) is written out by ``air/tape_cuda.py`` and compiled with
``g++ -DNZT_HOST`` (as `tests/test_torch_tape_cuda.py` does for machine
v1's): on seeded random rows, its output is uint32-equal to the plain
interpreter's, which the harness and proof tests hold to the JAX
package (`test_torch_machine2*.py`).  Each family's tape statistics are
checked against its shape: every constraint an emit, one store a
LogUp operand word, one piece.
"""

import numpy as np
import pytest

import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import tape_cuda
from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.air.tape import (MAIN, PRE, ISF,
                                           air_eval_operands_plain,
                                           domain_tape, gen_tape, tape_stats)
from nexus_zkvm_tpu_torch.machine2 import EXEC_FAMILIES, build_components2
from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm, k_trace
from test_torch_machine2 import EXIT, PROGRAMS
from test_torch_tape_cuda import (_composition_inputs, _host_build,
                                  _host_composition, _plain_composition,
                                  _ptr, _u32)

LOG = 5
NAMES = [f.name for f in EXEC_FAMILIES]


@pytest.fixture(scope="module")
def families():
    view, _t = k_trace(asm.assemble(PROGRAMS["fib"] + EXIT))
    comps = build_components2(view)[0]
    rel = draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))
    return {c.name: c for c in comps[:len(EXEC_FAMILIES)]}, rel


@pytest.fixture(scope="module")
def host_libs(families, tmp_path_factory):
    comps, rel = families
    todo = {}
    for name, comp in comps.items():
        for kind, fn in (("domain", domain_tape), ("gen", gen_tape)):
            tape = fn(comp, LOG, rel)
            todo[(name, kind)] = (tape_cuda._name(tape),
                                  tape_cuda.pieces(tape))
    return _host_build(todo, tmp_path_factory.mktemp("k7m2"))


@pytest.mark.parametrize("name", NAMES)
def test_family_tape_shape(families, name):
    comps, rel = families
    comp = comps[name]
    info = component_info(comp)
    st = tape_stats(comp, LOG, rel)
    assert st["domain"]["outputs"] == info.n_constraints
    assert st["domain"]["pieces"] == st["gen"]["pieces"] == 1
    tape = gen_tape(comp, LOG, rel)
    assert int(tape.modes.shape[1]) == info.n_logup_cols
    assert info.n_main == comp.SCHEMA.n_cols


@pytest.mark.parametrize("name", NAMES)
def test_generated_family_composition_equals_plain(families, host_libs,
                                                   name):
    comps, rel = families
    comp = comps[name]
    tape = domain_tape(comp, LOG, rel)
    rng = np.random.default_rng(NAMES.index(name))
    N = 1 << (LOG + 2)
    hneg, hpos = domain_halo(component_info(comp))
    mats, claimed, alpha, shift, invv, start = _composition_inputs(
        comp, N, N + hneg + hpos, rng)
    uni = tape.uniforms(rel, claimed)
    got = start.copy()
    _host_composition(host_libs[(name, "domain")], tape, mats, uni, alpha,
                      0, N, hneg, shift, invv, got)
    want = _plain_composition(tape, mats, uni, 0, N, hneg, alpha, shift,
                              invv, start)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("window", ["whole", "window"])
@pytest.mark.parametrize("name", NAMES)
def test_generated_family_operands_equal_plain(families, host_libs, name,
                                               window):
    """A family's LogUp operands through its generated text, over the
    whole trace and over its second quarter as a mesh rank's window
    (halo-extended blocks of random rows, the buffer laid out for the
    window's rows), against the plain interpreter."""
    comps, rel = families
    comp = comps[name]
    tape = gen_tape(comp, LOG, rel)
    info = component_info(comp)
    rng = np.random.default_rng(100 + NAMES.index(name)
                                + 50 * (window == "window"))
    M = 1 << LOG
    lo, L, (hneg, hpos) = ((0, M, (0, 0)) if window == "whole" else
                           (M // 4, M // 4, tape.halo()))
    W = hneg + L + hpos
    mats = {MAIN: _u32(rng, (info.n_main, W)), PRE: None,
            ISF: _u32(rng, (1, W))}
    uni = tape.uniforms(rel, None)
    bases = [_ptr(mats[MAIN] if mats.get(r) is None else mats[r])
             for r in range(4)]
    out = np.full(tape.layout(L)[2], 0xDEADBEEF, np.uint32)
    for fn, piece in zip(host_libs[(name, "gen")], tape_cuda.pieces(tape)):
        words = np.ascontiguousarray(
            np.asarray(uni, np.int64)[piece.table].astype(np.uint32))
        assert fn(*bases, W, L, hneg, M - 1 if L == M else -1, _ptr(out),
                  _ptr(words), None) == 0
    want = to_u32(air_eval_operands_plain(
        tape, {r: None if m is None else from_u32(m, "cpu")
               for r, m in mats.items()}, uni, M,
        *(() if L == M else (lo, L, hneg))))
    assert np.array_equal(out, want)
