"""The interaction in row windows, as a mesh rank makes it, against the
JAX package's whole interaction.

Under a mesh of D ranks that splits a component's M rows, rank r
generates only rows [r·M/D, (r+1)·M/D) (``prover/stark.py``
`_interactions`): the packed operands of its gen tape (K7's operands
entry; its plain version here) from halo-extended blocks of its natural
main and preprocessed rows (`interaction_operands` with a window), the
LogUp columns (K6; its plain version here) once for the window's total,
then again from the carry of the totals of the ranks before it
(`interaction_columns`).  For D = 2, 4 and 8 and every rank:

- the window's operand buffer, laid out for M/D rows
  (`Tape.layout`), holds those rows of the whole trace's buffer;
- its columns equal those rows of the JAX package's
  `generate_interaction` body (`_gen_interaction_body`, run eagerly on
  XLA:CPU as tests/test_torch_tape.py runs it);
- the sum of the D totals equals the JAX package's claimed sum.

Inputs: the fib n = 10 guest's CPU component and its output_check
component (193 main and 244 interaction columns; 5 and 12, which
neither 8 nor, for 5, any D divides), the e2e fixture of
tests/test_stark_e2e.py, and a component whose fractions read two rows
back and one ahead, so its windows need a halo that wraps.  Every
comparison is uint32-exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
import test_stark_e2e as E
from test_torch_machine import FIB10_SRC, _both
from nexus_zkvm_tpu.air import Component as RComponent
from nexus_zkvm_tpu.air import component as RC
from nexus_zkvm_tpu.air.lookups import draw_relations as rdraw
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.machine import driver as rdriver
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air import Component
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.air import tape as tp, tape_cuda
from nexus_zkvm_tpu_torch.air.lookups import LookupElements, draw_relations
from nexus_zkvm_tpu_torch.air.tape import (
    MAIN, ISF, air_eval_operands, gen_halo, gen_tape, interaction_columns,
    interaction_operands)
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

P = (1 << 31) - 1
SHIFTED_LOG = 6


class Shifted(Component):
    """Fractions over rows two back and one ahead (gen halo (2, 1)), and
    a constant numerator and an M31 column one, so the buffer holds
    every operand mode."""
    name = "shifted"
    n_main = 3

    def evaluate(self, ctx):
        a, b, c = ctx.main(0), ctx.main(1), ctx.main(2)
        ctx.constraint(a * b - c)
        ctx.add_fraction(ctx.main(0, -2), "vals", [b, ctx.main(2, 1)])
        ctx.add_fraction(1, "vals", [c])
        ctx.add_fraction(-a, "pairs", [ctx.main(1, -1)])


RShifted = type("RShifted", (RComponent,),
                {"name": Shifted.name, "n_main": Shifted.n_main,
                 "evaluate": Shifted.evaluate})


def _case(rcomp, comp, main, pre, log, rcomps, comps):
    widths = _relation_widths([component_info(c) for c in comps])
    return {"rcomp": rcomp, "comp": comp, "main": main, "pre": pre,
            "log": log, "widths": widths,
            "rrel": rdraw(RChannel(), widths),
            "trel": draw_relations(T.Blake2sChannel(), widths)}


@pytest.fixture(scope="module")
def cases():
    """name -> the two packages' component, its natural main and
    preprocessed rows (numpy uint32), log size and relations."""
    (rv, _rt), (tv, tt) = _both(FIB10_SRC)
    rcomps = rdriver.build_components(rv, 1)[0]
    tc, tlogs, ttr = tdriver.build_machine_traces(tv, tt, device="cpu")
    out = {}
    for name in ("cpu", "output_check"):
        i = [c.name for c in tc].index(name)
        tr = ttr[i]
        main = (to_u32(tr) if isinstance(tr, torch.Tensor) else
                np.stack([np.asarray(col, np.uint32) for col in tr]))
        pre = [a for _n, a in tc[i].preprocessed(tlogs[i])]
        out[f"fib10-{name}"] = _case(
            rcomps[i], tc[i], main,
            np.stack(pre).astype(np.uint32) if pre else None, tlogs[i],
            rcomps, tc)
    comps = chip_smoke.make_components(1)
    for i, tr in enumerate(E.make_traces()):
        out[f"e2e-{E.COMPONENTS[i].name}"] = _case(
            E.COMPONENTS[i], comps[i], np.stack(tr).astype(np.uint32), None,
            E.LOG_SIZES[i], E.COMPONENTS, comps)
    rng = np.random.default_rng(14)
    out["shifted"] = _case(
        RShifted(), Shifted(),
        rng.integers(0, P, (3, 1 << SHIFTED_LOG), dtype=np.uint32), None,
        SHIFTED_LOG, [RShifted()], [Shifted()])
    return out


@pytest.fixture(scope="module")
def references(cases):
    """name -> the JAX package's (B, M, 4) interaction columns."""
    return {name: np.asarray(RC._gen_interaction_body(
                c["rcomp"], jnp.asarray(c["main"]),
                None if c["pre"] is None else jnp.asarray(c["pre"]),
                c["rrel"], c["log"], RC._params_flat(c["rcomp"])), np.uint32)
            for name, c in cases.items()}


def _block(mat, lo, L, halo, M):
    """The (C, hneg + L + hpos) block of natural rows lo - hneg ..
    lo + L + hpos - 1 (mod M) of a numpy matrix, on the CPU."""
    if mat is None:
        return None
    hneg, hpos = halo
    rows = np.arange(lo - hneg, lo + L + hpos) % M
    return from_u32(np.ascontiguousarray(mat[:, rows]), "cpu")


def _window(c, lo, L):
    halo = gen_halo(c["comp"], c["log"], c["widths"])
    M = 1 << c["log"]
    return interaction_operands(
        c["comp"], _block(c["main"], lo, L, halo, M),
        _block(c["pre"], lo, L, halo, M), c["trel"], c["log"], "cpu",
        (lo, L, halo[0]))


def _operand_rows(whole, meta_w, lo, L) -> np.ndarray:
    """The words of the whole trace's operand buffer that a window of
    rows [lo, lo + L) holds, in the window's layout: a column's rows lo..
    (four words a row for QM31), a constant as it is."""
    parts = []
    for off, mode in meta_w.reshape(-1, 2).tolist():
        w = (1, 1, 4, 4)[mode]
        parts.append(whole[off:off + w] if mode in (0, 2) else
                     whole[off + w * lo:off + w * (lo + L)])
    return np.concatenate(parts)


CASES = ["fib10-cpu", "fib10-output_check", "e2e-square", "e2e-table",
         "shifted"]


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("name", CASES)
def test_window_rows_equal_reference(cases, references, name, D):
    """Every rank's operands, its LogUp columns with the carry of the
    ranks before it, and the claimed sum of the D totals, against the
    whole trace's operands and the JAX package's columns."""
    c, ref = cases[name], references[name]
    M = 1 << c["log"]
    L = M // D
    whole_src, meta_w, _M = interaction_operands(
        c["comp"], from_u32(c["main"], "cpu"),
        None if c["pre"] is None else from_u32(c["pre"], "cpu"), c["trel"],
        c["log"], "cpu")
    whole_src = to_u32(whole_src)
    totals = np.zeros((D, 4), np.int64)
    for r in range(D):
        lo = r * L
        got = _window(c, lo, L)
        assert got[2] == L
        assert np.array_equal(to_u32(got[0]),
                              _operand_rows(whole_src, meta_w, lo, L)), r
        cols = interaction_columns(got)
        totals[r] = to_u32(cols[-1, -1])
        if r:
            carry = totals[:r].sum(axis=0) % P
            cols = interaction_columns(got, from_u32(
                carry.astype(np.uint32), "cpu"))
        assert cols.shape == (ref.shape[0], L, 4)
        assert np.array_equal(to_u32(cols), ref[:, lo:lo + L]), (r, D)
    assert np.array_equal(totals.sum(axis=0) % P, ref[-1, -1].astype(np.int64))


@pytest.mark.parametrize("name", CASES)
def test_layout_of_the_whole_trace_is_the_recorded_one(cases, name):
    """`Tape.layout` at the trace's row count and at a window's: K6's
    table lays the tape's operands end to end in its modes' sizes (1, L,
    4, 4L words), and the stores over L rows write every word of the
    buffer once."""
    c = cases[name]
    tape = gen_tape(c["comp"], c["log"], c["trel"])
    M = 1 << c["log"]
    for L in (M, M // 8):
        stores, meta, words = tape.layout(L)
        off, mode = meta.reshape(-1, 2).T.tolist()
        size = [(1, L, 4, 4 * L)[m] for m in mode]
        assert torch.equal(meta[..., 1], tape.modes)
        assert off == np.cumsum([0] + size[:-1]).tolist()
        assert words == off[-1] + size[-1]
        hits = np.zeros(words, np.int64)
        for _v, base, step in stores.tolist():
            at = base + step * np.arange(L if step else 1)
            np.add.at(hits, at, 1)
        assert (hits == 1).all(), L


@pytest.mark.parametrize("name", CASES)
def test_stand_in_gen_tape_has_the_drawn_source(cases, name):
    """The gen tape that `gen_halo` records before any relation is drawn
    (stand-ins, here in reverse order of their names) has the K7 source
    of the tape recorded with the drawn relations, so a mesh rank loads
    the pieces one process built and builds none of its own."""
    c = cases[name]
    stand = {n: LookupElements.dummy(n, w)
             for n, w in reversed(sorted(c["widths"].items()))}
    got, want = (tape_cuda.pieces(tp._record_gen(c["comp"], rel))
                 for rel in (stand, c["trel"]))
    assert [p.text for p in got] == [p.text for p in want]


def test_gen_halo_is_the_tape_loads():
    """The halo comes from the gen tape's own loads: two rows back and
    one ahead for the shifted component, none for the fib components."""
    widths = _relation_widths([component_info(Shifted())])
    assert gen_halo(Shifted(), SHIFTED_LOG, widths) == (2, 1)


def test_window_without_its_halo_is_refused(cases):
    """A window whose blocks lack the rows a load reads raises instead of
    reading past them."""
    c = cases["shifted"]
    tape = gen_tape(c["comp"], c["log"], c["trel"])
    M, L = 1 << c["log"], 1 << (c["log"] - 2)
    main = _block(c["main"], L, L, (1, 1), M)
    mats = {MAIN: main, ISF: torch.zeros((1, L + 2), dtype=torch.int32)}
    with pytest.raises(ValueError, match="falls outside"):
        air_eval_operands(tape, mats, tape.uniforms(c["trel"], None), M, L,
                          L, 1)


def test_carry_starts_the_last_column(cases):
    """K6's plain version with a carry adds it to every row of the last
    column and leaves the pair columns as they are."""
    c = cases["fib10-cpu"]
    got = _window(c, 0, (1 << c["log"]) // 2)
    plain = to_u32(interaction_columns(got)).astype(np.int64)
    carry = np.asarray([5, P - 1, 0, 123456789], np.int64)
    with_carry = to_u32(interaction_columns(got, from_u32(
        carry.astype(np.uint32), "cpu"))).astype(np.int64)
    assert np.array_equal(with_carry[:-1], plain[:-1])
    assert np.array_equal(with_carry[-1], (plain[-1] + carry) % P)
