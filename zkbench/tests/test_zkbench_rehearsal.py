"""A CPU rehearsal of each cell's run, and the faults its check must
catch.

``session.run`` is called as a function on the CPU (the command line
refuses to run without a card), with jobs of n = 10 to 12.  The real
entry proves them; the faults are planted where the answer is produced,
in an entry that hands out real proofs: a job that returns the previous
job's answer (its state unchanged), half of the jobs left out, the
public output altered, the memory layout altered, a proof value
altered, and the control: proofs made with one FRI query fewer than the
configuration states.  Each
must turn ``correct`` false.  (A one-card cell has no exchange between
cards to leave out.)
"""

import copy
import dataclasses
import time

import numpy as np
import pytest

from control import control_pcs
from harness import session, spec

CELLS = ["fib-v1.ladder", "fib-m2.ladder"]
NS = (10, 11, 12)


@pytest.fixture(scope="module", params=CELLS)
def cell_proofs(request):
    cell = spec.load_cell(request.param)
    job = spec.load_module("traffic", cell.traffic["job"])
    machine = spec.load_module("machines", cell.config["machine"])

    def prove_all(pcs):
        entry = machine.Entry(cell, job.guest(), session.prover_pcs(pcs),
                              "cpu")
        return {n: entry.prove(job.public_input(n)) for n in NS}
    return (cell, prove_all(cell.config["pcs"]),
            prove_all(control_pcs(cell.config["pcs"])))


class Handout:
    """An entry that hands out ready answers, ``plant`` applied."""

    def __init__(self, answers, plant=None, pause=0.1):
        self.answers, self.plant, self.pause = answers, plant, pause
        self.count, self.last = 0, None

    def prove(self, public):
        time.sleep(self.pause)
        n = int.from_bytes(public, "little")
        out = self.answers[n]
        if self.plant is not None:
            out = self.plant(self, out)
        self.last, self.count = out, self.count + 1
        return out


def run(cell, entry, seconds=0.25):
    return session.run(cell, 1, seconds, False, device="cpu",
                       schedule=([NS[0]], list(NS)), entry=entry)


def test_rehearsal_on_the_cpu_is_correct():
    """One job of each cell through its real entry, judged by the
    plain reference."""
    for name in CELLS:
        r = session.run(spec.load_cell(name), 1, 0, False, device="cpu",
                        schedule=([10], [10]))
        assert r["correct"] and (r["attempted"], r["failed"]) == (1, 0)
        assert list(r)[-1] == "compared"
        assert all(c["value"] == 0 for c in r["compared"].values())


def test_handed_out_answers_are_correct(cell_proofs):
    cell, good, _ = cell_proofs
    r = run(cell, Handout(good))
    assert r["correct"] and r["attempted"] >= 2


def _stale(h, out):
    return h.last if h.last is not None else out


def _half(h, out):
    return (None, None) if h.count % 2 else out


def _output(h, out):
    view, proof = copy.deepcopy(out)
    b = bytearray(view.public_output)
    b[0] ^= 1
    view.public_output = bytes(b)
    return view, proof


def _layout(h, out):
    view, proof = copy.deepcopy(out)
    lay = view.memory_layout
    view.memory_layout = dataclasses.replace(
        lay, stack_top=lay.stack_top + 16, end=lay.end + 16)
    return view, proof


def _proof_value(h, out):
    view, proof = copy.deepcopy(out)
    s = proof.stark.sampled
    s[0] = np.array(s[0], copy=True)
    s[0].flat[0] = (int(s[0].flat[0]) + 1) % ((1 << 31) - 1)
    return view, proof


@pytest.mark.parametrize("plant, caught_by", [
    (_stale, "claims_wrong"), (_half, "jobs_failed"),
    (_output, "claims_wrong"), (_layout, "claims_wrong"),
    (_proof_value, "proofs_rejected")],
    ids=["state_unchanged", "half_left_out", "output_altered",
         "layout_altered", "proof_altered"])
def test_a_planted_fault_is_not_correct(cell_proofs, plant, caught_by):
    cell, good, _ = cell_proofs
    r = run(cell, Handout(good, plant))
    assert r["attempted"] >= 2
    assert not r["correct"] and r["failed"] >= 1
    assert r["compared"][caught_by]["value"] >= 1


def test_the_control_is_not_correct(cell_proofs):
    cell, _, weak = cell_proofs
    r = run(cell, Handout(weak))
    assert not r["correct"]
    assert r["compared"]["proofs_rejected"]["value"] == r["attempted"]
