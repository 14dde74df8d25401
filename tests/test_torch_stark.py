"""End-to-end prove/verify of the PyTorch port against the JAX package.

The two-component fixture of tests/test_stark_e2e.py (squares at 2^6
rows, a lookup table at 2^4) goes through both packages with the same
components and traces.  The port's proof equals the reference proof
field by field; the port's verifier accepts both proofs and rejects the
tamper cases and the invalid and unbalanced traces.
"""

import copy

import numpy as np
import pytest

from nexus_zkvm_tpu.air import Component
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.ops.fri import FriConfig as RFriConfig
from nexus_zkvm_tpu.prover import PcsConfig as RPcsConfig, prove as rprove
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.ops import fri as TF, merkle as TM
import torch_cpu  # noqa: F401  (one torch thread a test process)

P = (1 << 31) - 1
RCFG = RPcsConfig(pow_bits=4, fri=RFriConfig(log_blowup=1, log_last_layer=0,
                                             n_queries=8))
TCFG = T.PcsConfig(pow_bits=4, fri=T.FriConfig(log_blowup=1, log_last_layer=0,
                                               n_queries=8))
LOG_SQ, LOG_TB = 6, 4


class SquareComp(Component):
    """y = x^2; z = next-row x; emits each y into the 'vals' relation."""
    name = "square"
    n_main = 3

    def evaluate(self, ctx):
        x, y, z = ctx.main(0), ctx.main(1), ctx.main(2)
        ctx.constraint(y - x * x)
        ctx.constraint(z - ctx.main(0, 1))
        ctx.add_fraction(1, "vals", [y])


class TableComp(Component):
    """(val, mult) table consuming the 'vals' relation."""
    name = "table"
    n_main = 2

    def evaluate(self, ctx):
        val, mult = ctx.main(0), ctx.main(1)
        ctx.add_fraction(-mult, "vals", [val])


COMPONENTS = [SquareComp(), TableComp()]
LOG_SIZES = [LOG_SQ, LOG_TB]


def make_traces():
    x = (np.arange(1 << LOG_SQ) % 7).astype(np.uint32)
    y = (x.astype(np.uint64) ** 2 % P).astype(np.uint32)
    vals = np.zeros(1 << LOG_TB, np.uint32)
    mult = np.zeros(1 << LOG_TB, np.uint32)
    uniq, counts = np.unique(y, return_counts=True)
    vals[:len(uniq)] = uniq
    mult[:len(uniq)] = counts
    return [[x, y, np.roll(x, -1)], [vals, mult]]


def tprove(traces):
    return T.prove(COMPONENTS, LOG_SIZES, traces, T.Blake2sChannel(), TCFG,
                   device="cpu")


def tverify(proof):
    return T.verify(COMPONENTS, proof, T.Blake2sChannel(), TCFG,
                    device="cpu")


def tree_eq(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tree_eq(u, v) for u, v in zip(a, b))
    if hasattr(a, "__dict__"):
        return tree_eq(vars(a), vars(b))
    if hasattr(a, "shape"):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def to_port_proof(p):
    """Reference proof -> the port's proof classes (same fields)."""
    dec = (lambda d: TM.MerkleDecommitment(
        column_values=[np.asarray(v) for v in d.column_values],
        sibling_hashes=[np.asarray(h) for h in d.sibling_hashes]))
    return T.Proof(
        log_sizes=list(p.log_sizes),
        roots={r: [(s, np.asarray(x)) for s, x in v]
               for r, v in p.roots.items()},
        claimed_sums=[np.asarray(c) for c in p.claimed_sums],
        sampled=[np.asarray(s) for s in p.sampled],
        fri_proof=TF.FriProof(
            inner_roots=[np.asarray(r) for r in p.fri_proof.inner_roots],
            inner_decommitments=[dec(d) for d in
                                 p.fri_proof.inner_decommitments],
            last_layer=np.asarray(p.fri_proof.last_layer)),
        pow_nonce=int(p.pow_nonce),
        openings={r: [(s, dec(d)) for s, d in v]
                  for r, v in p.openings.items()})


@pytest.fixture(scope="module")
def proofs():
    # the reference prove() clears the caller's trace list: a fresh
    # list for each call
    ref = rprove(COMPONENTS, LOG_SIZES, make_traces(), RChannel(), RCFG)
    traces = make_traces()
    port = tprove(traces)
    return ref, port, traces


def test_port_proof_equals_reference(proofs):
    ref, port, _ = proofs
    assert tree_eq(to_port_proof(ref), port)
    assert tree_eq(ref, port)


def test_port_verifies_both_proofs(proofs):
    ref, port, _ = proofs
    assert tverify(port)
    assert tverify(to_port_proof(ref))
    assert port.size_estimate() == ref.size_estimate()


def test_prove_leaves_traces_intact(proofs):
    _, _, traces = proofs
    fresh = make_traces()
    assert len(traces) == len(fresh)
    for got, want in zip(traces, fresh):
        assert len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _tamper_claimed(p):
    p.claimed_sums[0] = np.asarray((p.claimed_sums[0] + 1) % P, np.uint64)


def _tamper_sampled(p):
    p.sampled[5] = np.asarray((p.sampled[5] + 1) % P, np.uint64)


def _tamper_opening(p):
    dec = p.openings["main"][0][1]
    dec.column_values[0] = np.asarray(dec.column_values[0]).copy()
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % P


def _tamper_pow(p):
    p.pow_nonce += 1


@pytest.mark.parametrize("tamper", [_tamper_claimed, _tamper_sampled,
                                    _tamper_opening, _tamper_pow],
                         ids=["claimed_sum", "sampled", "opening", "pow"])
def test_tampered_proof_rejected(proofs, tamper):
    bad = copy.deepcopy(proofs[1])
    tamper(bad)
    assert not tverify(bad)


def test_invalid_trace_rejected():
    traces = make_traces()
    traces[0][1] = np.asarray((traces[0][1].astype(np.uint64) + 1) % P,
                              np.uint32)          # y != x^2
    assert not tverify(tprove(traces))


def test_unbalanced_lookup_rejected():
    traces = make_traces()
    traces[1][1] = traces[1][1].copy()
    traces[1][1][0] += 1          # claimed sums no longer cancel
    assert not tverify(tprove(traces))
