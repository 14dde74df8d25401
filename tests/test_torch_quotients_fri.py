"""DEEP quotients and FRI of the PyTorch port against the JAX package,
on the inputs of tests/test_quotients.py and tests/test_fri.py.

Quotient evaluations, FRI transcripts, roots, decommitments and last
layers must be equal as uint32 (exact); the port's verifier accepts
honest proofs and rejects the tamper cases."""

import numpy as np
import pytest

from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.ops import cfft as RC, fri as RF, quotients as RQ
from nexus_zkvm_tpu.ops.circle import (
    bit_reverse_indices, oods_point_from_felt, qm31_point_add,
    m31_point_as_qm31, subgroup_gen,
)
from nexus_zkvm_tpu_torch.channel import Blake2sChannel as TChannel
from nexus_zkvm_tpu_torch.ops import fri as TF, quotients as TQ
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
import torch_cpu  # noqa: F401  (one torch thread a test process)

P = (1 << 31) - 1


def committed_evals(coeffs, log_eval):
    return np.asarray(RC.evaluate(coeffs, log_eval))[
        bit_reverse_indices(log_eval)]


def quotient_case(rng, bad_value=False):
    log_n, s = 6, 7
    coeffs = [rng.integers(0, P, 1 << log_n, dtype=np.uint32)
              for _ in range(3)]
    cols = np.stack([committed_evals(c, s) for c in coeffs])
    z = oods_point_from_felt(rng.integers(0, P, 4).astype(np.uint64))
    z1 = qm31_point_add(z, m31_point_as_qm31(subgroup_gen(log_n)))
    vals = [RC.evaluate_at_qm31_point(c, z) for c in coeffs]
    if bad_value:
        vals[0] = np.array(vals[0])
        vals[0][0] = (vals[0][0] + 1) % P
    mk = (lambda m: [m.PointSample(point=z, columns=[0, 1, 2], values=vals),
                     m.PointSample(point=z1, columns=[1], values=[
                         RC.evaluate_at_qm31_point(coeffs[1], z1)])])
    gamma = rng.integers(0, P, 4).astype(np.uint64)
    return s, cols, mk(RQ), mk(TQ), gamma


@pytest.mark.parametrize("bad_value", [False, True])
def test_quotients_match_reference(bad_value):
    s, cols, rs, ts, gamma = quotient_case(np.random.default_rng(11),
                                           bad_value)
    want = np.asarray(RQ.accumulate_quotients(s, list(cols), rs, gamma, 3))
    got = to_u32(TQ.accumulate_quotients(s, from_u32(cols, "cpu"), ts,
                                         gamma, 3))
    assert np.array_equal(got, want)
    pos = [0, 5, 77, (1 << s) - 1]
    at = TQ.QuotientsAt(s, ts, gamma, 3).at_many(
        pos, cols[:, pos].astype(np.uint64))
    assert np.array_equal(at, want[pos].astype(np.uint64))


def test_quotient_blocks_split_by_role():
    s, cols, _rs, ts, gamma = quotient_case(np.random.default_rng(12))
    a = TQ.prep_args_full(ts, gamma, 0, 3)
    xs, ys = TQ.dev_committed_points(s, "cpu")
    args = (xs, ys, from_u32(a["consts"], "cpu"), from_u32(a["gcs"], "cpu"))
    one = TQ.accumulate_blocks([from_u32(cols, "cpu")], *args)
    split = TQ.accumulate_blocks([from_u32(cols[:1], "cpu"),
                                  from_u32(cols[1:], "cpu")], *args)
    assert np.array_equal(to_u32(one), to_u32(split))


def low_degree_inputs(rng, spec):
    out = {}
    for log_n in spec:
        s = log_n + 1
        out[s] = np.stack([committed_evals(
            rng.integers(0, P, 1 << log_n, dtype=np.uint32), s)
            for _ in range(4)], axis=-1)
    return out


def run_both(inputs, rcfg, tcfg, n_queries=8):
    """Prove with both packages; return (reference proof, port proof,
    port verification result, queries)."""
    rch, tch = RChannel(), TChannel()
    rstate = RF.fri_commit(dict(inputs), rch, rcfg)
    tstate = TF.fri_commit({s: from_u32(v, "cpu") for s, v in
                            inputs.items()}, tch, tcfg)
    assert tch.digest == rch.digest
    s0 = max(inputs)
    q = rch.draw_queries(n_queries, s0)
    assert tch.draw_queries(n_queries, s0) == q
    rproof = RF.fri_decommit(rstate, q)
    tproof = TF.fri_decommit(tstate, q)
    vch = TChannel()
    alphas = TF.fri_replay(tproof, vch, tcfg, list(inputs))
    vq = vch.draw_queries(n_queries, s0)
    inputs_at = {s: {i: v[i] for i in range(v.shape[0])}
                 for s, v in inputs.items()}
    ok = TF.fri_check_queries(tproof, alphas, vq, inputs_at, list(inputs),
                              tcfg)
    return rproof, tproof, ok, q


def assert_fri_equal(rp, tp):
    assert len(rp.inner_roots) == len(tp.inner_roots)
    for a, b in zip(rp.inner_roots, tp.inner_roots):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(rp.last_layer), tp.last_layer)
    for a, b in zip(rp.inner_decommitments, tp.inner_decommitments):
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a.column_values, b.column_values))
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a.sibling_hashes, b.sibling_hashes))


CASES = {
    "single": ([7], dict(log_last_layer=0)),
    "multi": ([8, 7, 5], dict(log_last_layer=0)),
    "last_layer_join": ([5, 1], dict(log_last_layer=0)),
    "arity1": ([8, 6], dict(log_last_layer=0, log_arity=1)),
    "arity4": ([8, 6], dict(log_last_layer=0, log_arity=4)),
    "last_layer3": ([8], dict(log_last_layer=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fri_matches_reference_and_verifies(case):
    spec, kw = CASES[case]
    inputs = low_degree_inputs(np.random.default_rng(7), spec)
    rp, tp, ok, _q = run_both(inputs, RF.FriConfig(log_blowup=1, **kw),
                              TF.FriConfig(log_blowup=1, **kw))
    assert_fri_equal(rp, tp)
    assert ok


def test_fri_rejects_tampered_query_and_last_layer():
    inputs = low_degree_inputs(np.random.default_rng(8), [7])
    cfg = TF.FriConfig(log_blowup=1, log_last_layer=0)
    _rp, tp, ok, q = run_both(inputs, RF.FriConfig(log_blowup=1,
                                                   log_last_layer=0), cfg)
    assert ok
    inputs_at = {s: {i: v[i] for i in range(v.shape[0])}
                 for s, v in inputs.items()}
    bad = dict(inputs_at[8])
    bad[q[0]] = np.array(bad[q[0]])
    bad[q[0]][0] = (bad[q[0]][0] + 1) % P
    alphas = TF.fri_replay(tp, TChannel(), cfg, [8])
    assert not TF.fri_check_queries(tp, alphas, q, {8: bad}, [8], cfg)
    tp.last_layer = np.array(tp.last_layer)
    tp.last_layer[0, 0] = (tp.last_layer[0, 0] + 1) % P
    vch = TChannel()
    alphas = TF.fri_replay(tp, vch, cfg, [8])
    assert not TF.fri_check_queries(tp, alphas, vch.draw_queries(8, 8),
                                    inputs_at, [8], cfg)


def test_fri_high_degree_rejected(monkeypatch):
    cfg = TF.FriConfig(log_blowup=1, log_last_layer=0)
    junk = np.random.default_rng(9).integers(0, P, (1 << 8, 4),
                                             dtype=np.uint32)
    with pytest.raises(AssertionError):
        TF.fri_commit({8: from_u32(junk, "cpu")}, TChannel(), cfg)
    monkeypatch.setenv("NZT_FRI_UNSAFE_TRUNCATE", "1")
    ch = TChannel()
    state = TF.fri_commit({8: from_u32(junk, "cpu")}, ch, cfg)
    q = ch.draw_queries(8, 8)
    proof = TF.fri_decommit(state, q)
    vch = TChannel()
    alphas = TF.fri_replay(proof, vch, cfg, [8])
    assert not TF.fri_check_queries(proof, alphas, vch.draw_queries(8, 8),
                                    {8: {i: junk[i] for i in range(256)}},
                                    [8], cfg)


def test_fold_schedule_matches_reference():
    for sizes in ([12, 10, 4], [9, 7], [23, 21, 5]):
        for arity in (1, 3):
            r = RF.fold_schedule(sizes, RF.FriConfig(log_arity=arity))
            t = TF.fold_schedule(sizes, TF.FriConfig(log_arity=arity))
            assert [(b.m, b.k, b.inj) for b in r] == \
                [(b.m, b.k, b.inj) for b in t]
