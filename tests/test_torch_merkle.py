"""Blake2s and Merkle trees of the PyTorch port against hashlib and the
JAX package: digests, roots and decommitments equal as uint32 (exact);
the verifier accepts honest openings and rejects a tamper."""

import hashlib

import numpy as np
import pytest

from nexus_zkvm_tpu.ops import blake2s as RB, merkle as RM
from nexus_zkvm_tpu_torch.ops import blake2s as TB, merkle as TM
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("W", [1, 4, 15, 16, 17, 33, 192])
def test_hash_rows_matches_hashlib_and_reference(W):
    msgs = RNG.integers(0, 1 << 32, (9, W), dtype=np.uint32)
    msgs[0] = 0xFFFFFFFF
    got = to_u32(TB.hash_rows(from_u32(msgs, "cpu")))
    want = np.stack([np.frombuffer(hashlib.blake2s(m.astype("<u4").tobytes())
                                   .digest(), "<u4") for m in msgs])
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(RB.batch_blake2s_words(msgs)))
    assert np.array_equal(TB.np_batch_blake2s_words(msgs), want)


def test_hash_rows_of_strided_view_and_parents():
    mat = RNG.integers(0, 1 << 31, (5, 16), dtype=np.uint32)
    leaves = to_u32(TB.hash_rows(from_u32(mat, "cpu").t()))
    assert np.array_equal(leaves, TB.np_batch_blake2s_words(mat.T))
    par = to_u32(TB.hash_parents(from_u32(leaves, "cpu")))
    assert np.array_equal(par, TB.np_batch_blake2s_words(
        leaves.reshape(8, 16)))


def _queries(depth, n=5):
    return sorted(set(RNG.integers(0, 1 << depth, n).tolist()))


def _dec_equal(a, b):
    return (len(a.column_values) == len(b.column_values)
            and all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(a.column_values, b.column_values))
            and len(a.sibling_hashes) == len(b.sibling_hashes)
            and all(np.array_equal(np.asarray(x), np.asarray(y))
                    for x, y in zip(a.sibling_hashes, b.sibling_hashes)))


@pytest.mark.parametrize("sizes", [[6] * 3, [6, 4, 6, 2, 0], [5, 5, 3]],
                         ids=["uniform", "mixed", "mixed2"])
def test_commit_and_decommit_match_reference(sizes):
    cols = [RNG.integers(0, 1 << 31, 1 << d, dtype=np.uint32) for d in sizes]
    rtree = RM.commit(cols)
    ttree = TM.commit([from_u32(c, "cpu") for c in cols])
    assert np.array_equal(ttree.root(), np.asarray(rtree.root()))
    for d in range(ttree.max_depth + 1):
        assert np.array_equal(to_u32(ttree.layers[d]),
                              np.asarray(rtree.layers[d]))
    q = _queries(max(sizes))
    tdec = TM.decommit(ttree, q)
    assert _dec_equal(tdec, RM.decommit(rtree, q))
    lengths = [1 << d for d in sizes]
    assert TM.verify_decommitment(ttree.root(), lengths, q, tdec)
    bad = TM.MerkleDecommitment(
        column_values=[np.array(v) for v in tdec.column_values],
        sibling_hashes=list(tdec.sibling_hashes))
    bad.column_values[-1][0] ^= 1
    assert not TM.verify_decommitment(ttree.root(), lengths, q, bad)


def test_channel_transcript_matches_reference():
    from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
    from nexus_zkvm_tpu_torch.channel import Blake2sChannel as TChannel
    r, t = RChannel(), TChannel()
    for ch in (r, t):
        ch.mix_u32s([1, 2, 0xFFFFFFFF])
        ch.mix_u64(1 << 40)
        ch.mix_felts(np.arange(8, dtype=np.uint32).reshape(2, 4))
    assert np.array_equal(t.draw_felts(3), r.draw_felts(3))
    assert t.draw_queries(20, 10) == r.draw_queries(20, 10)
    assert t.grind_pow(10) == r.grind_pow(10)
    assert t.digest == r.digest
    assert t.check_pow_nonce(10, 3) == r.check_pow_nonce(10, 3)


def test_finalize_many_matches_single():
    m1 = from_u32(RNG.integers(0, 1 << 31, (4, 64), dtype=np.uint32), "cpu")
    m2 = from_u32(RNG.integers(0, 1 << 31, (2, 16), dtype=np.uint32), "cpu")
    t1, t2 = TM.commit_matrix(m1), TM.commit_matrix(m2)
    q1, q2 = _queries(6), _queries(4)
    many = TM.finalize_decommitments(TM.decommit_many_fused(
        [(t1, q1), (t2, q2)]))
    assert _dec_equal(many[0], TM.decommit(t1, q1))
    assert _dec_equal(many[1], TM.decommit(t2, q2))
    assert TM.verify_decommitment(t2.root(), [16, 16], q2, many[1])
