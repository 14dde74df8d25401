"""K9's work partition and index math, emulated.

K9 (csrc/gather.cu) gathers a proof's openings: `merkle.gather_plan`
packs a descriptor a piece, a unit table (a unit is at most GATHER_UNIT
output words of one piece, one block each) and the indices into one
int64 array.  A block stages its unit's indices (s_idx[j] = idx[(p0 + j)
mod n] for the pairs p = r * n + i its words belong to), splits p by
the piece's magic multiplier, (p * magic) >> shift, and reads
src[r * rs + idx * is + t * ts]; a digest piece the host marks 16-byte
aligned reads half-rows of 4 words.  The emulation below walks every
unit, thread and load with that math, from the descriptors' addresses
into the sources' storage, checks that every output word is written
once, that every 16-byte read is aligned and that the quotient is
exact, and is held to `gather_openings_plain` and, through
`finalize_decommitments`, to the JAX package's `decommit_many_fused`.
The card tests (`tests/test_torch_cuda.py`) hold the kernel to the
same plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from nexus_zkvm_tpu.ops import merkle as RM
from nexus_zkvm_tpu_torch.ops import merkle as TM
from nexus_zkvm_tpu_torch.ops.merkle import (GATHER_FIELDS, GATHER_UNIT,
                                             _Gather, _pieces, gather_magic,
                                             gather_openings_plain,
                                             gather_plan)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

THREADS = 256                    # kThreads of csrc/gather.cu
D = {name: i for i, name in enumerate(GATHER_FIELDS)}


def _u32(rng, shape):
    return rng.integers(0, 1 << 31, shape, dtype=np.uint32)


def _storage_words(t: torch.Tensor):
    """(uint32 view of t's whole storage, the storage's address)."""
    base = torch.empty(0, dtype=torch.int32).set_(t.untyped_storage())
    return base.numpy().view(np.uint32), t.untyped_storage().data_ptr()


def emulate(pieces, unit: int = GATHER_UNIT,
            threads: int = THREADS) -> np.ndarray:
    """K9 on `gather_plan`'s tables, unit by unit and thread by thread,
    for a kernel of ``threads`` threads and ``unit`` words a block (the
    card's 256 and GATHER_UNIT; smaller ones split small pieces)."""
    per = unit // threads
    assert per * threads == unit and per % 4 == 0
    packed, G, U, words = gather_plan(pieces, unit)
    table = packed[:G * len(D)].reshape(G, len(D))
    units = packed[G * len(D):G * len(D) + U]
    idx = packed[G * len(D) + U:]
    out = np.zeros(words, np.uint32)
    writes = np.zeros(words, np.int64)
    for u in units.tolist():
        g, start = u >> 32, u & 0xFFFFFFFF
        d = {k: int(table[g, i]) for k, i in D.items()}
        flat, base = _storage_words(pieces[g].src)
        assert (d["src"] - base) % 4 == 0
        src0 = (d["src"] - base) // 4
        n, wlog = d["n"], d["wlog"]
        end = min(start + unit, (d["rows"] * n) << wlog)
        assert start % unit == 0 and start < end
        p0 = start >> wlog
        npairs = ((end - 1) >> wlog) - p0 + 1
        assert npairs <= unit
        p = p0 + np.arange(npairs, dtype=np.uint64)

        def quot(p):
            q = (p.astype(np.uint64) * np.uint64(d["magic"])) >> \
                np.uint64(d["shift"])
            assert np.array_equal(q, p.astype(np.uint64) // np.uint64(n))
            return q.astype(np.int64)
        s_idx = idx[d["idx"] + (p.astype(np.int64) - quot(p) * n)]
        tid = np.arange(threads)[:, None]
        if d["vec"]:
            assert wlog == 3 and d["ts"] == 1
            e = start + 4 * (tid + threads * np.arange(per // 4)[None, :])
            e = e[e < end]
            pe = e >> 3
            r = quot(pe)
            assert (r < d["rows"]).all()
            at = src0 + r * d["rs"] + s_idx[pe - p0] * d["is"] + (e & 7)
            assert ((base + 4 * at) % 16 == 0).all()
            for h in range(4):
                out[d["out"] + e + h] = flat[at + h]
                np.add.at(writes, d["out"] + e + h, 1)
        else:
            e = start + tid + threads * np.arange(per)[None, :]
            e = e[e < end]
            pe = e >> wlog
            r = quot(pe)
            assert (r < d["rows"]).all()
            at = (src0 + r * d["rs"] + s_idx[pe - p0] * d["is"]
                  + (e & ((1 << wlog) - 1)) * d["ts"])
            out[d["out"] + e] = flat[at]
            np.add.at(writes, d["out"] + e, 1)
    assert (writes == 1).all()
    return out


def _plain(pieces) -> np.ndarray:
    return to_u32(gather_openings_plain(pieces))


def _opening_pieces(items):
    pieces = []
    for item in items:
        vals, sibs = _pieces(*item)
        pieces += vals + sibs
    return pieces


def _cases():
    rng = np.random.default_rng(41)
    U = GATHER_UNIT
    mat = from_u32(_u32(rng, (3781, 64)), "cpu")
    wide = [_Gather(mat, np.sort(rng.choice(64, 50, replace=False)), 1)]
    tree = TM.commit_matrix(from_u32(_u32(rng, (3, 1 << 9)), "cpu"))
    q = sorted(set(rng.integers(0, 1 << 9, 20).tolist()))
    digests = _pieces(tree, q)[1]
    fri = TM.commit_matrix(from_u32(_u32(rng, (64, 4)), "cpu").t())
    transposed = _opening_pieces([(fri, [1, 6, 9, 40, 63])])
    mixed = TM.commit([from_u32(_u32(rng, 1 << d), "cpu")
                       for d in (8, 6, 8, 3, 0)])
    mixed_pieces = _opening_pieces([(mixed, [0, 5, 77, 200, 255])])
    # value pieces of U, U + 1 and U - 1 words; digest pieces of U words
    # (at an odd output offset) and of U + 8 (at a multiple of 4)
    cols = from_u32(_u32(rng, (U + 1, 16)), "cpu")
    layer = from_u32(_u32(rng, (U // 4, 8)), "cpu")
    sizes = [_Gather(cols[:U], np.array([5]), 1),
             _Gather(cols, np.array([0]), 1),
             _Gather(layer, np.arange(U // 8), 8),
             _Gather(cols[:U - 1], np.array([3]), 1),
             _Gather(layer, np.arange(U // 8 + 1), 8)]
    # a digest layer at an odd word offset (not 16-byte aligned)
    odd = from_u32(_u32(rng, (8 * 40 + 1,)), "cpu")[1:].view(40, 8)
    unaligned = [_Gather(odd, np.array([0, 3, 39]), 8)]
    return {"wide_small": wide, "digest_layers": digests,
            "transposed": transposed, "mixed_tree": mixed_pieces,
            "unit_edges": sizes, "unaligned_digests": unaligned,
            "all": wide + digests + transposed + mixed_pieces + sizes
            + unaligned}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_equals_plain(case):
    pieces = CASES[case]
    assert np.array_equal(emulate(pieces), _plain(pieces))


@pytest.mark.parametrize("unit,threads", [(8, 2), (64, 8), (2048, 256),
                                          (4096, 256)])
def test_emulated_kernel_equals_plain_at_other_units(unit, threads):
    pieces = CASES["all"]
    assert np.array_equal(emulate(pieces, unit, threads), _plain(pieces))


def test_plan_units_and_flags():
    """Every piece gets ceil(words / U) units, a piece smaller than a
    unit one; the wide-small piece spreads over many; only aligned
    digest pieces take the 16-byte path."""
    pieces = CASES["all"]
    packed, G, U, words = gather_plan(pieces)
    table = packed[:G * len(D)].reshape(G, len(D))
    units = packed[G * len(D):G * len(D) + U]
    per = np.bincount(units >> 32, minlength=G)
    assert per.tolist() == [-(-p.words // GATHER_UNIT) for p in pieces]
    assert per[0] == -(-3781 * 50 // GATHER_UNIT) == 185
    assert words == sum(p.words for p in pieces)
    vec = table[:, D["vec"]].astype(bool)
    assert vec.tolist() == [p.width == 8 and p.src.data_ptr() % 16 == 0
                            for p in pieces]
    assert vec.any() and not vec[-1]


def test_tables_equal_the_list_built_tables():
    """The packed descriptors hold what the list-built tables held: the
    same source, offsets, n, width, rows and strides, the same indices."""
    pieces = CASES["all"]
    desc, idx, off = [], [], 0
    for p in pieces:
        if p.width == 1:
            rs, is_, ts = p.src.stride(0), p.src.stride(1), 0
        else:
            rs, is_, ts = 0, p.src.stride(0), p.src.stride(1)
        desc.append([p.src.data_ptr(), off, len(idx), len(p.idx), p.width,
                     p.rows, rs, is_, ts])
        idx += p.idx.tolist()
        off += p.words
    packed, G, U, words = gather_plan(pieces)
    table = packed[:G * len(D)].reshape(G, len(D))
    got = np.stack([table[:, D[k]] for k in ("src", "out", "idx", "n")]
                   + [1 << table[:, D["wlog"]]]
                   + [table[:, D[k]] for k in ("rows", "rs", "is", "ts")],
                   axis=1)
    assert np.array_equal(got, np.array(desc, np.int64))
    assert np.array_equal(packed[G * len(D) + U:], np.array(idx, np.int64))
    assert words == off


@pytest.mark.parametrize("n", [1, 2, 3, 7, 50, 255, 256, 257, 3781,
                               (1 << 20) + 1, (1 << 30) - 1, 1 << 30,
                               (1 << 30) + 1, (1 << 31) - 1, 1 << 31])
def test_magic_quotient_is_exact(n):
    magic, shift = (int(x) for x in gather_magic(n))
    assert 0 < magic < 1 << 32
    rng = np.random.default_rng(n)
    ps = {0, 1, n - 1, n, n + 1, 2 * n - 1, 2 * n, (1 << 31) - 1,
          (1 << 31) - 2, *rng.integers(0, 1 << 31, 200).tolist()}
    for p in ps:
        if 0 <= p < 1 << 31:
            assert (p * magic) >> shift == p // n, (p, n)


def test_plan_raises_at_2_31_words():
    src = torch.zeros((1, 1 << 16), dtype=torch.int32)
    idx = np.arange(1 << 16, dtype=np.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        gather_plan([_Gather(src.expand(1 << 15, 1 << 16), idx, 1)])
    _p, _g, units, words = gather_plan(
        [_Gather(src.expand((1 << 15) - 1, 1 << 16), idx, 1)])
    assert words == (1 << 31) - (1 << 16) and units == words // GATHER_UNIT


def test_plan_raises_on_what_the_kernel_does_not_take():
    src = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="widths"):
        gather_plan([_Gather(src, np.array([1]), 3)])
    with pytest.raises(ValueError, match="outside"):
        gather_plan([_Gather(src, np.array([8]), 1)])
    with pytest.raises(ValueError, match="outside"):
        gather_plan([_Gather(src, np.array([-1]), 1)])


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.tuples(st.sampled_from(["values", "transposed", "digests",
                                           "column"]),
                          st.integers(1, 40), st.integers(0, 7),
                          st.integers(1, 30), st.integers(0, 1 << 30)),
                min_size=1, max_size=6),
       st.sampled_from([(8, 2), (64, 8), (GATHER_UNIT, THREADS)]))
def test_emulated_kernel_equals_plain_on_drawn_pieces(specs, shape):
    pieces = []
    for kind, rows, log_n, n, seed in specs:
        rng = np.random.default_rng(seed)
        N = 1 << log_n
        idx = np.sort(rng.integers(0, N, min(n, N)))
        if kind == "values":
            src = from_u32(_u32(rng, (rows, N)), "cpu")
        elif kind == "transposed":
            src = from_u32(_u32(rng, (N, rows)), "cpu").t()
        elif kind == "column":
            src = from_u32(_u32(rng, N + 1), "cpu")[seed % 2:][:N][None, :]
        else:
            flat = from_u32(_u32(rng, 8 * N + 1), "cpu")
            src = flat[seed % 2:][:8 * N].view(N, 8)
        pieces.append(_Gather(src, idx, 8 if kind == "digests" else 1))
    assert np.array_equal(emulate(pieces, *shape), _plain(pieces))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_gather_columns_on_the_cpu(as_tensor):
    rng = np.random.default_rng(3)
    src = from_u32(_u32(rng, (16, 256)), "cpu")
    idx = [255, 3, 17, 17, 128]
    got = TM.gather_columns(src, torch.tensor(idx) if as_tensor else idx)
    assert torch.equal(got, src[:, idx])


def test_decommit_wide_small_tree_matches_reference():
    """A tree of many columns at few rows (nearly every position opened)
    beside a narrow one: the port's decommitments and the emulated
    kernel's buffer, finalized, equal the JAX package's."""
    rng = np.random.default_rng(17)
    mats = [_u32(rng, (616, 64)), _u32(rng, (3, 256))]
    ttrees = [TM.commit_matrix(from_u32(m, "cpu")) for m in mats]
    rtrees = [RM.commit_matrix(jnp.asarray(m)) for m in mats]
    qs = [sorted(set(rng.integers(0, 64, 50).tolist())),
          sorted(set(rng.integers(0, 256, 9).tolist()))]
    items = list(zip(ttrees, qs))
    want = RM.finalize_decommitments(RM.decommit_many_fused(
        list(zip(rtrees, qs)), pad_q=64))
    pending = TM.decommit_many_fused(items)
    emulated = TM.PendingOpenings(
        from_u32(emulate(_opening_pieces(items)), "cpu"), pending.layout)
    for got in (TM.finalize_decommitments(pending),
                TM.finalize_decommitments(emulated)):
        for g, w in zip(got, want):
            assert len(g.column_values) == len(w.column_values)
            assert all(np.array_equal(np.asarray(a, np.uint32),
                                      np.asarray(b, np.uint32))
                       for a, b in zip(g.column_values, w.column_values))
            assert np.array_equal(np.asarray(g.sibling_hashes, np.uint32),
                                  np.asarray(w.sibling_hashes, np.uint32))
    for t, q, g in zip(ttrees, qs, got):
        n = int(t.matrix.shape[1])
        assert TM.verify_decommitment(t.root(), [n] * int(t.matrix.shape[0]),
                                      q, g)
