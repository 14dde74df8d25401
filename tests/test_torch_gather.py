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

import dataclasses
import re
from pathlib import Path

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
import torch_cpu  # noqa: F401  (one torch thread a test process)

THREADS = 256                    # kThreads of csrc/gather.cu
D = {name: i for i, name in enumerate(GATHER_FIELDS)}


def _u32(rng, shape):
    return rng.integers(0, 1 << 31, shape, dtype=np.uint32)


def _storage_words(t: torch.Tensor):
    """(uint32 view of t's whole storage, the storage's address)."""
    base = torch.empty(0, dtype=torch.int32).set_(t.untyped_storage())
    return base.numpy().view(np.uint32), t.untyped_storage().data_ptr()


def emulate(pieces, unit: int = GATHER_UNIT, threads: int = THREADS,
            words: int | None = None, read: bool = True) -> np.ndarray:
    """K9 on `gather_plan`'s tables, unit by unit and thread by thread,
    for a kernel of ``threads`` threads and ``unit`` words a block (the
    card's 256 and GATHER_UNIT; smaller ones split small pieces), into
    a zeroed buffer of ``words`` words (by default up to the last
    piece's end), each piece at its ``out``: each word written at most
    once, and every piece's words written.  Without ``read`` (sources
    with no storage, such as meta tensors) it returns, for each output
    word, the source word the kernel reads, counted from the source's
    start."""
    per = unit // threads
    assert per * threads == unit and per % 4 == 0
    packed, G, U, words = gather_plan(pieces, unit, words)
    table = packed[:G * len(D)].reshape(G, len(D))
    units = packed[G * len(D):G * len(D) + U]
    idx = packed[G * len(D) + U:]
    out = np.zeros(words, np.uint32)
    writes = np.zeros(words, np.int64)
    reads = np.full(words, -1, np.int64)
    for u in units.tolist():
        g, start = u >> 32, u & 0xFFFFFFFF
        d = {k: int(table[g, i]) for k, i in D.items()}
        flat, base = (_storage_words(pieces[g].src) if read else
                      (None, d["src"]))
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
            if not read:
                reads[d["out"] + e] = at
                np.add.at(writes, d["out"] + e, 1)
                continue
            out[d["out"] + e] = flat[at]
            np.add.at(writes, d["out"] + e, 1)
    assert (writes <= 1).all() and writes.sum() == sum(
        p.words for p in pieces)
    return out if read else reads


def _plain(pieces, words=None) -> np.ndarray:
    return to_u32(gather_openings_plain(pieces, words))


def _opening_pieces(items):
    pieces = []
    for item in items:
        vals, sibs = _pieces(*item)
        pieces += vals + sibs
    TM.place(pieces)
    return pieces


def _placed(pieces):
    """Copies of ``pieces`` placed one after another from word 0."""
    out = [dataclasses.replace(p) for p in pieces]
    TM.place(out)
    return out


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
    return {name: _placed(ps) for name, ps in (
        ("wide_small", wide), ("digest_layers", digests),
        ("transposed", transposed), ("mixed_tree", mixed_pieces),
        ("unit_edges", sizes), ("unaligned_digests", unaligned),
        ("all", wide + digests + transposed + mixed_pieces + sizes
         + unaligned))}


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


@pytest.mark.parametrize("rows,log_n", [(193, 24), (244, 24), (438, 25),
                                        (772, 23), (976, 23), (1952, 23)])
def test_emulated_addresses_at_the_largest_trees(rows, log_n):
    """The opened values of the largest resident trees (the main and
    interaction trees of a 2^23-row trace; 438 columns of 2^25 points
    past it; segmented, the main and interaction trees of four 2^22-row
    CPU components and the interaction tree of eight, held whole when
    nothing streams) at a proof's 108 positions: every source word the kernel
    reads is the value's own, past 2^31 words (and 2^32 at 438 x 2^25)
    into the source, so its offsets are 64-bit (csrc/gather.cu)."""
    src = torch.empty((rows, 1 << log_n), dtype=torch.int32, device="meta")
    rng = np.random.default_rng(rows + log_n)
    idx = np.sort(rng.choice(1 << log_n, 108, replace=False)).astype(np.int64)
    got = emulate([_Gather(src, idx, 1)], read=False)
    want = (np.arange(rows, dtype=np.int64)[:, None] << log_n) + idx[None, :]
    assert np.array_equal(got, want.reshape(-1))
    assert got.max() >= 1 << 31
    text = (Path(TM.__file__).parents[1] / "csrc" / "gather.cu").read_text()
    assert len(re.findall(r"d\.src \+ \(long long\)quot\(p, d\) \* d\.rs \+"
                          r"\s+\(long long\)s_idx\[p - p0\] \* d\.is", text)) == 2


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
    TM.place(pieces)
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


def test_emulated_kernel_at_explicit_offsets_equals_plain():
    """Pieces placed at their own offsets of a larger buffer (as a mesh
    rank places its part of every opening), in reverse order with gaps
    of 1..7 words: every piece lands at its place, each word written
    once, the gaps stay zero."""
    pieces, off = [], 3
    for p in reversed(CASES["all"]):
        pieces.append(dataclasses.replace(p, out=off))
        off += p.words + 1 + off % 7
    got = emulate(pieces, words=off + 5)
    assert np.array_equal(got, _plain(pieces, off + 5))
    covered = np.zeros(off + 5, bool)
    for p in pieces:
        covered[p.out:p.out + p.words] = True
        assert np.array_equal(got[p.out:p.out + p.words],
                              to_u32(p.plain().reshape(-1)))
    assert not got[~covered].any()
    end = max(p.out + p.words for p in pieces)
    with pytest.raises(ValueError, match="outside the buffer"):
        gather_plan(pieces, words=end - 1)


def rank_tree(tree, D: int, r: int):
    """Rank r's part of a uniform tree on a mesh of D ranks, as
    `parallel.commit.commit_window` leaves it: the window of leaves and
    of every layer below the top log2 D, the top whole."""
    top = D.bit_length() - 1
    w = (1 << tree.max_depth) // D
    lo, hi = r * w, (r + 1) * w
    layers = [x if d <= top else
              x[lo >> (tree.max_depth - d):hi >> (tree.max_depth - d)]
              for d, x in enumerate(tree.layers)]
    return TM.MerkleTree(layers=layers, columns=[],
                         matrix=tree.matrix[:, lo:hi].contiguous(),
                         window=(lo, hi), top=top)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_mesh_pieces_of_the_ranks_sum_to_the_whole_opening(D):
    """Each rank's pieces of a windowed tree's openings (the values and
    below-top siblings of its positions, rank 0 the top's siblings and
    a whole tree's words), gathered at their offsets: the sum over the
    ranks is the single process's buffer, word for word, and every
    rank computes the same layout."""
    rng = np.random.default_rng(D)
    tree = TM.commit_matrix(from_u32(_u32(rng, (3, 1 << 9)), "cpu"))
    fri = TM.commit_matrix(from_u32(_u32(rng, (1 << 8, 4)), "cpu").t())
    small = TM.commit_matrix(from_u32(_u32(rng, (2, 1 << 4)), "cpu"))
    items = [(tree, sorted(set(rng.integers(0, 1 << 9, 30).tolist()))),
             (small, [0, 3, 9]),
             (fri, sorted(set(rng.integers(0, 1 << 8, 12).tolist())))]
    whole = _plain(_opening_pieces(items))
    total, layouts = np.zeros_like(whole), []
    for r in range(D):
        base, mine, layout = 0, [], []
        for t, q in items:
            part = t if t is small else rank_tree(t, D, r)
            vals, sibs, got, n = TM._mesh_pieces(part, q, r, base)
            mine += got
            layout.append((vals, sibs))
            base += n
        assert base == len(whole)
        layouts.append(layout)
        if mine:
            total += emulate(mine, words=base)
            assert np.array_equal(emulate(mine, words=base),
                                  _plain(mine, base))
    assert np.array_equal(total, whole)
    want = [([p.shape() for p in v], [p.shape() for p in s])
            for v, s in (_pieces(t, q) for t, q in items)]
    assert all(lay == want for lay in layouts)
