"""The tile plan of csrc/brev_tile.cuh (kernels K10 and K11), emulated.

The CUDA kernels read a layout-order chunk (point m reads row brev(m))
through shared-memory tiles: a block owns the middle bits of m, copies
each column's runs of consecutive rows into its tile, and each thread
reads its point from the tile, transposed.  The emulation below walks
every block and thread of ``circle.brev_tile_plan`` with the header's
index math (`load`, `slot`, `point`), checks that every point is visited
once and reads its own row, that every load run is consecutive rows, and
then runs K11's fold and K10's absorb through it, pass by pass as the C
entry points launch them, against their plain versions.  The card tests
(`tests/test_torch_cuda.py`) hold the kernels themselves to the same
plain versions.
"""

import numpy as np
import pytest
import torch

from nexus_zkvm_tpu_torch.ops import blake2s, quotients
from nexus_zkvm_tpu_torch.ops.circle import (TILE_LOG, bit_reverse_indices,
                                             brev_tile_plan)
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

P = (1 << 31) - 1
THREADS = 1 << 2 * TILE_LOG        # NZT_TILE_THREADS: a thread a point
COL_WORDS = THREADS                # NZT_TILE_COL_WORDS
TILE_COLS = 16                     # NZT_TILE_COLS


def rev(x, bits: int):
    """brev_tile::rev: the low ``bits`` bits of x reversed, 0 for none."""
    x = np.asarray(x, np.int64)
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> i) & 1) << (bits - 1 - i)
    return out


def slot(a, j, t: int):
    return (a << t) | (j ^ ((a >> 1) & ((1 << t) - 1)))


def emulate_tiles(cols: np.ndarray, t: int, blocks: int, brev: bool):
    """The (nk, M) values every point reads through the tiles of plan
    (t, blocks): all blocks at once, each with the header's `load` (runs
    into `slot`s) and `point` (transposed reads); checks the runs, the
    slots and that every point is read exactly once."""
    nk, M = cols.shape
    log_m = M.bit_length() - 1
    T = 1 << t
    assert t <= TILE_LOG and blocks == 1 << (log_m - 2 * t) and nk <= TILE_COLS
    mid = np.arange(blocks, dtype=np.int64)[:, None]
    # load: word w of the block's copy loop
    w = np.arange(nk << 2 * t, dtype=np.int64)[None, :]
    k, a, j = w >> 2 * t, (w >> t) & (T - 1), w & (T - 1)
    mid_row = (rev(mid, log_m - 2 * t) if brev else mid) << t
    rows = (a << (log_m - t)) + mid_row + j
    runs = rows.reshape(blocks, nk, T, T)
    assert (np.diff(runs, axis=-1) == 1).all()        # runs of T rows
    dst = k * COL_WORDS + slot(a, j, t)
    assert dst.max() < TILE_COLS * COL_WORDS
    assert len(np.unique(dst)) == dst.shape[1]          # one word a slot
    tile = np.full((blocks, TILE_COLS * COL_WORDS), -1, np.int64)
    np.put_along_axis(tile, np.broadcast_to(dst, rows.shape),
                      cols[np.broadcast_to(k, rows.shape), rows], axis=1)
    # point: one a thread, threads past 2^2t idle
    q = np.arange(THREADS, dtype=np.int64)
    q = q[q < 1 << 2 * t][None, :]
    lo, hi = q & (T - 1), q >> t
    word = (slot(rev(lo, t), rev(hi, t), t) if brev else slot(hi, lo, t))
    m = (hi << (log_m - t)) | (mid << t) | lo
    assert np.array_equal(np.sort(m.ravel()), np.arange(M))  # once each
    out = np.full((nk, M), -1, np.int64)
    for kk in range(nk):
        out[kk, m] = np.take_along_axis(
            tile, np.broadcast_to(kk * COL_WORDS + word, m.shape), axis=1)
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("t_max", range(TILE_LOG + 1))
@pytest.mark.parametrize("log_m", range(15))
def test_plan_visits_every_point_once_at_its_row(log_m, t_max):
    """Every block and thread of the plan at 2^0..2^14 rows, at the
    card's tile (t_max = TILE_LOG) and smaller ones: each point is read
    once, from row brev(m) (row m in committed order), every load run is
    2^t consecutive rows."""
    t, blocks = brev_tile_plan(log_m, t_max)
    assert t == min(t_max, log_m // 2) and blocks << 2 * t == 1 << log_m
    rng = np.random.default_rng(log_m)
    nk = 1 + log_m % TILE_COLS
    cols = rng.integers(0, P, (nk, 1 << log_m)).astype(np.int64)
    perm = bit_reverse_indices(log_m)
    for brev in (True, False):
        got = emulate_tiles(cols, t, blocks, brev)
        assert np.array_equal(got, cols[:, perm] if brev else cols)


def test_card_plan():
    """The card's tiles: 16 x 16 points (one a thread of 256), runs of
    16 words, smaller tiles only below 2^8 rows."""
    assert TILE_LOG == 4
    assert [brev_tile_plan(n)[0] for n in range(12)] == \
        [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4]
    assert brev_tile_plan(23) == (4, 1 << 15)


def k11_emulated(acc, block, gcs, brev: bool, t_max: int):
    """nzt_quotient_colsums through the emulated tiles: one pass a 16
    columns; products summed with one multiply-add each in uint64, folded
    after every 4 columns (checked never to wrap), reduced once a pass."""
    S, M, _ = acc.shape
    c = block.shape[0]
    t, blocks = brev_tile_plan(M.bit_length() - 1, t_max)
    acc = acc.astype(np.uint64)
    for k0 in range(0, c, TILE_COLS):
        nk = min(TILE_COLS, c - k0)
        vals = emulate_tiles(block[k0:k0 + nk].astype(np.int64), t, blocks,
                             brev).astype(np.uint64)
        g = gcs[:, k0:k0 + nk].astype(np.uint64)
        sums = np.zeros((S, M, 4), np.uint64)
        for k in range(nk):
            for s in range(S):
                if not g[s, k].any():
                    continue
                prod = g[s, k][None, :] * vals[k][:, None]
                assert (sums[s] <= np.uint64(2**64 - 1) - prod).all()
                sums[s] += prod
            if k & 3 == 3:
                sums = (sums & np.uint64(P)) + (sums >> np.uint64(31))
        assert (sums <= np.uint64(2**64 - 1) - acc).all()
        acc = (sums + acc) % np.uint64(P)
    return acc.astype(np.uint32)


WIDTHS = [1, 4, 15, 16, 17]


@pytest.mark.parametrize("brev", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("log_m,t_max", [(0, TILE_LOG), (1, TILE_LOG),
                                         (7, TILE_LOG), (9, TILE_LOG),
                                         (12, TILE_LOG), (9, 2)])
def test_k11_through_the_tiles_equals_plain(log_m, t_max, width, brev):
    """K11's fold of a ragged chunk through the emulated tiles, seeded
    inputs with some zero coefficients (and words at p - 1, the largest
    products), equals `colsum_fold_plain`."""
    S = 3
    rng = np.random.default_rng(100 * log_m + width)
    M = 1 << log_m
    acc = rng.integers(0, P, (S, M, 4), dtype=np.uint32)
    block = rng.integers(0, P, (width, M), dtype=np.uint32)
    block[:, ::3] = P - 1
    gcs = rng.integers(0, P, (S, width, 4), dtype=np.uint32)
    gcs[0] = P - 1
    gcs[1, ::3] = 0
    got = k11_emulated(acc, block, gcs, brev, t_max)
    want = quotients.colsum_fold_plain(from_u32(acc, "cpu"),
                                       from_u32(block, "cpu"),
                                       from_u32(gcs, "cpu"), brev)
    assert np.array_equal(got, to_u32(want))


def k10_emulated(state, chunk, done: int, total: int, last: bool,
                 t_max: int):
    """nzt_blake2s_leaves_stream through the emulated tiles: one pass a
    16-word block, the byte counter 4 (done + 16 (b + 1)), or 4 total
    with the final flag on the last block of the last chunk."""
    c, M = chunk.shape
    t, blocks = brev_tile_plan(M.bit_length() - 1, t_max)
    h = (np.broadcast_to(blake2s.initial_state(), (M, 8)).copy()
         if state is None else state.copy())
    nb = -(-c // 16) if last else c // 16
    for b in range(nb):
        nk = min(16, c - 16 * b)
        msg = np.zeros((M, 16), np.uint32)
        msg[:, :nk] = emulate_tiles(chunk[16 * b:16 * b + nk]
                                    .astype(np.int64), t, blocks, True).T
        fin = last and b == nb - 1
        h = blake2s.np_batch_compress(
            h, msg, 4 * total if fin else 4 * (done + 16 * (b + 1)), fin)
    return h


@pytest.mark.parametrize("width", WIDTHS + [32])
@pytest.mark.parametrize("log_m,t_max", [(0, TILE_LOG), (1, TILE_LOG),
                                         (7, TILE_LOG), (9, TILE_LOG),
                                         (12, TILE_LOG), (9, 2)])
def test_k10_through_the_tiles_equals_plain(log_m, t_max, width):
    """K10's absorb through the emulated tiles, chunk by chunk: a chunk
    of ``width`` columns alone (first and last), after a 16-column chunk
    (last) and, for a multiple of 16, before one; every state equals
    `leaves_stream_plain`'s."""
    splits = [[width], [16, width]] + ([[width, 16]] if width % 16 == 0
                                      else [])
    for split in splits:
        C = sum(split)
        rng = np.random.default_rng(C + log_m)
        mat = rng.integers(0, P, (C, 1 << log_m), dtype=np.uint32)
        got = want = None
        done = 0
        for c in split:
            last = done + c == C
            got = k10_emulated(got, mat[done:done + c], done, C, last, t_max)
            want = blake2s.leaves_stream_plain(
                want, from_u32(mat[done:done + c], "cpu"), done, C, last)
            assert np.array_equal(got, to_u32(want)), (split, done)
            done += c
