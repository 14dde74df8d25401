"""Circle FFT of the PyTorch port against the JAX package.

interpolate / evaluate / lde on a batch of C = 3 rows for n = 1..12 and
at n = 15, where the JAX package switches to its transposed small-half
stages; outputs must be equal as uint32 (exact).
"""

from pathlib import Path

import numpy as np
import pytest

from nexus_zkvm_tpu.ops import cfft as RC
from nexus_zkvm_tpu_torch.ops import cfft as TC
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
import torch_cpu  # noqa: F401  (one torch thread a test process)

P = (1 << 31) - 1


def rows(n, seed):
    return np.random.default_rng(seed).integers(0, P, (3, 1 << n),
                                                dtype=np.uint32)


@pytest.mark.parametrize("n", list(range(1, 13)) + [15])
def test_interpolate_evaluate_lde(n):
    x = rows(n, n)
    got_c = to_u32(TC.interpolate(from_u32(x, "cpu")))
    assert np.array_equal(got_c, np.asarray(RC.interpolate(x)))
    got_e = to_u32(TC.evaluate(from_u32(x, "cpu")))
    assert np.array_equal(got_e, np.asarray(RC.evaluate(x)))
    got_l = to_u32(TC.lde(from_u32(x, "cpu"), 1))
    assert np.array_equal(got_l, np.asarray(RC.lde(x, 1)))
    # the round trip holds on the port alone
    back = to_u32(TC.interpolate(from_u32(got_e, "cpu")))
    assert np.array_equal(back, x)


def test_extend_coeffs_matches():
    c = rows(4, 99)
    got = to_u32(TC.extend_coeffs(from_u32(c, "cpu"), 7))
    assert np.array_equal(got, np.asarray(RC.extend_coeffs(c, 7)))


def test_twiddle_table_layout():
    from nexus_zkvm_tpu_torch.ops.circle import domain
    d = domain(5)
    tw = to_u32(TC.twiddle_table(5, True, "cpu"))
    assert len(tw) == 31
    assert np.array_equal(tw[:16], d.inv_y_twiddles)
    for j in range(2, 6):
        off = TC._stage_off(5, j)
        assert np.array_equal(tw[off: off + (32 >> j)],
                              d.inv_x_twiddle_stages[j - 2])


@pytest.mark.parametrize("k,b", [(k, b) for k in (3, 8, 11)
                                 for b in (1, 2, 3)])
def test_evaluate_extending(k, b):
    """The LDE's evaluate(x, k + b), which the card's kernel computes from
    the compact coefficients, against the JAX package's."""
    x = rows(k, 100 * k + b)
    got = to_u32(TC.evaluate(from_u32(x, "cpu"), k + b))
    assert np.array_equal(got, np.asarray(RC.evaluate(x, k + b)))


# -- the pass plan of csrc/cfft.cu --------------------------------------------

def emulate_plan(x, k, n, inverse, T, logw):
    """csrc/cfft.cu's passes for `_pass_plan(k, n, inverse, T, logw)`, tile
    by tile with the kernel's index math (tile base, positions, twiddle
    index, compact read, 1/N on the last store), in numpy int64."""
    tw = to_u32(TC.twiddle_table(n, inverse, "cpu")).astype(np.int64)
    out = np.zeros((x.shape[0], 1 << n), np.int64)
    plan = TC._pass_plan(k, n, inverse, T, logw)
    for i, (lo, hi, wb, s0) in enumerate(plan):
        src, log_src = (x.astype(np.int64), k) if i == 0 else (out, n)
        S = wb + hi - lo
        assert S <= T and lo <= s0 < hi and wb <= lo
        q = np.arange(1 << S)
        tile = np.arange(1 << (lo - wb + n - hi))
        nhigh = n - hi
        base = ((tile & ((1 << nhigh) - 1)) << hi) | ((tile >> nhigh) << wb)
        lowbase = base & ((1 << lo) - 1)
        wmask = (1 << wb) - 1
        pos = base[:, None] | (q & wmask) | ((q >> wb) << lo)
        # the tiles partition the row: a pass may run in place
        assert np.array_equal(np.sort(pos.ravel()), np.arange(1 << n))
        v = src[:, pos >> (n - log_src)]
        lbs = range(wb + s0 - lo, S)
        for lb in (reversed(lbs) if inverse else lbs):
            b = lo + lb - wb
            qa = q[(q >> lb) & 1 == 0]
            qc = qa | (1 << lb)
            prel = lowbase[:, None] | (qa & wmask) | ((qa >> wb) << lo)
            t = tw[(1 << n) - (2 << b) + (prel & ((1 << b) - 1))]
            a, c = v[:, :, qa], v[:, :, qc]
            if inverse:
                v[:, :, qa], v[:, :, qc] = (a + c) % P, (a - c) * t % P
            else:
                tc = t * c % P
                v[:, :, qa], v[:, :, qc] = (a + tc) % P, (a - tc) % P
        if inverse and i == len(plan) - 1:
            v = v * pow(1 << n, P - 2, P) % P
        out[:, pos] = v
    stages = sorted(b for _lo, hi, _wb, s0 in plan for b in range(s0, hi))
    assert stages == list(range(n - k, n))
    return out.astype(np.uint32)


@pytest.mark.parametrize("T,logw", [(3, 0), (3, 1), (4, 2)])
@pytest.mark.parametrize("n", range(1, 13))
def test_pass_plan_emulated(T, logw, n):
    """Every pass plan at a small T (1 to 6 passes for n = 1..12), run
    through the emulation, equals the plain transforms: the inverse, the
    forward, and the forward LDE from 2^(n - e) coefficients."""
    x = rows(n, 7 * n + T)
    xt = from_u32(x, "cpu")
    got = emulate_plan(x, n, n, True, T, logw)
    assert np.array_equal(got, to_u32(TC.interpolate_plain(xt)))
    got = emulate_plan(x, n, n, False, T, logw)
    assert np.array_equal(got, to_u32(TC.evaluate_plain(xt)))
    for e in (1, 2, 3):
        if n - e >= 1:
            c = x[:, : 1 << (n - e)]
            got = emulate_plan(c, n - e, n, False, T, logw)
            want = TC.evaluate_plain(TC.extend_coeffs(from_u32(c, "cpu"), n))
            assert np.array_equal(got, to_u32(want))


@pytest.mark.parametrize("n", range(1, 31))
def test_pass_plan_on_the_card(n):
    """The card's plan: one pass up to TILE_LOG, two up to 2 TILE_LOG -
    LOG_W (24: the main path's largest domain), tiles of at most
    TILE_LOG words, large-half runs of at least 2^LOG_W words."""
    T, W = TC.TILE_LOG, TC.LOG_W
    for k, inverse in [(n, True), (n, False)] + [(n - e, False)
                                                 for e in (1, 2) if n > e]:
        plan = TC._pass_plan(k, n, inverse)
        assert len(plan) == (1 if n <= T else 2 if n <= 2 * T - W else 3)
        for lo, hi, wb, s0 in plan:
            assert wb + hi - lo <= T
            assert lo == 0 or wb >= min(W, lo)


# the largest transforms of the main path: the composition's LDE of 437
# coefficient rows to 4x (one pass at 2^22 rows, 2^23, 2^24) and a
# resident 2^23-row trace's interaction LDE; segmented, the main and
# interaction groups of four 2^22-row CPU components and the
# interaction group of eight, transformed whole when nothing streams;
# every output past 2^31 words, the 437-row ones and the groups past 2^32
@pytest.mark.parametrize("rows,k,n", [(437, 22, 24), (438, 23, 25),
                                      (437, 24, 26), (244, 23, 24),
                                      (772, 22, 23), (976, 22, 23),
                                      (1952, 22, 23)])
def test_pass_plan_index_math_at_the_largest_shapes(rows, k, n):
    """csrc/cfft.cu's index math for the card's plan at these shapes: the
    grid fits the kernel's 2^31 - 1 blocks, a pass's tiles partition a
    row (their bases distinct and clear of a tile's own bits), positions
    stay below 2^n <= 2^30 (32 bits), and the first and last blocks
    read and write inside the matrix at offsets that only 64 bits hold
    (the kernel's row offsets are long long)."""
    text = (Path(TC.__file__).parents[1] / "csrc" / "cfft.cu").read_text()
    assert "const long long row = blockIdx.x % rows;" in text
    assert "src + (row << log_src)" in text and \
        "dst + (row << log_n)" in text
    assert rows << n >= 1 << 31
    for inverse, kk in ((False, k), (True, n)):
        plan = TC._pass_plan(kk, n, inverse)
        for i, (lo, hi, wb, s0) in enumerate(plan):
            S, nhigh = wb + hi - lo, n - hi
            log_src = kk if i == 0 else n
            ntiles = 1 << (lo - wb + nhigh)
            assert rows * ntiles <= 0x7FFFFFFF and ntiles << S == 1 << n
            tile = np.arange(ntiles, dtype=np.int64)
            base = ((tile & ((1 << nhigh) - 1)) << hi) | \
                ((tile >> nhigh) << wb)
            own = ((1 << wb) - 1) | (((1 << (hi - lo)) - 1) << lo)
            assert len(np.unique(base)) == ntiles and not (base & own).any()
            q = np.arange(1 << S, dtype=np.int64)
            for b in (0, rows * ntiles - 1):
                row, t = b % rows, b // rows
                pos = base[t] | (q & ((1 << wb) - 1)) | ((q >> wb) << lo)
                assert pos.max() < 1 << n <= 1 << 30
                src = (row << log_src) + (pos >> (n - log_src))
                dst = (row << n) + pos
                assert src.max() < rows << log_src and dst.max() < rows << n
            # the last block's row starts past 2^31 words
            assert (rows - 1) << n >= 1 << 31
