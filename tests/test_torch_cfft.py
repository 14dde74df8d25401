"""Circle FFT of the PyTorch port against the JAX package.

interpolate / evaluate / lde on a batch of C = 3 rows for n = 1..12 and
at n = 15, where the JAX package switches to its transposed small-half
stages; outputs must be equal as uint32 (exact).
"""

import numpy as np
import pytest

from nexus_zkvm_tpu.ops import cfft as RC
from nexus_zkvm_tpu_torch.ops import cfft as TC
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32

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
