"""The device trace's reductions on synthetic intervals."""

import pytest

from harness.devtrace import (Trace, base_name, busy_seconds, gap_pieces,
                              gaps, innermost, kernel_name, merge,
                              summarize)


def test_merge_and_busy():
    m = merge([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)])
    assert m == [(0, 4), (5, 6)]
    assert busy_seconds(m, 0, 10) == 5
    assert busy_seconds(m, 1, 5.5) == pytest.approx(3.5)


def test_gaps_cover_the_rest_of_the_window():
    m = merge([(1, 2), (4, 6)])
    assert gaps(m, 0, 10) == [(0, 1), (2, 4), (6, 10)]
    assert gaps(m, 1.5, 5) == [(2, 4)]
    assert gaps([], 0, 3) == [(0, 3)]


def test_idle_share_and_breakdown():
    trace = Trace(
        device=[("cfft_pass", 1.0, 3.0), ("blake2s_parents", 2.0, 4.0),
                ("cfft_pass", 6.0, 7.0)],
        ranges=[("zkb:window", 0.0, 10.0), ("zkb:job", 0.5, 9.0),
                ("zkb:s:fills", 0.5, 1.0), ("zkb:s:pow", 4.0, 5.5),
                ("zkb:s:emulate", 7.5, 8.0)],
        window=(0.0, 10.0))
    s = summarize(trace)
    assert s["busy_s"] == pytest.approx(4.0)
    assert s["idle_frac"] == pytest.approx(0.6)
    assert s["kernel_s"] == {"cfft_pass": 3.0, "blake2s_parents": 2.0}
    assert s["breakdown"]["device_ops"][0] == ["cfft_pass", 3.0]
    # gaps [0, 1), [4, 6), [7, 10), cut where the host's ranges open or
    # close: [7, 10) is 0.5 in the job, 0.5 in emulate, 1.0 in the job
    # and 1.0 after it
    assert s["breakdown"]["idle_gaps"][:3] == [
        ["pow", 1.5], ["job, outside the prover's scopes", 1.0],
        ["between jobs", 1.0]]
    assert sum(p[1] for p in s["breakdown"]["idle_gaps"]) == \
        pytest.approx(6.0)


def test_gap_pieces_join_neighbours_of_one_name():
    ranges = [("zkb:window", 0, 10), ("zkb:s:fills", 1, 3),
              ("zkb:s:f:cpu", 1, 2), ("zkb:s:f:cpu", 2, 3)]
    assert gap_pieces(ranges, 0.5, 4) == [
        ["between jobs", 0.5], ["f:cpu", 2.0], ["between jobs", 1.0]]


def test_innermost_takes_the_latest_opened_range():
    ranges = [("a", 0, 10), ("b", 2, 8), ("c", 3, 4)]
    assert innermost(ranges, 3.5) == "c"
    assert innermost(ranges, 5) == "b"
    assert innermost(ranges, 11) is None


@pytest.mark.parametrize("raw, name", [
    ("void (anonymous namespace)::cfft_pass<false>(unsigned int const*, "
     "unsigned int*, unsigned int const*, long long, int)", "cfft_pass"),
    ("(anonymous namespace)::blake2s_leaves_stream(unsigned int*, "
     "unsigned int const*, long long, int)", "blake2s_leaves_stream"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<int>>(int, at::native::FillFunctor<int>)",
     "at::native::vectorized_elementwise_kernel"),
    ("blake2s_parents(unsigned int const*, unsigned int*, long long)",
     "blake2s_parents"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
])
def test_kernel_names(raw, name):
    assert kernel_name(raw) == name
    assert base_name(kernel_name(raw)) == name.rsplit("::", 1)[-1]
