"""The closed loop's window on synthetic job logs."""

import pytest

from harness.window import JobRecord, closes, window_summary


def log(*spans, failed=()):
    return [JobRecord(index=i, n=i, steps=100 * (i + 1), end=b,
                      ok=i not in failed)
            for i, (_a, b) in enumerate(spans)]


def test_the_job_in_flight_is_finished_and_counted():
    jobs = log((0, 4), (4, 8), (8, 12.5), (12.5, 16))
    w = window_summary(jobs, 10)
    assert [j.index for j in w["jobs"]] == [0, 1, 2]
    assert w["window_s"] == 12.5
    assert w["steps"] == 100 + 200 + 300
    assert w["steps_per_s"] == pytest.approx(600 / 12.5)


def test_a_completion_at_the_limit_closes_the_window():
    assert closes(10.0, 10) and not closes(9.999, 10)
    w = window_summary(log((0, 5), (5, 10), (10, 15)), 10)
    assert w["attempted"] == 2 and w["window_s"] == 10


def test_a_failed_job_counts_as_attempted_and_adds_no_steps():
    w = window_summary(log((0, 3), (3, 6), (6, 11), failed={1}), 10)
    assert (w["attempted"], w["finished"], w["steps"]) == (3, 2, 400)
    assert w["steps_per_s"] == pytest.approx(400 / 11)


def test_one_long_job():
    w = window_summary(log((0, 30)), 10)
    assert w["attempted"] == 1 and w["window_s"] == 30


def test_the_window_ends_on_a_blocks_end():
    jobs = log((0, 4), (4, 8), (8, 12.5), (12.5, 16), (16, 20), (20, 24))
    assert not closes(12.5, 10, 2, 2) and closes(16, 10, 3, 2)
    w = window_summary(jobs, 10, block=2)
    assert [j.index for j in w["jobs"]] == [0, 1, 2, 3]
    assert w["window_s"] == 16 and w["steps"] == 1000
    assert window_summary(jobs, 10, block=3)["window_s"] == 12.5
    assert window_summary(jobs, 10, block=5)["window_s"] == 20
