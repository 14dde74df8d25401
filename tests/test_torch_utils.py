"""The port's host profiler, progress ticker and ``sdk.profile``.

The cases of `tests/test_utils.py` and `tests/test_sdk.py`'s
`test_host_profile_decorator`, run on ``nexus_zkvm_tpu_torch``, and its
profiler's report beside the JAX package's on the same scope tree.
"""

import io
import sys

from nexus_zkvm_tpu.utils import profiled as rprofiled, scope as rscope
from nexus_zkvm_tpu_torch.utils import (Profiler, active_profiler,
                                        enable_progress, disable_progress,
                                        profiled, scope)
from nexus_zkvm_tpu_torch.utils import progress as prog_mod
import torch_cpu  # noqa: F401  (one torch thread a test process)


def test_profiler_records_nested_scopes():
    with profiled() as prof:
        with scope("outer"):
            with scope("inner"):
                pass
        with scope("outer"):
            pass
    assert prof.counts["outer"] == 2
    assert prof.counts["outer/inner"] == 1
    assert prof.times["outer"] >= prof.times["outer/inner"]
    rep = prof.report(min_share=0.0)
    assert "outer" in rep and "inner" in rep and "(wall)" in rep
    assert set(prof.phase_seconds()) == {"outer"}


def test_scope_noop_without_profiler():
    with scope("anything"):
        x = 1
    assert x == 1
    assert active_profiler() is None


def test_profiler_nesting_restored_after_exception():
    with profiled() as prof:
        try:
            with scope("a"):
                raise ValueError
        except ValueError:
            pass
        with scope("b"):
            pass
    assert prof.counts["a"] == 1
    assert prof.counts["b"] == 1      # not "a/b": stack unwound


def test_progress_ticker_writes_stderr():
    old = sys.stderr
    sys.stderr = io.StringIO()
    try:
        enable_progress()
        with scope("phase-x"):
            with scope("nested"):     # nested phases stay silent
                pass
        out = sys.stderr.getvalue()
    finally:
        disable_progress()
        prog_mod._DEPTH = 0
        sys.stderr = old
    assert "phase-x" in out
    assert "nested" not in out


def test_progress_off_by_default(monkeypatch):
    monkeypatch.delenv("NZT_PROGRESS", raising=False)
    monkeypatch.setattr(prog_mod, "_ENABLED", None)
    old = sys.stderr
    sys.stderr = io.StringIO()
    try:
        with scope("quiet"):
            pass
        out = sys.stderr.getvalue()
    finally:
        sys.stderr = old
    assert out == ""


def test_progress_env_switch(monkeypatch):
    """``NZT_PROGRESS`` (the JAX package's switch) turns the ticker on."""
    monkeypatch.setenv("NZT_PROGRESS", "1")
    monkeypatch.setattr(prog_mod, "_ENABLED", None)
    monkeypatch.setattr(prog_mod, "_DEPTH", 0)
    old = sys.stderr
    sys.stderr = io.StringIO()
    try:
        with scope("env-phase"):
            pass
        out = sys.stderr.getvalue()
    finally:
        sys.stderr = old
    assert "env-phase" in out and "[nexus-tpu]" in out


def test_report_matches_reference_layout():
    """The same scope tree gives the JAX package's report rows (labels,
    calls, order); only the seconds differ."""
    def drive(prof_cm, sc):
        with prof_cm() as prof:
            for _ in range(3):
                with sc("commit"):
                    with sc("lde"):
                        pass
            with sc("fri"):
                pass
        return prof

    def rows(prof):
        lines = prof.report(min_share=0.0).splitlines()
        return [(ln[:44].rstrip(), ln.split()[-2]) for ln in lines[1:-1]]

    tprof, rprof = drive(profiled, scope), drive(rprofiled, rscope)
    assert isinstance(tprof, Profiler)
    assert sorted(rows(tprof)) == sorted(rows(rprof))
    assert tprof.counts == rprof.counts
    assert set(tprof.phase_seconds()) == set(rprof.phase_seconds())


def test_host_profile_decorator(tmp_path):
    """@sdk.profile wraps a host call and writes a phase report
    (reference analogue: sdk/macros/src/pprof.rs:7-40)."""
    from nexus_zkvm_tpu_torch.sdk import profile

    @profile("unit", dir=str(tmp_path))
    def work(x):
        with scope("phase_a"):
            s = sum(range(x))
        return s

    assert work(1000) == sum(range(1000))
    assert work.last_report_path is not None
    text = open(work.last_report_path).read()
    assert "phase_a" in text

    # nested profiled calls fold into the outer report (no extra file)
    @profile("outer", dir=str(tmp_path))
    def outer():
        return work(10)

    before = {p.name for p in tmp_path.iterdir()}
    assert outer() == sum(range(10))
    after = {p.name for p in tmp_path.iterdir()}
    assert len(after - before) == 1
    assert any(p.startswith("outer") for p in after)
    assert "profile:unit" in open(outer.last_report_path).read()


def test_memory_timeline_folds_into_top_level_peaks(monkeypatch):
    """``profiled(memory=True)``: at every scope's entry and exit the
    card's peaks since the last one are noted (``prof.events``) and
    folded into the top-level phase around them, so a nested scope's
    reset loses nothing of its phase's peak (the card's counters
    faked)."""
    import torch
    card = {"now": 0, "peak": 0, "held": 0, "held_peak": 0}

    def alloc(n):
        card["now"] += n
        card["peak"] = max(card["peak"], card["now"])
        card["held"] = max(card["held"], card["now"])
        card["held_peak"] = max(card["held_peak"], card["held"])

    def reset():
        card["peak"], card["held_peak"] = card["now"], card["held"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    for name, key in (("memory_allocated", "now"),
                      ("max_memory_allocated", "peak"),
                      ("memory_reserved", "held"),
                      ("max_memory_reserved", "held_peak")):
        monkeypatch.setattr(torch.cuda, name, lambda key=key: card[key])
    with profiled(memory=True) as prof:
        alloc(5)
        with scope("commit"):
            with scope("stack"):
                alloc(10)
                alloc(-10)
            alloc(3)
        with scope("compose"):
            alloc(1)
    # between the phases: 5 before the first, 8 after it
    assert prof.peaks == {"(between)": 8, "commit": 15, "compose": 9}
    assert prof.reserved == {"(between)": 15, "commit": 15, "compose": 15}
    assert [e[:2] for e in prof.events] == [
        ("commit", "enter"), ("commit/stack", "enter"),
        ("commit/stack", "exit"), ("commit", "exit"),
        ("compose", "enter"), ("compose", "exit")]
    # (allocated, reserved, the most of each since the last event)
    assert [e[2:] for e in prof.events] == [
        (5, 5, 5, 5), (5, 5, 5, 5), (5, 15, 15, 15), (8, 15, 8, 15),
        (8, 15, 8, 15), (9, 15, 9, 15)]
