"""Host wall-clock phase timing.

``with profiled() as prof:`` activates a profiler; library code marks
phases with ``with scope("fri"):``, a no-op when none is active (but
for the progress ticker, `utils/progress.py`, which a scope drives
whenever it is on).  While a profiler is active each scope synchronizes
CUDA on entry and exit, so a phase's time includes the device work it
issued.  ``note(key, value)`` records what a run decided
(``prof.notes``), also a no-op without one.  ``profiled(memory=True)``
also keeps each top-level phase's peak device memory (``prof.peaks``,
bytes allocated; ``prof.reserved``, bytes the caching allocator held;
the card's peak counters are reset as each top-level scope starts and
ends, so ``"(between)"`` holds the most reached outside them).

Usage::

    from nexus_zkvm_tpu_torch.utils import profiled

    with profiled() as prof:
        proof = prove_machine(view, trace, device="cuda")
    print(prof.report())
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from . import progress

__all__ = ["Profiler", "profiled", "scope", "note", "active_profiler"]

_ACTIVE: "Profiler | None" = None


class Profiler:
    def __init__(self):
        self.times: dict[str, float] = {}   # "outer/inner" scope -> seconds
        self.counts: dict[str, int] = {}    # "outer/inner" scope -> calls
        self.notes: dict[str, object] = {}
        self.peaks: dict[str, int] = {}     # top-level scope -> bytes
        self.reserved: dict[str, int] = {}  # top-level scope -> bytes
        self.memory = False
        self._stack: list[str] = []
        self._t0 = time.perf_counter()

    def total(self) -> float:
        """Seconds since the profiler was made."""
        return time.perf_counter() - self._t0

    def report(self, min_share: float = 0.005) -> str:
        """Indented tree of scopes: total seconds, calls, % of wall
        (scopes under ``min_share`` of it left out)."""
        wall = self.total()
        lines = [f"{'scope':<44} {'total_s':>9} {'calls':>7} {'%':>6}"]
        for key in sorted(self.times,
                          key=lambda k: (k.count("/"), -self.times[k])):
            share = self.times[key] / wall if wall else 0.0
            if share < min_share:
                continue
            label = "  " * key.count("/") + key.rsplit("/", 1)[-1]
            lines.append(f"{label:<44} {self.times[key]:>9.3f} "
                         f"{self.counts[key]:>7d} {100 * share:>5.1f}%")
        lines.append(f"{'(wall)':<44} {wall:>9.3f}")
        return "\n".join(lines)

    def phase_seconds(self) -> dict[str, float]:
        """Top-level phase -> seconds."""
        return {k: round(v, 3) for k, v in self.times.items()
                if "/" not in k}


@contextmanager
def profiled(memory: bool = False):
    """Activate a fresh profiler for the enclosed block (``memory``: with
    each top-level phase's peak device memory)."""
    global _ACTIVE
    prev, prof = _ACTIVE, Profiler()
    prof.memory = memory and torch.cuda.is_available()
    _ACTIVE = prof
    try:
        yield prof
    finally:
        _ACTIVE = prev


def active_profiler() -> "Profiler | None":
    return _ACTIVE


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def scope(name: str):
    prof = _ACTIVE
    shown = progress.phase_enter(name)
    if prof is None:
        try:
            yield
        finally:
            progress.phase_exit(name, shown)
        return
    _sync()
    top = prof.memory and not prof._stack
    if top:
        _peak(prof, "(between)")
        torch.cuda.reset_peak_memory_stats()
    prof._stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        if top:
            _peak(prof, name)
            torch.cuda.reset_peak_memory_stats()
        key = "/".join(prof._stack)
        prof.times[key] = prof.times.get(key, 0.0) + time.perf_counter() - t0
        prof.counts[key] = prof.counts.get(key, 0) + 1
        prof._stack.pop()
        progress.phase_exit(name, shown)


def _peak(prof: Profiler, key: str) -> None:
    prof.peaks[key] = max(prof.peaks.get(key, 0),
                          torch.cuda.max_memory_allocated())
    prof.reserved[key] = max(prof.reserved.get(key, 0),
                             torch.cuda.max_memory_reserved())


def note(key: str, value) -> None:
    if _ACTIVE is not None:
        _ACTIVE.notes[key] = value
