"""Host wall-clock phase timing.

``with profiled() as prof:`` activates a profiler; library code marks
phases with ``with scope("fri"):``, a no-op when none is active.  While
a profiler is active each scope synchronizes CUDA on entry and exit, so
a phase's time includes the device work it issued.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

__all__ = ["Profiler", "profiled", "scope"]

_ACTIVE: "Profiler | None" = None


class Profiler:
    def __init__(self):
        self.times: dict[str, float] = {}   # "outer/inner" scope -> seconds
        self._stack: list[str] = []


@contextmanager
def profiled():
    global _ACTIVE
    prev, prof = _ACTIVE, Profiler()
    _ACTIVE = prof
    try:
        yield prof
    finally:
        _ACTIVE = prev


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def scope(name: str):
    prof = _ACTIVE
    if prof is None:
        yield
        return
    _sync()
    prof._stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        key = "/".join(prof._stack)
        prof.times[key] = prof.times.get(key, 0.0) + time.perf_counter() - t0
        prof._stack.pop()
