"""Terminal progress display for long proving runs.

Counterpart of the reference's CLI progress bar
(`nexus-zkvm/cli/progress-bar/src/lib.rs:1-8`): proving is a short
sequence of phases rather than a long row loop, so the display is a
live phase ticker (``[nexus-tpu] fri ... `` then ``fri: 12.30s``) on
stderr, one line a top-level `utils.profile.scope`.  Switched on by the
CLI (``--progress``), `enable_progress()`, or the ``NZT_PROGRESS``
environment variable; off otherwise.
"""

from __future__ import annotations

import os
import sys
import time

__all__ = ["enable_progress", "disable_progress", "phase_enter",
           "phase_exit"]

_ENABLED: bool | None = None   # None: read NZT_PROGRESS
_DEPTH = 0
_T0: dict[str, float] = {}


def enable_progress(force: bool = True) -> None:
    global _ENABLED
    _ENABLED = force


def disable_progress() -> None:
    global _ENABLED
    _ENABLED = False


def _on() -> bool:
    if _ENABLED is not None:
        return _ENABLED
    return bool(os.environ.get("NZT_PROGRESS"))


def phase_enter(name: str) -> bool:
    """Show a phase start; returns whether this call printed."""
    global _DEPTH
    if not _on():
        return False
    _DEPTH += 1
    if _DEPTH > 1:          # only top-level phases are shown
        return False
    _T0[name] = time.perf_counter()
    sys.stderr.write(f"\r\x1b[2K[nexus-tpu] {name} ...")
    sys.stderr.flush()
    return True


def phase_exit(name: str, shown: bool) -> None:
    global _DEPTH
    if not _on():
        return
    _DEPTH = max(0, _DEPTH - 1)
    if not shown:
        return
    dt = time.perf_counter() - _T0.pop(name, time.perf_counter())
    sys.stderr.write(f"\r\x1b[2K[nexus-tpu] {name}: {dt:.2f}s\n")
    sys.stderr.flush()
