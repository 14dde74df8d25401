"""The device trace of a window.

``Recorder`` runs ``torch.profiler`` (CPU and CUDA activities) over the
window and turns the prover's own phase scopes into profiler ranges:
the hooks that every ``utils.profile.scope`` calls on entry and exit
(``utils.progress.phase_enter`` / ``phase_exit``) open and close a
``record_function`` range named ``zkb:s:<scope>``, and the harness adds
``zkb:window`` and one ``zkb:job`` a job.  After the window the trace
is read into device intervals (kernels, copies, sets) and host ranges,
all on the profiler's one clock, and reduced by the functions below:
busy seconds (the union of device intervals), idle gaps, each gap
named by the innermost range open on the host when it began, and
seconds by kernel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["Recorder", "Trace", "merge", "busy_seconds", "gaps",
           "innermost", "gap_pieces", "kernel_name", "base_name",
           "summarize"]

PREFIX = "zkb:"


@dataclass
class Trace:
    device: list          # (kernel name, start s, end s)
    ranges: list          # (range name, start s, end s), host side
    window: tuple         # (start s, end s)


def kernel_name(raw: str) -> str:
    """A kernel's qualified name without its return type, anonymous
    namespace, template arguments and parameters: ``void (anonymous
    namespace)::cfft_pass<true>(unsigned int const*, ...)`` ->
    ``cfft_pass``, ``at::native::vectorized_elementwise_kernel<4, ...>``
    -> ``at::native::vectorized_elementwise_kernel``."""
    s = raw.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    return re.split(r"[<(]", s, 1)[0].strip() or raw


def base_name(name: str) -> str:
    """The last part of a qualified kernel name."""
    return name.rsplit("::", 1)[-1]


def merge(intervals) -> list:
    """Sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(merged, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi) in which no interval of
    ``merged`` runs."""
    out, t = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def innermost(ranges, t: float):
    """The name of the latest-opened range that holds ``t``, or None."""
    best = None
    for name, a, b in ranges:
        if a <= t < b and (best is None or a > best[1]
                           or (a == best[1] and b < best[2])):
            best = (name, a, b)
    return None if best is None else best[0]


def _label(name) -> str:
    if name is None or name == PREFIX + "window":
        return "between jobs"
    if name == PREFIX + "job":
        return "job, outside the prover's scopes"
    return name[len(PREFIX) + 2:] if name.startswith(PREFIX + "s:") \
        else name


def gap_pieces(ranges, a: float, b: float) -> list:
    """An idle gap [a, b) cut where host ranges open or close: (label,
    seconds) a piece, each named by the innermost range open over it,
    neighbours of one name joined."""
    cuts = sorted({a, b} | {t for _n, x, y in ranges for t in (x, y)
                            if a < t < b})
    out = []
    for x, y in zip(cuts, cuts[1:]):
        name = _label(innermost(ranges, (x + y) / 2))
        if out and out[-1][0] == name:
            out[-1][1] += y - x
        else:
            out.append([name, y - x])
    return out


def summarize(trace: Trace, top: int = 10) -> dict:
    """busy_s, window_s, idle_frac, seconds by kernel name, and the
    breakdown: the ``top`` device operations by seconds and the ``top``
    longest idle stretches, each named by what the host was doing (the
    longest gaps cut at the host's range boundaries, `gap_pieces`)."""
    lo, hi = trace.window
    merged = merge((a, b) for _n, a, b in trace.device)
    busy = busy_seconds(merged, lo, hi)
    by_name = {}
    for name, a, b in trace.device:
        d = max(0.0, min(b, hi) - max(a, lo))
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    pieces = [p for a, b in longest[:5 * top]
              for p in gap_pieces(trace.ranges, a, b)]
    idle = sorted(pieces, key=lambda p: -p[1])[:top]
    window_s = hi - lo
    return {"busy_s": busy, "window_s": window_s,
            "idle_frac": 1.0 - busy / window_s if window_s > 0 else None,
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": idle}}


class Recorder:
    """``with Recorder() as rec:`` traces the block; ``rec.job()`` marks
    one job; ``rec.trace()`` reads the trace once the block has ended."""

    def __init__(self):
        self._prof = None
        self._stack = []
        self._window = None
        self._saved = None

    def __enter__(self):
        import torch
        from nexus_zkvm_tpu_torch.utils import progress
        enter, leave = progress.phase_enter, progress.phase_exit
        stack = self._stack

        def phase_enter(name):
            shown = enter(name)
            rf = torch.profiler.record_function(f"{PREFIX}s:{name}")
            rf.__enter__()
            stack.append(rf)
            return shown

        def phase_exit(name, shown):
            if stack:
                stack.pop().__exit__(None, None, None)
            leave(name, shown)
        self._saved = (progress, enter, leave)
        progress.phase_enter, progress.phase_exit = phase_enter, phase_exit
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        self._prof.start()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()
        return self

    def job(self):
        import torch
        return torch.profiler.record_function(PREFIX + "job")

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        progress, enter, leave = self._saved
        progress.phase_enter, progress.phase_exit = enter, leave
        return False

    def trace(self) -> Trace:
        device, ranges = [], []
        for name, on_device, a, b in _events(self._prof):
            if name.startswith(PREFIX):
                if not on_device:
                    ranges.append((name, a, b))
            elif on_device:
                device.append((kernel_name(name), a, b))
        win = [(a, b) for n, a, b in ranges if n == PREFIX + "window"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        return Trace(device=device, ranges=ranges, window=win[0])


def _events(prof):
    """(name, on the device, start s, end s) of every traced event."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            if hasattr(e, "start_ns"):
                a = e.start_ns() * 1e-9
                b = a + e.duration_ns() * 1e-9
            else:
                a = e.start_us() * 1e-6
                b = a + e.duration_us() * 1e-6
            yield e.name(), "CUDA" in str(e.device_type()), a, b
        return
    for e in prof.events():
        yield (e.name, "CUDA" in str(e.device_type),
               e.time_range.start * 1e-6, e.time_range.end * 1e-6)
