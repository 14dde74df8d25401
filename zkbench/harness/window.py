"""The closed loop's window.

One client keeps a backlog of jobs and the system runs them one after
another.  The window opens when set-up ends and closes at the first
job completion at or after ``seconds`` that ends a block of the mix
(``block`` jobs, one a rung for the ladder): the jobs in flight then
are finished and counted, not dropped, so a rate is all the work of the
window over all its time, and every window holds whole blocks, the same
set of sizes whatever order the seed drew them in.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["JobRecord", "closes", "window_summary"]


@dataclass
class JobRecord:
    index: int
    n: int
    steps: int
    end: float                # seconds since the window opened
    ok: bool = True           # finished without raising
    error: str | None = None
    view: object = None
    proof: object = None
    times: dict = field(default_factory=dict)   # scope path -> seconds
    notes: dict = field(default_factory=dict)


def closes(end: float, seconds: float, index: int = 0,
           block: int = 1) -> bool:
    """Whether job ``index`` (from 0), completing at ``end``, closes the
    window."""
    return end >= seconds and (index + 1) % block == 0


def window_summary(jobs: list, seconds: float, block: int = 1) -> dict:
    """The window of a job log (started in order, times since the window
    opened): the jobs up to and including the first completion at or
    after ``seconds`` that ends a block, the window's length (that
    completion), and the guest steps of the jobs that finished over it."""
    inside = []
    for job in jobs:
        inside.append(job)
        if closes(job.end, seconds, job.index, block):
            break
    window_s = inside[-1].end if inside else 0.0
    steps = sum(j.steps for j in inside if j.ok)
    return {"jobs": inside, "window_s": window_s,
            "attempted": len(inside),
            "finished": sum(1 for j in inside if j.ok),
            "steps": steps,
            "steps_per_s": steps / window_s if window_s > 0 else 0.0}
