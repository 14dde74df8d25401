"""Host-side function profiling for SDK users.

Counterpart of the reference's ``#[nexus_sdk_macros::profile]``
(`nexus-zkvm/sdk/macros/src/pprof.rs:7-40`), which wraps a host
function with a pprof guard and writes a ``.pb`` profile file.  Here
the wrapped call runs under the phase profiler (`utils/profile.py`:
wall clock per scope, each scope synchronizing the card, so a phase
includes the device work it issued) and writes a plain-text phase-tree
report, one file per call.

Usage::

    from nexus_zkvm_tpu_torch.sdk import profile

    @profile("prove")                       # -> prove.<n>.profile.txt
    def run(guest):
        return prover.prove(guest)

Nested ``@profile`` calls compose: inner functions appear as scopes in
the outer report instead of writing their own file (the reference's
guard semantics, `pprof.rs:19-27`).
"""

from __future__ import annotations

import functools
import os

from ..utils.profile import active_profiler, profiled, scope

__all__ = ["profile"]

_counter = [0]


def profile(name: str | None = None, dir: str | None = None):
    """Decorator: profile the wrapped call's host phases to a file.

    name: report basename (defaults to the function name).
    dir: output directory (defaults to ``NZT_PROFILE_DIR`` or the
    working directory).
    """

    def wrap(fn):
        base = name or fn.__name__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if active_profiler() is not None:
                # nested: a scope of the active profile
                with scope(f"profile:{base}"):
                    return fn(*args, **kwargs)
            with profiled() as prof:
                out = fn(*args, **kwargs)
            _counter[0] += 1
            d = dir or os.environ.get("NZT_PROFILE_DIR") or os.getcwd()
            path = os.path.join(d, f"{base}.{_counter[0]}.profile.txt")
            with open(path, "w") as f:
                f.write(prof.report())
            inner.last_report_path = path
            return out

        inner.last_report_path = None
        return inner

    return wrap
