"""One run of a cell: set-up, the window, then the checks.

Set-up is everything from the process's start to the window's: the
imports and the CUDA context, the kernels (built into ``build/kernels``
inside the checkout at a checkout's first run, loaded after), the
seeded inputs and the mix's warm-up jobs.  The window proves the seed's
jobs one after another (``window.py``).  After it closes, and after the
memory peaks are read, the card's cache is emptied, and the plain
reference judges every job's claim and verifies the proofs the mix's
``sample`` draws (``reference/check.py``).  With ``trace`` each job runs
under the prover's ``profiled()`` (its scopes synchronize the card) and
the window under ``torch.profiler`` (``devtrace.py``); the per-layer
metrics are read from both.

The machine's ``Entry`` gets the whole cell, so a new machine file
reads keys of its own; a configuration or mix key that neither the
harness, the job builder (``KEYS``) nor the machine (``CONFIG_KEYS``,
``MIX_KEYS``) reads is refused before anything runs.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

from .devtrace import Recorder, base_name, summarize
from .spec import Cell, load_module
from .window import JobRecord, closes, window_summary

__all__ = ["CONFIG_KEYS", "process_age", "Context", "unread_keys", "run"]

# configuration keys the harness reads (``machine``, ``pcs``) or that
# describe the deployment for its reader
CONFIG_KEYS = {"name", "machine", "pcs", "source", "source_parts",
               "guarantees", "reduced", "assumed", "deployment"}


def process_age() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: Cell
    jobs: list                   # the window's finished jobs
    trace: dict | None           # devtrace.summarize of the window
    blowup: int
    machine: str                 # the reference's name of the machine
    steps_per_s: float = 0.0     # the window's rate (``window.py``)
    _shapes: dict = field(default_factory=dict)

    def shapes(self, job) -> list:
        from reference.check import shapes
        key = job.index
        if key not in self._shapes:
            self._shapes[key] = shapes(self.machine, job.view,
                                       job.proof.stark.log_sizes)
        return self._shapes[key]

    def scope_mean(self, pick) -> float | None:
        """Mean seconds a job of the top-level scopes ``pick(name)``
        holds, over the jobs that ran under a profiler."""
        timed = [j for j in self.jobs if j.times]
        if not timed:
            return None
        return sum(sum(v for k, v in j.times.items()
                       if "/" not in k and pick(k)) for j in timed) \
            / len(timed)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the window's kernels whose base name
        (``devtrace.base_name``) is one of ``names``."""
        if not self.trace:
            return 0.0
        return sum(v for k, v in self.trace["kernel_s"].items()
                   if base_name(k) in names)


def prover_pcs(fields: dict):
    from nexus_zkvm_tpu_torch.prover import FriConfig, PcsConfig
    return PcsConfig(pow_bits=int(fields["pow_bits"]), fri=FriConfig(
        log_blowup=int(fields["log_blowup"]),
        log_last_layer=int(fields["log_last_layer"]),
        n_queries=int(fields["n_queries"]),
        log_arity=int(fields["log_arity"])))


def unread_keys(cell: Cell, job, machine) -> list:
    """The configuration's and the mix's keys that nothing reads."""
    cfg = CONFIG_KEYS | set(getattr(machine, "CONFIG_KEYS", ()))
    mix = set(job.KEYS) | set(getattr(machine, "MIX_KEYS", ()))
    return sorted([f"config {k}" for k in set(cell.config) - cfg]
                  + [f"mix {k}" for k in set(cell.traffic) - mix])


def _job_seconds(jobs: list, job) -> dict:
    """Mean seconds a finished job of the window takes, by rung."""
    by, last = {}, 0.0
    for j in jobs:
        if j.ok:
            by.setdefault(str(job.rung_of(j.n)), []).append(j.end - last)
        last = j.end
    return {k: sum(v) / len(v) for k, v in sorted(by.items())}


def host_probe(rounds: int = 3) -> float:
    """Seconds of a fixed piece of host work (a Python loop and a numpy
    sort), the least of ``rounds``: a gauge of the host's speed in this
    run, beside its rates, since the host sets the pace of both cells."""
    import numpy as np
    best = float("inf")
    data = np.random.default_rng(0).integers(0, 1 << 31, 1 << 20)
    for _ in range(rounds):
        t = time.perf_counter()
        acc = 0
        for i in range(400_000):
            acc += i & 7
        np.sort(data)
        best = min(best, time.perf_counter() - t)
    return best


def _sync(cuda: bool) -> None:
    if cuda:
        import torch
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", schedule=None, entry=None) -> dict:
    """The run's result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` a ``breakdown``, and
    ``compared`` last.  ``schedule`` (([warm-up n, ...], [n, ...])) and
    ``entry`` replace the mix's jobs and the machine's entry (the CPU
    tests' rehearsals and planted faults)."""
    import torch
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    from reference import check

    cuda = device == "cuda"
    job = load_module("traffic", cell.traffic["job"])
    machine = load_module("machines", cell.config["machine"])
    unread = unread_keys(cell, job, machine)
    if unread:
        raise ValueError(f"{cell.name}: nothing reads {', '.join(unread)}")
    warm, ns = schedule or job.schedule(seed, cell.traffic)
    block = 1 if schedule else job.block(cell.traffic)
    if entry is None:
        entry = machine.Entry(cell, job.guest(),
                              prover_pcs(cell.config["pcs"]), device)
    for n in warm:
        entry.prove(job.public_input(n))
    _sync(cuda)
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()

    jobs = []
    recorder = Recorder() if trace and cuda else None
    with recorder or nullcontext():
        c0 = time.process_time()
        t0 = time.perf_counter()        # the profiler, if any, is on
        for i, n in enumerate(ns):
            rec = JobRecord(index=i, n=n, steps=job.steps(n), end=0.0)
            try:
                with recorder.job() if recorder else nullcontext(), \
                        profiled() if trace else nullcontext() as prof:
                    rec.view, rec.proof = entry.prove(job.public_input(n))
                    _sync(cuda)
                if prof is not None:
                    rec.times, rec.notes = dict(prof.times), dict(prof.notes)
            except Exception as e:     # a failed job is counted, not fatal
                rec.error = f"{type(e).__name__}: {e}"[:400]
                if cuda:
                    torch.cuda.empty_cache()
            rec.ok = rec.proof is not None and rec.view is not None
            rec.end = time.perf_counter() - t0
            jobs.append(rec)
            if closes(rec.end, seconds, i, block):
                break
        else:
            raise RuntimeError("the schedule ended before the window closed")
        cpu_s = time.process_time() - c0
    win = window_summary(jobs, seconds, block)
    finished = [j for j in win["jobs"] if j.ok]
    checked = job.sample(seed, cell.traffic, [j.n for j in finished])
    probe_s = host_probe()

    dev_info = {"platform": "cpu", "kind": "cpu", "count": 0}
    metrics = {}
    if cuda:
        window_peak = torch.cuda.max_memory_reserved()
        total = torch.cuda.get_device_properties(0).total_memory
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": 1,
                    "memory_peak_bytes": max(setup_peak, window_peak)}
        if not trace:
            e2e = {"setup_s": setup_s,
                   "steps_per_s": win["steps_per_s"],
                   "peak_reserved_frac": window_peak / total}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        torch.cuda.empty_cache()

    breakdown = None
    if trace and cuda:
        summary = summarize(recorder.trace())
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        breakdown = summary["breakdown"]
        ctx = Context(cell=cell, jobs=finished, trace=summary,
                      blowup=int(cell.config["pcs"]["log_blowup"]),
                      machine=machine.REFERENCE,
                      steps_per_s=win["steps_per_s"])
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t = time.perf_counter()
    at = {id(j): i for i, j in enumerate(win["jobs"])}
    compared, bad = check.judge(
        machine.REFERENCE, [(j.n, j.view, j.proof) for j in win["jobs"]],
        cell.config["pcs"], job.SOURCE.read_text(), device,
        checked=[at[id(finished[i])] for i in checked])
    reference_s = time.perf_counter() - t
    result = {"correct": all(v <= check.LIMITS[k]
                             for k, v in compared.items()) and bool(finished),
              "attempted": win["attempted"], "failed": bad,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["errors"] = [j.error for j in win["jobs"] if j.error][:4]
    result["checked"] = len(checked)
    result["host_probe_s"] = probe_s
    result["job_s"] = _job_seconds(win["jobs"], job)
    result["window_cpu_s"] = cpu_s
    result["reference_s"] = reference_s
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in compared.items()}
    return result
