"""Judge a run's proofs against the plain reference.

Each job's answer is its (View, proof).  Three numbers are compared,
each with the limit 0:

* ``jobs_failed``: jobs that raised (an out-of-memory error included)
  or gave no proof;
* ``claims_wrong``: proofs whose public View is not the fib guest's
  claim on the job's own n as ``fib.py`` builds it (memory layout,
  initial image, program, input, fib(n), exit code 0), over every job;
* ``proofs_rejected``: proofs the frozen verifier rejects against the
  reference's own claim (never the prover's View) under the
  configuration's own ``pcs`` parameters, with the preprocessed
  commitment recomputed in plain PyTorch on ``device``, over the jobs
  ``checked`` names (all of them by default).
"""

from __future__ import annotations

from . import fib
from .nzt.air.component import component_info
from .nzt.machine.driver import build_components, verify_machine
from .nzt.machine2.driver import build_components2, verify_machine2
from .nzt.ops.fri import FriConfig
from .nzt.prover.config import PcsConfig
from .nzt.vm.asm import assemble
from .nzt.vm.isa import ELF_TEXT_START

__all__ = ["LIMITS", "pcs_config", "guest_program", "verify", "judge",
           "shapes"]

LIMITS = {"jobs_failed": 0, "claims_wrong": 0, "proofs_rejected": 0}

_VERIFY = {"v1": verify_machine, "m2": verify_machine2}


def pcs_config(fields: dict) -> PcsConfig:
    return PcsConfig(pow_bits=int(fields["pow_bits"]), fri=FriConfig(
        log_blowup=int(fields["log_blowup"]),
        log_last_layer=int(fields["log_last_layer"]),
        n_queries=int(fields["n_queries"]),
        log_arity=int(fields["log_arity"])))


def guest_program(source: str) -> list:
    return assemble(source, base=ELF_TEXT_START)


def verify(machine: str, view, proof, pcs: dict, device="cpu") -> bool:
    return bool(_VERIFY[machine](view, proof, pcs_config(pcs), device))


def judge(machine: str, jobs, pcs: dict, source: str, device="cpu",
          checked=None) -> tuple:
    """(the compared numbers, the jobs with any fault) over ``jobs``:
    (n, view, proof), view and proof None for a job that gave none;
    ``checked``, indices into ``jobs``, the ones the verifier reads."""
    program = guest_program(source)
    checked = set(range(len(jobs)) if checked is None else checked)
    out = dict.fromkeys(LIMITS, 0)
    bad = 0
    for i, (n, view, proof) in enumerate(jobs):
        if view is None or proof is None:
            out["jobs_failed"] += 1
            bad += 1
            continue
        want = fib.claim(n, program)
        wrong = bool(fib.claim_errors(view, want))
        rejected = i in checked and not verify(machine, want, proof, pcs,
                                               device)
        out["claims_wrong"] += wrong
        out["proofs_rejected"] += rejected
        bad += wrong or rejected
    return out, bad


def shapes(machine: str, view, log_sizes) -> list:
    """(log size, preprocessed, main, LogUp batch columns) of each
    component of a proof, rebuilt from the public View."""
    if machine == "v1":
        n_fixed = len(build_components(view, 1)[0]) - 1
        comps = build_components(view, len(log_sizes) - n_fixed)[0]
    else:
        comps = build_components2(view)[0]
    out = []
    for comp, n in zip(comps, log_sizes):
        info = component_info(comp)
        out.append((int(n), info.n_pre, info.n_main, info.n_logup_cols))
    return out
