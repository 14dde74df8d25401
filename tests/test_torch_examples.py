"""The port's example, run as a user runs it: `examples/prove_fib_torch.py`
proves and verifies the fib guest through `sdk.LocalProver`, on the CPU
with ``--cpu``; without it, on a machine with no card, it raises rather
than fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "prove_fib_torch.py"


def _run(*args):
    return subprocess.run([sys.executable, str(EXAMPLE), *args], cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=600)


def test_prove_fib_torch_on_the_cpu():
    r = _run("10", "--cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "fib(10) = 55" in r.stdout
    assert "exit code: 0" in r.stdout
    assert "verified: True" in r.stdout


def test_prove_fib_torch_needs_the_card_without_cpu():
    if torch.cuda.is_available():
        return                      # it proves on the card there
    r = _run("10")
    assert r.returncode != 0 and "no CUDA device" in r.stderr
