"""The port's command line (`python -m nexus_zkvm_tpu_torch.cli`).

`new` (a guest file, and the guest + host scaffold) and `run` in
process; `prove` then `verify` with ``--cpu`` on the fib guest at
n = 10: the bundle's bytes equal those the JAX package's CLI writes
for the same command (held as a recorded digest: the reference takes
about 10 minutes on XLA:CPU), `verify` exits 0, and a bundle with one
byte flipped exits 1.
Without ``--cpu`` and without a card, `prove` and `verify` exit 2.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nexus_zkvm_tpu_torch.cli import main
from nexus_zkvm_tpu_torch.sdk import Guest
import torch_cpu  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parent.parent
FIB = str(ROOT / "examples" / "guests" / "fib.s")
# blake2s of the bundle `python -m nexus_zkvm_tpu.cli prove
# examples/guests/fib.s --input 10 --cpu -o BUNDLE` writes (1,566,100
# bytes: the View and the proof at the default PcsConfig), recorded from
# the JAX package on XLA:CPU
FIB10_BUNDLE_BLAKE2S = \
    "1ae79ea0eba5fb9725540a1506915687be79c9489f77ef96af222b88f200ba81"


def cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("NZT_PROGRESS", None)
    return subprocess.run([sys.executable, "-m", "nexus_zkvm_tpu_torch.cli",
                           *args], cwd=cwd or ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli") / "fib10.bundle"
    r = cli("prove", FIB, "--input", "10", "--cpu", "-o", str(out),
            "--profile", "--progress")
    assert r.returncode == 0, r.stdout + r.stderr
    return out, r


def test_prove_bundle_equals_reference(bundle):
    out, r = bundle
    blob = out.read_bytes()
    assert len(blob) == 1_566_100
    assert hashlib.blake2s(blob).hexdigest() == FIB10_BUNDLE_BLAKE2S
    assert f"-> {out}" in r.stdout
    # --profile: the phase report; --progress: the ticker (stderr)
    assert "(wall)" in r.stderr and "composition" in r.stderr
    assert "[nexus-tpu]" in r.stderr


def test_verify_accepts_the_bundle(bundle):
    r = cli("verify", str(bundle[0]), "--cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "verified: True" in r.stdout
    assert "exit code: 0" in r.stdout
    assert "output bytes: 37" in r.stdout      # fib(10) = 55 = 0x37


def test_verify_rejects_a_flipped_byte(bundle, tmp_path):
    blob = bytearray(bundle[0].read_bytes())
    blob[len(blob) // 2] ^= 1
    bad = tmp_path / "bad.bundle"
    bad.write_bytes(bytes(blob))
    r = cli("verify", str(bad), "--cpu")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "verified: False" in r.stdout


def test_run_emulates(capsys):
    assert main(["run", FIB, "--input", "10"]) == 0
    out = capsys.readouterr().out
    assert "exit code: 0" in out
    assert "steps: 60" in out
    assert "output bytes: 37" in out


def test_new_guest_file(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["new", "g.s"]) == 0
    assert "ecall" in (tmp_path / "g.s").read_text()
    # the template assembles and runs
    assert main(["run", "g.s", "--input", "7"]) == 0
    assert "output bytes: 07" in capsys.readouterr().out
    # an existing file is refused
    with pytest.raises(SystemExit):
        main(["new", "g.s"])


def test_new_project_scaffold(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["new", "proj"]) == 0
    host = (tmp_path / "proj" / "host.py").read_text()
    assert "from nexus_zkvm_tpu_torch.sdk import" in host
    assert "nexus_zkvm_tpu." not in host
    compile(host, "host.py", "exec")
    guest = Guest.from_asm((tmp_path / "proj" / "guest.s").read_text())
    assert guest.program_words
    with pytest.raises(SystemExit):
        main(["new", "proj"])


def test_prove_without_a_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    r = cli("prove", FIB, "--input", "10", "-o", str(tmp_path / "x"))
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "x").exists()
