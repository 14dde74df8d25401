"""No JAX and no JAX package in a run, and no prover in the reference."""

import json
import subprocess
import sys

from harness import guard, spec


def test_names_are_compared_whole():
    assert guard.loaded_forbidden(["nexus_zkvm_tpu_torch",
                                   "nexus_zkvm_tpu_torch.ops"]) == []
    assert guard.loaded_forbidden(["nexus_zkvm_tpu.ops.field"]) == \
        ["nexus_zkvm_tpu"]
    assert guard.loaded_forbidden(["jax.numpy", "jaxlib", "flax.linen",
                                   "jaxtyping"]) == ["flax", "jax", "jaxlib"]


def test_the_reference_sources_import_no_prover():
    assert guard.reference_faults(spec.ROOT / "reference") == []


def _loaded_after(code: str) -> list:
    prog = (f"import sys; sys.path[:0] = [{str(spec.ROOT)!r}, "
            f"{str(spec.REPO)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], check=True,
                         capture_output=True, text=True, cwd=spec.REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_no_prover():
    top = _loaded_after("import reference.check")
    assert guard.PROGRAM not in top
    assert not set(top) & set(guard.FORBIDDEN)


def test_the_harness_and_the_prover_load_no_jax():
    top = _loaded_after(
        "from harness import session, devtrace\n"
        "import nexus_zkvm_tpu_torch.sdk, nexus_zkvm_tpu_torch.machine2\n"
        "import reference.check")
    assert guard.PROGRAM in top
    assert not set(top) & set(guard.FORBIDDEN)


def test_the_command_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", "fib-v1.ladder",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.REPO)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA device" in out.stderr
