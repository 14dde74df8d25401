"""Import hygiene of the PyTorch port and its device rule.

The port imports neither JAX nor anything of the JAX package, and its
entry points run on the card unless the caller asks for the CPU: with no
CUDA device the default device raises instead of falling back.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, re, sys
    import nexus_zkvm_tpu_torch as pkg
    # Python modules only: the native emulator's shared library is
    # built next to its loader
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")
             if m.ispkg or m.module_finder.find_spec(
                 m.name.rsplit(".", 1)[-1]).origin.endswith(".py")]
    for name in names:
        importlib.import_module(name)
    bad = [m for m in sys.modules
           if re.fullmatch(r"jax(\\..*)?|jaxlib(\\..*)?", m)
           or re.fullmatch(r"nexus_zkvm_tpu(\\..*)?", m)]
    subpackages = {n.split(".")[1] for n in names}
    missing = {"air", "machine", "ops", "precompiles", "prover", "sdk",
               "utils", "vm"} - subpackages
    print(len(names), "modules;", "leaked:", bad, "missing:", missing)
    sys.exit(1 if bad or missing or len(names) < 45 else 0)
""")


def test_port_imports_no_jax_and_no_reference_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air.component import Component

    class One(Component):
        name = "one"
        n_main = 1

        def evaluate(self, ctx):
            ctx.constraint(ctx.main(0) - ctx.main(0))

    traces = [[np.zeros(16, np.uint32)]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.prove([One()], [4], traces, T.Blake2sChannel())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.verify([One()], None, T.Blake2sChannel())


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A wrapper given a CUDA tensor launches its kernel or raises: it
    never calls the plain version.  Simulated on the CPU by a tensor
    that claims to be on CUDA."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.ops import cfft

    calls = []
    monkeypatch.setattr(cfft, "interpolate_plain",
                        lambda *a: calls.append("plain"))

    def refuse(*a, **k):
        raise RuntimeError("kernel unavailable")
    monkeypatch.setattr(kernels, "launch", refuse)
    monkeypatch.setattr(kernels, "check_cuda_tensor", lambda *a, **k: None)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.zeros(1, 8, dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        cfft.interpolate(x)
    assert calls == []
