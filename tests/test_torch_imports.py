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
import torch_cpu  # noqa: F401  (one torch thread a test process)

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
    missing = {"air", "machine", "machine2", "ops", "parallel",
               "precompiles", "prover", "sdk", "utils", "vm"} - subpackages
    print(len(names), "modules;", "leaked:", bad, "missing:", missing)
    sys.exit(1 if bad or missing or len(names) < 64 else 0)
""")


def test_port_imports_no_jax_and_no_reference_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_example_imports_no_jax_and_no_reference_package():
    """examples/prove_fib_torch.py, imported (not run), loads the port
    and nothing of JAX."""
    probe = textwrap.dedent("""
        import re, runpy, sys
        runpy.run_path("examples/prove_fib_torch.py", run_name="probe")
        bad = [m for m in sys.modules
               if re.fullmatch(r"jax(\\..*)?|jaxlib(\\..*)?", m)
               or re.fullmatch(r"nexus_zkvm_tpu(\\..*)?", m)]
        assert "nexus_zkvm_tpu_torch.sdk" in sys.modules
        print("leaked:", bad)
        sys.exit(1 if bad else 0)
    """)
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
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
    monkeypatch.setattr(kernels, "generated_entries", refuse)
    monkeypatch.setattr(kernels, "launch_generated", refuse)
    monkeypatch.setattr(kernels, "check_cuda_tensor", lambda *a, **k: None)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.zeros(1, 8, dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        cfft.interpolate(x)
    assert calls == []


def _fake_cuda_env(monkeypatch, module, *plain_names):
    """kernels.launch and the generated kernels' entry points (K7)
    refuse, the argument checks pass, and every named plain version of
    ``module`` records a call."""
    from nexus_zkvm_tpu_torch import kernels
    calls = []
    for name in plain_names:
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: calls.append(_n))

    def refuse(*a, **k):
        raise RuntimeError("kernel unavailable")
    monkeypatch.setattr(kernels, "launch", refuse)
    monkeypatch.setattr(kernels, "generated_entries", refuse)
    monkeypatch.setattr(kernels, "launch_generated", refuse)
    monkeypatch.setattr(kernels, "check_cuda_tensor", lambda *a, **k: None)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    return calls, (lambda t: t.as_subclass(FakeCuda))


def test_composition_and_oods_never_take_the_plain_path(monkeypatch):
    """The composition (K7), interaction operand (K7), OODS (K8) and
    opening-gather (K9) wrappers launch their kernels on CUDA tensors
    and never call their plain versions."""
    import chip_smoke
    from nexus_zkvm_tpu_torch.air import component, tape as tape_mod
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.ops import merkle
    from nexus_zkvm_tpu_torch.prover import stark
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    import nexus_zkvm_tpu_torch as T

    comp = chip_smoke.make_components()[0]
    rel = draw_relations(T.Blake2sChannel(), stark._relation_widths(
        [component.component_info(comp)]))
    dom = tape_mod.domain_tape(comp, 2, rel)
    gen = tape_mod.gen_tape(comp, 2, rel)
    calls, fake = _fake_cuda_env(monkeypatch, tape_mod,
                                 "air_eval_composition_plain",
                                 "air_eval_operands_plain")
    plain = []
    monkeypatch.setattr(tape_mod, "air_eval_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(stark, "oods_dot_plain",
                        lambda *a, **k: plain.append(2))
    monkeypatch.setattr(merkle, "gather_openings_plain",
                        lambda *a, **k: plain.append(3))
    rng = np.random.default_rng(0)

    def mat(rows, n):
        return fake(from_u32(rng.integers(0, 1 << 31, (rows, n),
                                          dtype=np.uint32), "cpu"))
    N, hneg, hpos = 16, 4, 4
    W = N + hneg + hpos
    mats = {tape_mod.MAIN: mat(comp.n_main, W), tape_mod.PRE: None,
            tape_mod.INTER: mat(4 * 64, W), tape_mod.ISF: mat(1, W)}
    alpha = np.arange(4, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        tape_mod.air_eval_composition(
            dom, mats, dom.uniforms(rel, alpha), 0, N, hneg, alpha, alpha,
            fake(torch.zeros(N, dtype=torch.int32)),
            fake(torch.zeros((N, 4), dtype=torch.int32)))
    mats = {tape_mod.MAIN: mat(comp.n_main, 4), tape_mod.PRE: None,
            tape_mod.ISF: mat(1, 4)}
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        tape_mod.air_eval_operands(gen, mats, gen.uniforms(rel, None), 4)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        stark.oods_dot(mat(3, 16), rng.integers(0, 1 << 31, (4, 4),
                                                dtype=np.uint32))
    tree = merkle.commit_matrix(from_u32(rng.integers(
        0, 1 << 31, (2, 8), dtype=np.uint32), "cpu"))
    tree.matrix = fake(tree.matrix)
    tree.layers = [fake(x) for x in tree.layers]
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        merkle.decommit_many_fused([(tree, [1, 6])])
    assert calls == [] and plain == []


def test_stream_wrappers_never_take_the_plain_path(monkeypatch):
    """The memory mode's wrappers (K10 leaves, K11 column sums, K12
    finalize, K7 over one of several row windows) launch their kernels
    on CUDA tensors and never call their plain versions."""
    import chip_smoke
    from nexus_zkvm_tpu_torch.air import component, tape as tape_mod
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.ops import blake2s, quotients
    from nexus_zkvm_tpu_torch.prover import stark
    import nexus_zkvm_tpu_torch as T

    comp = chip_smoke.make_components()[0]
    rel = draw_relations(T.Blake2sChannel(), stark._relation_widths(
        [component.component_info(comp)]))
    dom = tape_mod.domain_tape(comp, 2, rel)
    calls, fake = _fake_cuda_env(monkeypatch, tape_mod,
                                 "air_eval_composition_plain")
    plain = []
    monkeypatch.setattr(tape_mod, "air_eval_plain",
                        lambda *a, **k: plain.append(1))
    for mod, name in ((blake2s, "leaves_stream_plain"),
                      (quotients, "colsum_fold_plain"),
                      (quotients, "colsum_finalize_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain.append(_n))

    def zeros(*shape):
        return fake(torch.zeros(shape, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        blake2s.leaves_stream(None, zeros(16, 8), 0, 20, False)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        quotients.colsum_fold(zeros(2, 8, 4), zeros(3, 8), zeros(2, 3, 4),
                              True)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        quotients.colsum_finalize(zeros(2, 8, 4), zeros(8), zeros(8),
                                  zeros(2, 6, 4))
    N, L, hneg, hpos = 16, 4, 4, 4
    W = L + hneg + hpos
    mats = {tape_mod.MAIN: zeros(comp.n_main, W), tape_mod.PRE: None,
            tape_mod.INTER: zeros(4 * 64, W), tape_mod.ISF: zeros(1, W)}
    alpha = np.arange(4, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        tape_mod.air_eval_composition(
            dom, mats, dom.uniforms(rel, alpha), 4, L, hneg, alpha, alpha,
            zeros(N), zeros(N, 4))
    assert calls == [] and plain == []


def test_oods_groups_and_logup_never_take_the_plain_path(monkeypatch):
    """K8's one launch over many OODS groups (batches shared, rows
    chosen) and K6's LogUp columns launch their kernels on CUDA tensors
    and never call their plain versions."""
    from nexus_zkvm_tpu_torch.air import component
    from nexus_zkvm_tpu_torch.prover import stark
    from nexus_zkvm_tpu_torch.utils.device import from_u32

    calls, fake = _fake_cuda_env(monkeypatch, stark, "oods_dot_plain",
                                 "oods_dot_groups_plain")
    monkeypatch.setattr(component, "logup_columns_plain",
                        lambda *a, **k: calls.append("logup"))
    rng = np.random.default_rng(1)
    batch = fake(from_u32(rng.integers(0, 1 << 31, (5, 16), dtype=np.uint32),
                          "cpu"))
    factors = rng.integers(0, 1 << 31, (4, 4), dtype=np.uint32)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        stark.oods_dot_groups([(batch, None, factors),
                               (batch, [4, 1], factors)])
    src = fake(from_u32(rng.integers(1, 1 << 31, 40, dtype=np.uint32),
                        "cpu"))
    meta = torch.tensor([[[0, 1]], [[8, 3]], [[1, 0]], [[2, 2]]])
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        component.logup_columns(src, meta, 8)
    assert calls == []


def test_quotient_wrappers_never_take_the_plain_path(monkeypatch):
    """K3's DEEP quotients over role blocks (a stage across two roles)
    and K12's finalize launch their kernels on CUDA tensors and never
    call their plain versions."""
    from nexus_zkvm_tpu_torch.ops import quotients

    calls, fake = _fake_cuda_env(monkeypatch, quotients,
                                 "accumulate_blocks_plain",
                                 "colsum_finalize_plain")

    def zeros(*shape):
        return fake(torch.zeros(shape, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        quotients.accumulate_blocks([zeros(3, 8), zeros(14, 8)], zeros(8),
                                    zeros(8), zeros(2, 6, 4), zeros(2, 17, 4))
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        quotients.colsum_finalize(zeros(3, 8, 4), zeros(8), zeros(8),
                                  zeros(3, 6, 4))
    assert calls == []
