"""The port's RV32IM VM against the JAX package's.

The guests of examples/guests go through both packages' assembler and
two-pass emulator (`k_trace`): the program words, the View and every
array of the step record must be equal, on the Python emulator and on
the native C one.  The native emulator records no keccak state, so the
keccak guest runs on the Python backend only.
"""

from pathlib import Path

import numpy as np
import pytest

from nexus_zkvm_tpu.sdk import Guest as RGuest
from nexus_zkvm_tpu.sdk.io import encode_u32s
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
from nexus_zkvm_tpu_torch.sdk import Guest as TGuest
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace
from nexus_zkvm_tpu_torch.vm.native import native_available
import torch_cpu  # noqa: F401  (one torch thread a test process)

GUESTS = Path(__file__).resolve().parent.parent / "examples" / "guests"

# guest -> public input words
PROGRAMS = {
    "fib": (12,),
    "sort": (5, 3, 9, 1, 7, 2),
    "keccak": (2,),
}
CASES = [("fib", "python"), ("fib", "native"), ("sort", "python"),
         ("sort", "native"), ("keccak", "python")]


def same(a, b, path="") -> None:
    """Structural equality across the two packages' dataclasses."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            same(u, v, f"{path}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        same(vars(a), vars(b), path)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


def _trace(guest_cls, trace_fn, name, backend):
    g = guest_cls.from_asm((GUESTS / f"{name}.s").read_text())
    return g, trace_fn(g.program_words, entry=g.entry, rom_image=g.rom_image,
                       ram_image=g.ram_image,
                       public_input=encode_u32s(*PROGRAMS[name]),
                       backend=backend)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def traces(request):
    name, backend = request.param
    if backend == "native" and not native_available():
        pytest.skip("no C compiler for the native emulator")
    return (_trace(RGuest, rk_trace, name, backend),
            _trace(TGuest, tk_trace, name, backend))


def test_program_words_equal(traces):
    (rg, _), (tg, _) = traces
    assert list(rg.program_words) == list(tg.program_words)
    assert rg.entry == tg.entry


def test_view_equal(traces):
    (_, (rview, _)), (_, (tview, _)) = traces
    same(vars(rview), vars(tview), "view")
    assert tview.exit_code == 0


def test_step_record_equal(traces):
    (_, (_, rtrace)), (_, (_, ttrace)) = traces
    assert ttrace.n_steps == rtrace.n_steps > 0
    same(rtrace.steps, ttrace.steps, "steps")
    same(rtrace.machine_state, ttrace.machine_state, "machine_state")


@pytest.mark.parametrize("path", sorted(GUESTS.glob("*.s")),
                         ids=lambda p: p.stem)
def test_assembler_equal(path):
    src = path.read_text()
    assert tasm.assemble(src) == rasm.assemble(src)
