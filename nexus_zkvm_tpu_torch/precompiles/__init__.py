"""Precompile framework: pluggable custom instructions.

Counterpart of the reference `precompiles/` crate
(`nexus-zkvm/precompiles/src/traits.rs:38-46`,
`use_precompiles!` macro at `precompiles/macros/src/lib.rs:34-60`):
a precompile is a custom R-type instruction with (1) native execution
semantics in the emulator, (2) optionally an AIR component proving it
(the builtin `keccakf` instruction + `machine/keccak.py` is the fully
proven example), and (3) ELF metadata (`PRECOMPILE_<i>` symbols) that
binds guest-declared precompile indices to implementations.

Encoding: custom-0 opcode space (0x0B) with the precompile index in
funct7*8 + funct3 (up to 1024 precompiles, mirroring the reference's
10-bit index).  The decoder surfaces these as `Opcode.PRECOMPILE`
instructions with the index in `imm`.
"""

from __future__ import annotations

__all__ = ["Precompile", "register", "get", "registry", "DummyDiv",
           "DummyHash", "PRECOMPILE_OP7"]

PRECOMPILE_OP7 = 0x0B


class Precompile:
    """Base class for custom instructions.

    Subclasses implement `native_call`; provers that should cover the
    instruction also provide `component()`/`fill()` (see the builtin
    keccak circuit for the pattern).
    """
    index: int = -1
    name = "precompile"

    def native_call(self, emulator, b_val: int, c_val: int) -> int:
        """Execute on the host; returns the rd result value (or 0)."""
        raise NotImplementedError

    def writes_rd(self) -> bool:
        return True

    def metadata(self) -> dict:
        return {"name": self.name, "index": self.index}


_REGISTRY: dict = {}


def register(p: Precompile):
    assert 0 <= p.index < 1024
    _REGISTRY[p.index] = p
    return p


def get(index: int) -> Precompile | None:
    return _REGISTRY.get(index)


def registry() -> dict:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Example precompiles (reference `precompiles/examples/`)
# ---------------------------------------------------------------------------

class DummyDiv(Precompile):
    """rd = rs1 / rs2 (0 on zero divisor) — the reference's dummy_div
    example (`nexus-zkvm/precompiles/examples/dummy_div`)."""
    index = 0
    name = "dummy_div"

    def native_call(self, emulator, b_val: int, c_val: int) -> int:
        return (b_val // c_val) if c_val else 0


class DummyHash(Precompile):
    """rd = fnv1a(rs1 ^ rs2) — stand-in for the dummy_hash example."""
    index = 1
    name = "dummy_hash"

    def native_call(self, emulator, b_val: int, c_val: int) -> int:
        h = 0x811C9DC5
        for byte in (b_val ^ c_val).to_bytes(4, "little"):
            h = ((h ^ byte) * 0x01000193) & 0xFFFFFFFF
        return h


register(DummyDiv())
register(DummyHash())
