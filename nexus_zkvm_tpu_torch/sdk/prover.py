"""LocalProver: emulate -> trace -> prove -> verify on this host.

Counterpart of `Stwo<Local>` (`nexus-zkvm/sdk/src/stwo/seq.rs:
51-167`): `prove_with_input` runs the two-pass emulator and the machine
prover; `verify` rebuilds everything from the public View.  Proving runs
on ``device`` (default ``"cuda"``, which raises without a card; pass
``device="cpu"`` for the plain PyTorch path).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..machine import prove_machine, verify_machine, MachineProof
from ..prover import PcsConfig
from ..utils.device import resolve_device
from ..utils.profile import scope
from ..vm import k_trace
from .guest import Guest

__all__ = ["LocalProver", "prove", "verify"]


@dataclass
class LocalProver:
    guest: Guest
    config: PcsConfig = None
    backend: str = "auto"        # emulator backend: python|native|auto
    device: str = "cuda"

    def __post_init__(self):
        if self.config is None:
            self.config = PcsConfig()

    def trace(self, public_input: bytes = b"", private_input: bytes = b"",
              associated_data: bytes = b"", max_steps=None):
        """Emulate only: returns (View, Trace)."""
        g = self.guest
        return k_trace(g.program_words, entry=g.entry,
                       rom_image=g.rom_image, ram_image=g.ram_image,
                       public_input=public_input,
                       private_input=private_input,
                       ad=associated_data, max_steps=max_steps,
                       backend=self.backend)

    def prove_with_input(self, public_input: bytes = b"",
                         private_input: bytes = b"",
                         associated_data: bytes = b""):
        """Returns (View, MachineProof)."""
        resolve_device(self.device)          # before the emulator runs
        with scope("emulate"):
            view, trace = self.trace(public_input, private_input,
                                     associated_data)
        proof = prove_machine(view, trace, self.config, device=self.device)
        return view, proof

    def verify(self, view, proof: MachineProof) -> bool:
        return verify_machine(view, proof, self.config, device=self.device)


def prove(guest: Guest, public_input: bytes = b"",
          private_input: bytes = b"", config: PcsConfig = None,
          device="cuda"):
    return LocalProver(guest, config, device=device).prove_with_input(
        public_input, private_input)


def verify(view, proof: MachineProof, config: PcsConfig = None,
           device="cuda") -> bool:
    return verify_machine(view, proof, config or PcsConfig(),
                          device=device)
