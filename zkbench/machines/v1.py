"""Machine v1 through the SDK: ``LocalProver.prove_with_input`` runs the
native emulator (scope ``emulate``), then ``machine.prove_machine``."""

from __future__ import annotations

__all__ = ["REFERENCE", "Entry"]

REFERENCE = "v1"       # the plain reference's verifier of this machine


class Entry:
    def __init__(self, cell, guest, pcs, device: str):
        from nexus_zkvm_tpu_torch.sdk import LocalProver
        self.prover = LocalProver(guest, config=pcs, device=device)

    def prove(self, public: bytes):
        """(View, proof) of one job."""
        return self.prover.prove_with_input(public_input=public)
