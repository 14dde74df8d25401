"""machine2, which has no SDK entry: the SDK's emulator under a scope
``emulate`` that the harness opens, then ``machine2.prove_machine2``."""

from __future__ import annotations

__all__ = ["REFERENCE", "Entry"]

REFERENCE = "m2"


class Entry:
    def __init__(self, cell, guest, pcs, device: str):
        from nexus_zkvm_tpu_torch.sdk import LocalProver
        self.prover = LocalProver(guest, config=pcs, device=device)
        self.device = device

    def prove(self, public: bytes):
        from nexus_zkvm_tpu_torch.machine2 import prove_machine2
        from nexus_zkvm_tpu_torch.utils.device import resolve_device
        from nexus_zkvm_tpu_torch.utils.profile import scope
        resolve_device(self.device)
        with scope("emulate"):
            view, trace = self.prover.trace(public_input=public)
        return view, prove_machine2(view, trace, self.prover.config,
                                    device=self.device)
