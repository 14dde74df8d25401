"""The RV32IM machine AIR — the flagship proving "model".

Counterpart of the reference provers (`nexus-zkvm/prover/src/`,
`prover2/`): turns a VM execution trace (`vm.Trace` + `vm.View`) into a
Circle-STARK proof via the generic `prover.stark` pipeline.

Architecture (TPU-first; differs from both reference generations):

* One wide **CPU component** holds fetch/exec-chain/register-access/
  ALU/branch/memory semantics for every step, with per-opcode one-hot
  flags gating shared constraint gadgets — like the reference's legacy
  machine (`prover/src/machine.rs:49-79`) but with **vectorized column
  fill** from the VM's struct-of-arrays trace instead of a row loop.
* Instruction decoding is *free*: the program is public, so the
  decoded program table (pc, opcode, registers, immediate) lives in
  **preprocessed** columns the verifier recomputes itself — replacing
  the reference's 1.9k-LoC in-circuit DecodingCheck chips
  (`prover/src/chips/decoding/`).
* Memory checking is multiset LogUp over (addr, value, ts) tuples with
  sorted-unique address tables (RamTouched / MemInit / OutputCheck /
  RegFile), following the prover2 component split
  (`prover2/machine/src/components/`).
* Range/bitwise semantics via preprocessed lookup tables (Range256/
  128/64/8, AND8/XOR8, SHL8/SHR8 byte-shift tables).
"""

from .driver import prove_machine, verify_machine, MachineProof

__all__ = ["prove_machine", "verify_machine", "MachineProof"]
