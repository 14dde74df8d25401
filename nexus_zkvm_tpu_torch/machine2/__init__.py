"""machine2: the per-instruction-family prover generation.

Counterpart of the reference's second prover generation (`prover2/`,
`nexus-zkvm/prover2/machine/src/lib.rs:9-65`): instead of one
monolithic CPU component whose ~190 columns every row pays for, the
execution trace is split into **per-instruction-family components**
(ALU adds, bitwise, shifts, compares, branches, jumps, loads, stores,
syscalls, M-ext / keccak / precompile dispatch), each sized to the
power of two of its own step count and carrying only the columns that
family needs (35-60).

The families connect through the same LogUp relations the monolithic
machine uses: `exec` (clk, pc continuation; reference analogue
`ProgramExecution`, `prover2/machine/src/lookups/relations.rs:1-95`),
`reg`, `mem`, `prog` and the range / bitwise / shift tables, so the
memory-side components (`machine/memside.py`), the M-extension /
keccak / precompile circuits and the lookup tables are shared unchanged
between the two generations.

The family fills are host numpy; the proof goes through the same
`prover.prove`, so each family's constraints run as constraint tapes
(kernel K7 on the card) and its LogUp columns through kernel K6.
"""

from .driver import (prove_machine2, verify_machine2, build_machine2_traces,
                     build_components2)
from .exec_components import EXEC_FAMILIES

__all__ = ["prove_machine2", "verify_machine2", "build_machine2_traces",
           "build_components2", "EXEC_FAMILIES"]
