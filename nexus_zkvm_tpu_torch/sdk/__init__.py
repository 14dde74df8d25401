"""User-facing host API: load a guest, prove, verify, inspect IO.

Counterpart of the reference SDK (`nexus-zkvm/sdk/src/`):
``Stwo<Local>::compile/new/prove_with_input/verify`` and the
`Prover`/`Verifiable`/`Viewable` traits
(`sdk/src/stwo/seq.rs:51-167`, `sdk/src/traits.rs:225-440`).

Differences by design: this environment has no RISC-V Rust cross
toolchain, so "compilation" accepts (a) prebuilt riscv32im ELF
binaries, (b) RV32IM assembly via the built-in assembler, or (c) raw
instruction words.  Typed IO uses little-endian u32 word framing
(`encode_u32s`/`decode_u32s`) in place of the reference's
postcard/COBS serialization (`sdk/src/stwo/seq.rs:127-130`).
"""

from .guest import Guest
from .prover import LocalProver, prove, verify
from .io import encode_u32s, decode_u32s, decode_output
from .profile import profile
from .serialize import (proof_to_bytes, proof_from_bytes,
                        view_to_bytes, view_from_bytes,
                        bundle_to_bytes, bundle_from_bytes)

__all__ = ["Guest", "LocalProver", "prove", "verify", "profile",
           "encode_u32s", "decode_u32s", "decode_output",
           "proof_to_bytes", "proof_from_bytes",
           "view_to_bytes", "view_from_bytes",
           "bundle_to_bytes", "bundle_from_bytes"]
