"""Guest programs: ELF binaries, assembly, or raw instruction words.

Counterpart of the reference's guest-compilation entry points
(`nexus-zkvm/sdk/src/compile/mod.rs:27-75` + `ElfFile` loading at
`vm/src/elf/loader.rs:100-124`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..vm import asm as _asm
from ..vm.elf import ElfFile
from ..vm.isa import ELF_TEXT_START

__all__ = ["Guest"]


@dataclass
class Guest:
    program_words: list
    entry: int = ELF_TEXT_START
    rom_image: dict = field(default_factory=dict)
    ram_image: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)

    @staticmethod
    def from_asm(source: str, runtime: bool | str = "auto") -> "Guest":
        """Assemble RV32IM source (see `vm.asm` for the dialect).

        runtime=True (or "auto" with a ``main:`` label present and no
        ``_start``) splices in the guest runtime prelude/library
        (`vm/runtime.py`): start code, allocator, and the ``rt_*`` IO
        helpers — the counterpart of linking the reference's
        `nexus-rt` crate into a guest."""
        import re
        if runtime == "auto":
            runtime = (re.search(r"^\s*main\s*:", source, re.M)
                       is not None
                       and "_start" not in source)
        if runtime:
            from ..vm.runtime import assemble_guest
            return Guest(program_words=assemble_guest(source))
        # guests always load at ELF_TEXT_START; assembling at the real
        # base makes absolute addressing (`la`, `.word` data) correct
        return Guest(program_words=_asm.assemble(source,
                                                 base=ELF_TEXT_START))

    @staticmethod
    def from_words(words) -> "Guest":
        return Guest(program_words=[int(w) & 0xFFFFFFFF for w in words])

    @staticmethod
    def from_elf(path_or_bytes) -> "Guest":
        if isinstance(path_or_bytes, (bytes, bytearray)):
            elf = ElfFile.from_bytes(bytes(path_or_bytes))
        else:
            elf = ElfFile.from_path(str(path_or_bytes))
        return Guest(program_words=list(elf.instructions),
                     entry=elf.entry,
                     rom_image=dict(elf.rom_image),
                     ram_image=dict(elf.ram_image),
                     metadata=dict(elf.nexus_metadata))
