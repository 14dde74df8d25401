"""Minimal ELF32 loader for riscv32im guest binaries.

Counterpart of the reference ELF loader/parser
(`nexus-zkvm/vm/src/elf/loader.rs:56-124`,
`vm/src/elf/parser.rs:63,310-428`): extracts the executable word image,
read-only and read-write data images, entry point, and the
`.note.nexus-precompiles`-style precompile metadata symbols
(``PRECOMPILE_<i>``).

Implemented with `struct` directly (no pyelftools in this image).
Only what guest binaries need: little-endian ELF32, program headers
for loadable segments, section headers + symtab for metadata symbols.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = ["ElfFile"]

_EHDR = struct.Struct("<16sHHIIIIIHHHHHH")
_PHDR = struct.Struct("<IIIIIIII")
_SHDR = struct.Struct("<IIIIIIIIII")
_SYM = struct.Struct("<IIIBBH")

PT_LOAD = 1
PF_X = 1
PF_W = 2
SHT_SYMTAB = 2
SHT_STRTAB = 3


@dataclass
class ElfFile:
    """Parsed guest binary (reference `ElfFile`, `loader.rs:56-99`)."""
    instructions: list                  # u32 words of the executable image
    base: int                           # vaddr of instructions[0]
    entry: int
    rom_image: dict = field(default_factory=dict)   # addr -> byte (RO)
    ram_image: dict = field(default_factory=dict)   # addr -> byte (RW)
    nexus_metadata: dict = field(default_factory=dict)  # sym -> value

    @staticmethod
    def from_path(path: str) -> "ElfFile":
        with open(path, "rb") as f:
            return ElfFile.from_bytes(f.read())

    @staticmethod
    def from_bytes(data: bytes) -> "ElfFile":
        (ident, etype, machine, _ver, entry, phoff, shoff, _flags,
         _ehsize, phentsize, phnum, shentsize, shnum, shstrndx) = \
            _EHDR.unpack_from(data, 0)
        if ident[:4] != b"\x7fELF":
            raise ValueError("not an ELF file")
        if ident[4] != 1 or ident[5] != 1:
            raise ValueError("need little-endian ELF32")
        if machine != 0xF3:
            raise ValueError(f"not a RISC-V binary (machine={machine})")

        instructions: list = []
        base = None
        rom: dict = {}
        ram: dict = {}
        for i in range(phnum):
            (ptype, off, vaddr, _pa, filesz, memsz, flags, _align) = \
                _PHDR.unpack_from(data, phoff + i * phentsize)
            if ptype != PT_LOAD:
                continue
            content = data[off:off + filesz]
            if flags & PF_X:
                if base is None:
                    base = vaddr
                    instructions = list(
                        struct.unpack_from(f"<{filesz // 4}I", content))
                else:
                    # second executable segment: extend contiguously
                    gap = (vaddr - (base + 4 * len(instructions))) // 4
                    instructions.extend([0] * gap)
                    instructions.extend(
                        struct.unpack_from(f"<{filesz // 4}I", content))
            else:
                img = ram if flags & PF_W else rom
                for j, b in enumerate(content):
                    img[vaddr + j] = b
                for j in range(filesz, memsz):   # .bss zero-fill
                    img[vaddr + j] = 0

        metadata = _parse_symbols(data, shoff, shentsize, shnum)
        return ElfFile(instructions=instructions, base=base or 0,
                       entry=entry, rom_image=rom, ram_image=ram,
                       nexus_metadata=metadata)


def _parse_symbols(data: bytes, shoff: int, shentsize: int,
                   shnum: int) -> dict:
    """Collect `PRECOMPILE_*` symbol values
    (reference `parse_precompile_metadata`, `parser.rs:310-428`)."""
    out: dict = {}
    if not shoff:
        return out
    sections = [_SHDR.unpack_from(data, shoff + i * shentsize)
                for i in range(shnum)]
    for sh in sections:
        (_name, stype, _flags, _addr, off, size, link, _info,
         _align, entsize) = sh
        if stype != SHT_SYMTAB or entsize == 0:
            continue
        str_off = sections[link][4]
        str_size = sections[link][5]
        strtab = data[str_off:str_off + str_size]
        for j in range(size // entsize):
            name_off, value, _sz, _info2, _other, _shndx = \
                _SYM.unpack_from(data, off + j * entsize)
            end = strtab.find(b"\0", name_off)
            name = strtab[name_off:end].decode("utf-8", "replace")
            if name.startswith("PRECOMPILE_"):
                out[name] = value
    return out
