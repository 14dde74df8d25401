"""Guest runtime library: start code, allocator, and IO helpers.

TPU-native counterpart of the reference guest runtime crate
(`nexus-zkvm/runtime/src/runtime.rs:57-105` start code,
`runtime/src/alloc.rs:20-76` bump allocator, `runtime/src/io.rs`
IO helpers).  The reference ships a Rust `no_std` crate linked into
cross-compiled guests; this environment has no RISC-V cross toolchain,
so guests are written against the in-tree assembler (`vm/asm.py`) and
the runtime is an assembly *prelude + library* spliced around the
guest's ``main``:

* ``_start`` — asks the VM for the stack top (`SYS_OVERWRITE_SP`,
  0x402), sets ``fp``, zeroes the heap cursor, calls ``main``, and
  exits with ``main``'s return value (a0) as the exit code.
* ``rt_alloc`` — word-aligned bump allocator: first call fetches the
  heap base from the VM (`SYS_HEAP_START`, 0x403); the cursor lives in
  the reserved register ``s11`` (guests must not clobber it), and each
  allocation is advised to the VM (0x405) like the reference's
  `SYS_PERFORM_HEAP_ALLOCATION`.
* ``rt_log`` / ``rt_read_private`` / ``rt_cycle_mark`` / ``rt_exit`` —
  ecall wrappers mirroring `runtime/src/io.rs:14-56`.
* ``rt_input_len`` / ``rt_input_word`` / ``rt_output_word`` — public
  IO via the sentinel pointers (`vm/memory.py`): input is
  length-prefixed at ``[0x80]``, output words live at ``[0x84]``.

Register conventions: ``ra`` call/return, arguments and results in
``a0..a2``, ``t0..t2`` caller-saved scratch, ``s11`` reserved for the
heap cursor.

Usage::

    from nexus_zkvm_tpu_torch.vm import runtime, k_trace
    words = runtime.assemble_guest('''
    main:
        addi a0, zero, 40
        call rt_output_word_0     # or: rt_output_word with index
        addi a0, zero, 0          # exit code
        ret
    ''')
    view, trace = k_trace(words)
"""

from __future__ import annotations

from . import asm
from .isa import ELF_TEXT_START

__all__ = ["assemble_guest", "CRT0", "RUNTIME_LIB"]

CRT0 = """
_start:
    addi a7, zero, 0x402      # SYS_OVERWRITE_SP: VM writes sp directly
    ecall
    mv   fp, sp
    addi s11, zero, 0         # heap cursor: uninitialized
    call main
    addi a7, zero, 0x201      # SYS_EXIT(a0 = main's return value)
    ecall
"""

RUNTIME_LIB = """
# ---- runtime library (see nexus_zkvm_tpu/vm/runtime.py) ----
rt_exit:                      # a0 = exit code; never returns
    addi a7, zero, 0x201
    ecall

rt_alloc:                     # a0 = bytes -> a0 = word-aligned ptr
    mv   t1, a0
    bnez s11, rt_alloc_have_heap
    addi a7, zero, 0x403      # SYS_HEAP_START -> a0
    ecall
    mv   s11, a0
rt_alloc_have_heap:
    addi t0, s11, 3           # word-align the cursor
    srli t0, t0, 2
    slli t0, t0, 2
    mv   a0, t0
    add  s11, t0, t1          # bump
    mv   a1, t1
    addi a7, zero, 0x405      # advise the VM of (ptr, bytes)
    ecall
    ret

rt_log:                       # a0 = ptr, a1 = len -> a0 = written
    mv   a2, a1
    mv   a1, a0
    addi a0, zero, 1          # fd 1
    addi a7, zero, 0x200      # SYS_LOG
    ecall
    ret

rt_read_private:              # -> a0 = next byte, or 0xFFFFFFFF
    addi a7, zero, 0x400
    ecall
    ret

rt_cycle_mark:                # a0 = label ptr, a1 = len ("^f"/"$f")
    addi a7, zero, 0x401
    ecall
    ret

rt_input_len:                 # -> a0 = public input byte length
    lw   t0, 0x80(zero)
    lw   a0, 0(t0)
    ret

rt_input_word:                # a0 = word index -> a0 = input word
    lw   t0, 0x80(zero)
    slli t1, a0, 2
    add  t0, t0, t1
    lw   a0, 4(t0)            # word 0 is the length prefix
    ret

rt_output_word:               # a0 = word index, a1 = value
    lw   t0, 0x84(zero)
    slli t2, a0, 2
    add  t0, t0, t2
    sw   a1, 0(t0)
    ret
"""


def assemble_guest(source: str, base: int = ELF_TEXT_START) -> list:
    """Assemble a guest written against the runtime: ``CRT0`` +
    user source (must define ``main``) + ``RUNTIME_LIB``, with labels
    resolving across all three. Returns u32 words loadable at
    ``base`` (``k_trace``'s default)."""
    if "main" not in source:
        raise ValueError("guest source must define a 'main:' label")
    return asm.assemble(CRT0 + source + RUNTIME_LIB, base=base)
