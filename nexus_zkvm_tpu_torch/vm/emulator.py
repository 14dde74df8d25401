"""Two-pass RV32IM emulator with struct-of-arrays trace recording.

Counterpart of the reference's `HarvardEmulator` (pass 1, memory-usage
discovery) and `LinearEmulator` (pass 2, trace generation against an
optimized `LinearMemoryLayout`)
(`nexus-zkvm/vm/src/emulator/executor.rs:393-527,749-1115`).

Design differences (TPU-first):

* The trace is recorded straight into growable **struct-of-arrays**
  buffers (`TraceRecorder`) — one numpy array per field across all
  steps — because the machine AIR fills its columns with vectorized
  slices of these arrays, never a per-row loop.
* Register/RAM previous-access metadata (value, timestamp) is recorded
  at execution time from O(1) last-access tables, replacing the
  prover-side SideNote hashmap chase
  (`nexus-zkvm/prover/src/trace/sidenote/mod.rs:14-60`).

Register-access timestamps use the reference convention: the three
register slots of a step at clk have ts = 3*clk + {1, 2, 3}
(slot1 = rs1 read, slot2 = rs2 read, slot3 = rd write;
`nexus-zkvm/prover/src/trace/preprocessed.rs:25-120`).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .decoder import Instruction, decode_instruction
from .isa import (
    Opcode, InstrType, SyscallCode, WORD_SIZE, MEMORY_TOP,
)
from .memory import (
    LinearMemoryLayout, LinearMemory, MemoryError_, RO, RW, WO, NA,
)

__all__ = ["VMExited", "VMError", "HarvardEmulator", "LinearEmulator",
           "TraceRecorder"]

M32 = 0xFFFF_FFFF


class VMError(Exception):
    pass


class VMExited(Exception):
    def __init__(self, code: int):
        super().__init__(f"vm exited with code {code}")
        self.code = code


def _s32(x: int) -> int:
    return x - 0x1_0000_0000 if x & 0x8000_0000 else x


# ---------------------------------------------------------------------------
# Trace recording (struct-of-arrays)
# ---------------------------------------------------------------------------

_STEP_FIELDS = [
    ("clk", np.uint32), ("pc", np.uint32), ("next_pc", np.uint32),
    ("word", np.uint32), ("opcode", np.uint8),
    ("rd", np.uint8), ("rs1", np.uint8), ("rs2", np.uint8),
    ("imm", np.uint32),
    ("a_val", np.uint32),       # value written to rd (result), 0 if none
    ("b_val", np.uint32),       # rs1 value read
    ("c_val", np.uint32),       # rs2 value or immediate
    ("a_prev", np.uint32),      # rd previous value
    ("ts1_prev", np.uint32),    # previous access ts of rs1 / rs2 / rd
    ("ts2_prev", np.uint32),
    ("ts3_prev", np.uint32),
    ("rd_written", np.uint8),   # 1 if rd was written (rd != x0 and op writes)
    # memory access (loads/stores); addr=0 when none
    ("mem_addr", np.uint32),
    ("mem_size", np.uint8),     # 0 = no access, else 1/2/4
    ("mem_store", np.uint8),    # 1 = store
    ("mem_val", np.uint32),     # value loaded/stored (zero-extended)
    ("mem_prev_val", np.uint32),  # aligned word before the access
    ("mem_new", np.uint32),       # aligned word after the access
    ("mem_prev_ts", np.uint32),
]


class TraceRecorder:
    """Growable SoA step buffer."""

    def __init__(self, capacity: int = 1 << 12):
        self.n = 0
        self.cap = capacity
        self.buf = {name: np.zeros(capacity, dt) for name, dt in
                    _STEP_FIELDS}

    def _grow(self):
        self.cap *= 2
        for k in self.buf:
            b = np.zeros(self.cap, self.buf[k].dtype)
            b[:self.n] = self.buf[k]
            self.buf[k] = b

    def append(self, **fields):
        if self.n == self.cap:
            self._grow()
        i = self.n
        for k, v in fields.items():
            self.buf[k][i] = v
        self.n += 1

    def arrays(self) -> dict:
        return {k: v[:self.n].copy() for k, v in self.buf.items()}


# ---------------------------------------------------------------------------
# Emulator core
# ---------------------------------------------------------------------------

class _EmulatorBase:
    """Shared machinery: registers, clock, syscalls, instruction loop."""

    def __init__(self, public_input: bytes = b"",
                 private_input: bytes = b"", logs_capture: bool = True):
        self.regs = np.zeros(32, np.uint32)
        self.pc = 0
        self.global_clock = 1          # reference clock starts at 1
        self.private_input = deque(private_input)
        self.cycle_tracker: dict = {}
        self.logs: list = []
        self.logs_capture = logs_capture
        self.exit_code: int | None = None
        # last-access tables for memory checking
        self.reg_last_ts = np.zeros(32, np.uint64)
        self.basic_block_cache: dict = {}
        self.recorder: TraceRecorder | None = None
        self._pending_mem = None
        self.keccak_log: list = []

    # -- memory interface provided by subclasses -----------------------
    def fetch_word(self, addr: int) -> int:
        raise NotImplementedError

    def mem_read(self, addr: int, size: int) -> int:
        raise NotImplementedError

    def mem_write(self, addr: int, size: int, value: int):
        raise NotImplementedError

    def mem_prev(self, addr: int, size: int):
        """(prev_value, prev_ts) for the aligned access — overridden in
        the linear pass."""
        return 0, 0

    def mem_read_bytes(self, addr: int, n: int) -> bytes:
        return bytes(self.mem_read(addr + i, 1) for i in range(n))

    # -- instruction fetch/decode with basic-block cache ---------------
    def fetch_instruction(self, pc: int) -> Instruction:
        ins = self.basic_block_cache.get(pc)
        if ins is None:
            ins = decode_instruction(self.fetch_word(pc))
            self.basic_block_cache[pc] = ins
        return ins

    # -- the step ------------------------------------------------------
    def step(self):
        pc = self.pc
        ins = self.fetch_instruction(pc)
        opc = ins.opcode
        regs = self.regs
        clk = self.global_clock

        rs1, rs2, rd = ins.rs1, ins.rs2, ins.rd
        b_val = int(regs[rs1])
        next_pc = (pc + 4) & M32
        a_val = 0
        wrote = False
        exited = None
        mem = None     # (addr, size, is_store, value, prev_val, prev_ts)

        t = ins.itype
        if t == InstrType.R:
            c_val = int(regs[rs2])
            a_val = _ALU_R[opc](b_val, c_val)
            wrote = True
        elif t == InstrType.I:
            c_val = ins.imm
            if opc in _ALU_I:
                a_val = _ALU_I[opc](b_val, c_val)
                wrote = True
            elif opc == Opcode.JALR:
                a_val = next_pc
                next_pc = (b_val + _s32(c_val)) & M32 & ~1
                wrote = True
            elif opc == Opcode.FENCE:
                c_val = 0
            else:  # loads
                addr = (b_val + _s32(c_val)) & M32
                size = _LOAD_SIZE[opc]
                raw = self.mem_read(addr, size)
                prev_val, prev_ts = self.mem_prev(addr, size)
                if opc == Opcode.LB:
                    a_val = _s32_from(raw, 8)
                elif opc == Opcode.LH:
                    a_val = _s32_from(raw, 16)
                else:
                    a_val = raw
                wrote = True
                mem = (addr, size, 0, raw, prev_val, prev_ts)
        elif t == InstrType.S:
            c_val = int(regs[rs2])
            addr = (b_val + _s32(ins.imm)) & M32
            size = _STORE_SIZE[opc]
            prev_val, prev_ts = self.mem_prev(addr, size)
            value = c_val & ((1 << (8 * size)) - 1)
            self.mem_write(addr, size, value)
            mem = (addr, size, 1, value, prev_val, prev_ts)
        elif t == InstrType.B:
            c_val = int(regs[rs2])
            if _BRANCH[opc](b_val, c_val):
                next_pc = (pc + _s32(ins.imm)) & M32
        elif t == InstrType.J:
            c_val = ins.imm
            a_val = next_pc
            next_pc = (pc + _s32(ins.imm)) & M32
            wrote = True
        elif t == InstrType.U:
            c_val = ins.imm
            if opc == Opcode.LUI:
                a_val = c_val
            else:  # AUIPC
                a_val = (pc + c_val) & M32
            wrote = True
        elif t == InstrType.SYS:
            c_val = int(regs[rs2])
            if opc == Opcode.ECALL:
                self._pending_mem = None
                try:
                    wrote, a_val, rd = self.execute_syscall()
                except VMExited as e:
                    # record the halt step (next_pc = pc self-loop, the
                    # reference's IsSysHalt convention) before exiting
                    exited = e
                    next_pc = pc
                    wrote, a_val, rd = False, 0, 0
                mem = self._pending_mem
            # EBREAK: nop
        elif t == InstrType.CUSTOM:
            c_val = int(regs[rs2])
            wrote, a_val = self.execute_custom(ins, b_val, c_val)
        else:
            raise VMError(f"unimplemented instruction at {pc:#x}: "
                          f"{ins.word:#010x}")

        # register write-back + memory-check metadata.  Only the access
        # slots the machine AIR emits bump the last-access timestamps:
        # slot1 (rs1) always, slot2 (rs2) for R/S/B/ECALL/CUSTOM rows,
        # slot3 (rd) when the op class writes.
        uses_rs2 = t in (InstrType.R, InstrType.S, InstrType.B,
                         InstrType.CUSTOM) or opc == Opcode.ECALL
        ts1_prev = int(self.reg_last_ts[rs1])
        self.reg_last_ts[rs1] = 3 * clk + 1
        ts2_prev = 0
        if uses_rs2:
            ts2_prev = int(self.reg_last_ts[rs2])
            self.reg_last_ts[rs2] = 3 * clk + 2
        a_prev, ts3_prev = 0, 0
        if wrote:
            a_prev = int(regs[rd])
            ts3_prev = int(self.reg_last_ts[rd])
            self.reg_last_ts[rd] = 3 * clk + 3
            if rd != 0:
                regs[rd] = a_val
        rd_written = 1 if wrote else 0

        if self.recorder is not None:
            if mem is not None:
                m_addr, m_size, m_store, m_val, m_pv, m_pt = mem
                ofs = m_addr & 3
                w = m_addr & ~3
                if m_store:
                    lane_mask = ((1 << (8 * m_size)) - 1) << (8 * ofs)
                    m_new = (m_pv & ~lane_mask & M32) \
                        | ((m_val << (8 * ofs)) & lane_mask)
                else:
                    m_new = m_pv
            else:
                m_addr = m_size = m_store = m_val = m_pv = m_pt = 0
                m_new = 0
            self.recorder.append(
                clk=clk, pc=pc, next_pc=next_pc, word=ins.word,
                opcode=int(opc) if int(opc) < 256 else 255,
                rd=rd, rs1=rs1, rs2=rs2, imm=ins.imm,
                a_val=a_val if wrote else 0,
                b_val=b_val, c_val=c_val, a_prev=a_prev,
                ts1_prev=ts1_prev, ts2_prev=ts2_prev, ts3_prev=ts3_prev,
                rd_written=rd_written,
                mem_addr=m_addr, mem_size=m_size, mem_store=m_store,
                mem_val=m_val, mem_prev_val=m_pv, mem_new=m_new,
                mem_prev_ts=m_pt)

        self.pc = next_pc
        self.global_clock += 1
        if exited is not None:
            raise exited

    def execute(self, max_steps: int | None = None):
        """Run until exit; raises VMExited. Returns step count on limit."""
        steps = 0
        try:
            while max_steps is None or steps < max_steps:
                self.step()
                steps += 1
        except VMExited as e:
            self.exit_code = e.code
            raise
        return steps

    # -- custom instructions ------------------------------------------
    def execute_custom(self, ins: Instruction, b_val: int, c_val: int):
        if ins.opcode == Opcode.KECCAKF:
            from .keccak import keccak_f1600_words
            state = [self.mem_read(b_val + 4 * i, 4) for i in range(50)]
            # one recorded access pair per word: the AIR consumes the
            # pre-state at ts_prev and emits the post-state at clk
            prev_ts = []
            for i in range(50):
                _pv, pt = self.mem_prev(b_val + 4 * i, 4)
                prev_ts.append(pt)
            out = keccak_f1600_words(state)
            for i, w in enumerate(out):
                self.mem_write(b_val + 4 * i, 4, w)
            self.keccak_log.append({
                "clk": self.global_clock, "addr": b_val,
                "in_words": list(state), "out_words": list(out),
                "prev_ts": prev_ts,
            })
            return False, 0
        if ins.opcode == Opcode.PRECOMPILE:
            from ..precompiles import get as get_precompile
            p = get_precompile(ins.imm)
            if p is None:
                raise VMError(f"unregistered precompile {ins.imm}")
            val = p.native_call(self, b_val, c_val) & M32
            return p.writes_rd(), val
        raise VMError(f"unknown custom instruction {ins.word:#x}")

    # -- syscalls (`nexus-zkvm/vm/src/system/syscall.rs`) ---------
    def execute_syscall(self):
        """Returns (wrote, a0_value, result_register)."""
        regs = self.regs
        code = int(regs[17])  # a7
        a0, a1, a2 = int(regs[10]), int(regs[11]), int(regs[12])
        if code == SyscallCode.WRITE:
            if a0 == 1:
                buf = self.mem_read_bytes(a1, a2)
                if self.logs_capture:
                    self.logs.append(bytes(buf))
                return True, a2, 10
            return True, M32, 10
        if code == SyscallCode.EXIT:
            raise VMExited(a0)
        if code == SyscallCode.READ_PRIVATE_INPUT:
            v = self.private_input.popleft() if self.private_input else M32
            return True, v, 10
        if code == SyscallCode.CYCLE_COUNT:
            # never writes a register (uniform behavior keeps the AIR's
            # slot-3 multiplicity a pure function of the syscall flag)
            label = self.mem_read_bytes(a0, a1).decode("utf-8", "replace")
            marker, _, fn = label.partition("#")
            ent = self.cycle_tracker.get(fn)
            if marker == "^":
                if ent is None:
                    self.cycle_tracker[fn] = [self.global_clock, 1]
                else:
                    ent[1] += 1
            elif marker == "$" and ent is not None:
                ent[1] -= 1
                if ent[1] == 0:
                    ent[0] = self.global_clock - ent[0]
            return False, 0, 10
        if code == SyscallCode.OVERWRITE_STACK_POINTER:
            return True, self.stack_top(), 2
        if code == SyscallCode.OVERWRITE_HEAP_POINTER:
            return True, self.heap_start(), 10
        if code == SyscallCode.MEMORY_ADVISE:
            return False, 0, 10
        raise VMError(f"unimplemented syscall {code:#x} at {self.pc:#x}")

    def stack_top(self) -> int:
        return MEMORY_TOP

    def heap_start(self) -> int:
        return 0


def _s32_from(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return ((v ^ m) - m) & M32


# ALU semantic tables ------------------------------------------------------

def _sll(a, b):
    return (a << (b & 31)) & M32


def _srl(a, b):
    return (a & M32) >> (b & 31)


def _sra(a, b):
    return (_s32(a) >> (b & 31)) & M32


def _div(a, b):
    a, b = _s32(a), _s32(b)
    if b == 0:
        return M32
    if a == -0x8000_0000 and b == -1:
        return 0x8000_0000
    # round toward zero, as RISC-V requires
    return (abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)) & M32


def _rem(a, b):
    a, b = _s32(a), _s32(b)
    if b == 0:
        return a & M32
    if a == -0x8000_0000 and b == -1:
        return 0
    q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
    return (a - b * q) & M32


_ALU_R = {
    Opcode.ADD: lambda a, b: (a + b) & M32,
    Opcode.SUB: lambda a, b: (a - b) & M32,
    Opcode.SLL: _sll,
    Opcode.SLT: lambda a, b: int(_s32(a) < _s32(b)),
    Opcode.SLTU: lambda a, b: int(a < b),
    Opcode.XOR: lambda a, b: a ^ b,
    Opcode.SRL: _srl,
    Opcode.SRA: _sra,
    Opcode.OR: lambda a, b: a | b,
    Opcode.AND: lambda a, b: a & b,
    Opcode.MUL: lambda a, b: (a * b) & M32,
    Opcode.MULH: lambda a, b: (_s32(a) * _s32(b) >> 32) & M32,
    Opcode.MULHSU: lambda a, b: (_s32(a) * b >> 32) & M32,
    Opcode.MULHU: lambda a, b: (a * b >> 32) & M32,
    Opcode.DIV: _div,
    Opcode.DIVU: lambda a, b: M32 if b == 0 else a // b,
    Opcode.REM: _rem,
    Opcode.REMU: lambda a, b: a if b == 0 else a % b,
}

_ALU_I = {
    Opcode.ADDI: lambda a, i: (a + _s32(i)) & M32,
    Opcode.SLLI: _sll,
    Opcode.SLTI: lambda a, i: int(_s32(a) < _s32(i)),
    Opcode.SLTIU: lambda a, i: int(a < (i & M32)),
    Opcode.XORI: lambda a, i: a ^ (i & M32),
    Opcode.SRLI: _srl,
    Opcode.SRAI: _sra,
    Opcode.ORI: lambda a, i: a | (i & M32),
    Opcode.ANDI: lambda a, i: a & (i & M32),
}

_BRANCH = {
    Opcode.BEQ: lambda a, b: a == b,
    Opcode.BNE: lambda a, b: a != b,
    Opcode.BLT: lambda a, b: _s32(a) < _s32(b),
    Opcode.BGE: lambda a, b: _s32(a) >= _s32(b),
    Opcode.BLTU: lambda a, b: a < b,
    Opcode.BGEU: lambda a, b: a >= b,
}

_LOAD_SIZE = {Opcode.LB: 1, Opcode.LBU: 1, Opcode.LH: 2, Opcode.LHU: 2,
              Opcode.LW: 4}
_STORE_SIZE = {Opcode.SB: 1, Opcode.SH: 2, Opcode.SW: 4}


# ---------------------------------------------------------------------------
# Pass 1: Harvard (discovery)
# ---------------------------------------------------------------------------

class HarvardEmulator(_EmulatorBase):
    """Separate instruction/data memories; unbounded dict-backed RAM.

    Purpose (reference `executor.rs:393-527`): run the program once to
    discover memory usage (max heap / min stack), capture the output,
    and validate execution — the trace pass then uses an optimized
    linear layout.
    """

    def __init__(self, program_words, base: int, entry: int,
                 rom_image: dict | None = None,
                 ram_image: dict | None = None,
                 public_input: bytes = b"", private_input: bytes = b"",
                 ad: bytes = b""):
        super().__init__(public_input, private_input)
        self.base = base
        self.prog = {base + 4 * i: int(w) & M32
                     for i, w in enumerate(program_words)}
        self.rom = dict(rom_image or {})        # addr -> byte (RO data)
        self.ram = dict(ram_image or {})        # addr -> byte (RW data)
        self.pc = entry
        self.ad = ad
        # public input tape: dict bytes at a fixed region after ROM
        self.input_base = 0
        self.output_base = 0
        self.output_size_hint = 0
        self.public_input_bytes = public_input
        self._install_io(public_input)
        self.min_stack = MEMORY_TOP
        self.max_heap = 0
        self.regs[2] = MEMORY_TOP       # sp
        self.output: dict = {}          # addr offset -> byte
        self.exit_code_val = 0

    def _install_io(self, public_input: bytes):
        """Place the length-prefixed input tape above all images."""
        top = max([a for a in self.prog] +
                  [a for a in self.rom] + [a for a in self.ram] + [0x1000])
        self.input_base = (top + 4 + 0xFFF) & ~0xFFF
        n = len(public_input)
        tape = (n.to_bytes(4, "little") + public_input)
        for i, b in enumerate(tape):
            self.rom[self.input_base + i] = b
        self.output_base = (self.input_base + 4 + n + 0xFFF) & ~0xFFF
        # Discovery-pass heap: above every installed image/region so an
        # ecall 0x403 guest can never clobber the IO sentinels or tape
        # (reference gives Harvard a variable RW memory; the trace pass
        # re-bases the heap from the layout — `layout.rs:117-157`).
        self.heap_base = (self.output_base + 0x1_0000 + 0xFFF) & ~0xFFF
        # IO sentinels at fixed low addresses
        for i, b in enumerate(self.input_base.to_bytes(4, "little")):
            self.rom[0x80 + i] = b
        for i, b in enumerate(self.output_base.to_bytes(4, "little")):
            self.rom[0x84 + i] = b

    def fetch_word(self, addr: int) -> int:
        try:
            return self.prog[addr]
        except KeyError:
            raise VMError(f"instruction fetch outside program at "
                          f"{addr:#x}")

    def mem_read(self, addr: int, size: int) -> int:
        if addr % size:
            raise MemoryError_(f"unaligned read at {addr:#x}")
        out = 0
        for i in range(size):
            a = addr + i
            if a in self.ram:
                b = self.ram[a]
            elif a in self.rom:
                b = self.rom[a]
            elif a in self.prog or (a & ~3) in self.prog:
                b = (self.prog[a & ~3] >> (8 * (a & 3))) & 0xFF
            else:
                b = 0
            out |= b << (8 * i)
        self._track(addr)
        return out

    def mem_write(self, addr: int, size: int, value: int):
        if addr % size:
            raise MemoryError_(f"unaligned write at {addr:#x}")
        for i in range(size):
            self.ram[addr + i] = (value >> (8 * i)) & 0xFF
        self._track(addr)

    def _track(self, addr: int):
        sp = int(self.regs[2])
        if addr >= sp:
            self.min_stack = min(self.min_stack, addr)
        else:
            self.max_heap = max(self.max_heap, addr)

    def heap_start(self) -> int:
        return self.heap_base

    def execute_syscall(self):
        code = int(self.regs[17])
        if code == SyscallCode.EXIT:
            self.exit_code_val = int(self.regs[10])
        return super().execute_syscall()


# ---------------------------------------------------------------------------
# Pass 2: Linear (trace generation)
# ---------------------------------------------------------------------------

class LinearEmulator(_EmulatorBase):
    """Unified linear memory with RO/RW/WO/NA protections + trace hooks.

    Reference: `nexus-zkvm/vm/src/emulator/executor.rs:749-1115`.
    The Exit syscall additionally writes its code into the exit-code
    word of the output region so the final-RAM claim covers it (the
    reference reaches the same end state through the guest runtime).
    """

    def __init__(self, layout: LinearMemoryLayout, program_words,
                 entry: int, rom_image: dict | None = None,
                 ram_image: dict | None = None,
                 public_input: bytes = b"", private_input: bytes = b"",
                 ad: bytes = b"", record: bool = True):
        super().__init__(public_input, private_input)
        self.layout = layout
        self.mem = LinearMemory(layout.end)
        self.pc = entry
        self.entry = entry
        self.ad = ad
        self.program_words = [int(w) & M32 for w in program_words]
        lay = layout

        m = self.mem
        m.add_segment(lay.program_start, lay.program_end, RO)
        m.add_segment(lay.public_input_start, lay.public_input_end, RO)
        # exit code + public output are write-only to the guest
        m.add_segment(lay.exit_code, lay.public_output_end, WO)
        m.add_segment(lay.heap_start, lay.heap_end, RW)
        m.add_segment(lay.stack_bottom, lay.stack_top, RW)

        # program image
        base = lay.program_start
        for i, w in enumerate(self.program_words):
            m.fill(base + 4 * i, int(w).to_bytes(4, "little"))
        self.prog_end_addr = base + 4 * len(self.program_words)
        for addr, byte in (rom_image or {}).items():
            m.fill(addr, bytes([byte]))
        self.rom_init = dict(rom_image or {})
        self.ram_init = dict(ram_image or {})
        for addr, byte in self.ram_init.items():
            m.fill(addr, bytes([byte]))
        if rom_image or ram_image:
            img_end = max(list(rom_image or {}) + list(self.ram_init)) + 1
            if img_end > self.prog_end_addr:
                # static data region: readable and writable (static ram)
                m.add_segment(self.prog_end_addr, lay.program_end, RW)

        # IO sentinels (read-only, below program start)
        m.add_segment(0, lay.program_start, RO)
        m.fill(lay.public_input_address_location,
               int(lay.public_input_start).to_bytes(4, "little"))
        m.fill(lay.public_output_address_location,
               int(lay.public_output_start).to_bytes(4, "little"))
        # length-prefixed public input
        m.fill(lay.public_input_start,
               len(public_input).to_bytes(4, "little") + public_input)
        self.public_input_bytes = public_input

        self.regs[2] = lay.stack_top    # sp

        # per-word last-access (value is in memory; track timestamps)
        self.ram_last_ts: dict = {}
        if record:
            self.recorder = TraceRecorder()

    def stack_top(self) -> int:
        return int(self.layout.stack_top)

    def heap_start(self) -> int:
        return int(self.layout.heap_start)

    @staticmethod
    def from_harvard(harv: "HarvardEmulator", program_words, entry,
                     rom_image=None, ram_image=None, public_input=b"",
                     private_input=b"", ad=b"",
                     public_output_size: int = 0x200):
        """Build the trace pass with a layout sized by pass-1 stats
        (reference `MemoryStats::create_optimized_layout`,
        `nexus-zkvm/vm/src/emulator/memory_stats.rs`)."""
        prog_size = _word_align_up(4 * len(program_words) + 0x1000)
        heap_size = _word_align_up(max(harv.max_heap + 0x1000, 0x1_0000))
        stack_size = 0x10_0000
        layout = LinearMemoryLayout.new(
            max_heap_size=heap_size, max_stack_size=stack_size,
            public_input_size=len(public_input),
            public_output_size=public_output_size,
            program_size=prog_size, ad_size=_word_align_up(len(ad)))
        return LinearEmulator(layout, program_words, entry,
                              rom_image=rom_image, ram_image=ram_image,
                              public_input=public_input,
                              private_input=private_input, ad=ad)

    # -- memory interface ---------------------------------------------
    def fetch_word(self, addr: int) -> int:
        lay = self.layout
        if not (lay.program_start <= addr < self.prog_end_addr):
            raise VMError(f"instruction fetch outside program at "
                          f"{addr:#x}")
        return int.from_bytes(self.mem.data[addr:addr + 4], "little")

    def mem_read(self, addr: int, size: int) -> int:
        return self.mem.read(addr, size)

    def mem_write(self, addr: int, size: int, value: int):
        self.mem.write(addr, size, value)

    def mem_prev(self, addr: int, size: int):
        """Previous (value, ts) of the aligned word containing addr."""
        w = addr & ~3
        prev_ts = self.ram_last_ts.get(w, 0)
        prev_val = int.from_bytes(self.mem.data[w:w + 4], "little")
        self.ram_last_ts[w] = self.global_clock
        return prev_val, prev_ts

    def mem_read_bytes(self, addr: int, n: int) -> bytes:
        return self.mem.read_bytes_unchecked(addr, n)

    def execute_syscall(self):
        code = int(self.regs[17])
        if code == SyscallCode.EXIT:
            # the halt step stores the exit code as a regular recorded
            # memory access so the AIR's RAM chain covers it
            a0 = int(self.regs[10]) & M32
            addr = self.layout.exit_code
            prev_val, prev_ts = self.mem_prev(addr, 4)
            self.mem.write(addr, 4, a0)
            self._pending_mem = (addr, 4, 1, a0, prev_val, prev_ts)
        return super().execute_syscall()

    def machine_state(self) -> dict:
        """Final register/RAM state for the machine AIR's boundary
        components (FinalReg / RamInitFinal counterpart data)."""
        words = {}
        for w, ts in self.ram_last_ts.items():
            val = int.from_bytes(self.mem.data[w:w + 4], "little")
            words[int(w)] = (val, int(ts))
        return {
            "final_regs": self.regs.copy(),
            "final_reg_ts": self.reg_last_ts.copy(),
            "ram_final": words,
            "keccak_log": list(self.keccak_log),
        }

    # -- finalize: the public IO claim --------------------------------
    def finalize(self):
        from .trace import View, ProgramInfo
        lay = self.layout
        exit_word = int.from_bytes(
            self.mem.data[lay.exit_code:lay.exit_code + 4], "little")
        out = bytes(self.mem.data[lay.public_output_start:
                                  lay.public_output_end])
        program = [(lay.program_start + 4 * i, w)
                   for i, w in enumerate(self.program_words)]
        return View(
            memory_layout=lay,
            program_info=ProgramInfo(initial_pc=self.entry,
                                     program=program),
            public_input=self.public_input_bytes,
            exit_code=exit_word,
            public_output=out,
            associated_data=self.ad,
            debug_logs=list(self.logs),
            initial_memory=self._initial_memory_entries(),
        )

    def _initial_memory_entries(self):
        """(address, byte) list of the initial RO+RW images the prover
        commits (program handled separately)."""
        lay = self.layout
        entries = []
        tape = (len(self.public_input_bytes).to_bytes(4, "little")
                + self.public_input_bytes)
        for i, b in enumerate(tape):
            entries.append((lay.public_input_start + i, b))
        for i in range(8):
            entries.append((lay.public_input_address_location + i,
                            self.mem.data[
                                lay.public_input_address_location + i]))
        # static images: RO data (rom) and RW data (ram) both belong to
        # the public claim -- a guest reading its .rodata must find the
        # bytes in the committed MemInit image
        statics = dict(self.rom_init)
        statics.update(self.ram_init)
        for addr, byte in sorted(statics.items()):
            entries.append((addr, byte))
        return entries


def _word_align_up(x: int) -> int:
    return (x + 3) & ~3
