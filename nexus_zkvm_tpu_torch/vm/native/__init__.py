"""ctypes binding + build for the native C trace-pass emulator.

The shared library is compiled on demand with the system C compiler
(`cc -O2`); the Python `LinearEmulator` remains the reference
implementation and the golden source for the parity tests
(tests/test_native_vm.py).
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess

import numpy as np

__all__ = ["native_available", "run_native"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "emulator.c")
_LIB = os.path.join(_DIR, "libnexusvm.so")
_lib = None


def _build() -> bool:
    try:
        if (os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return True
        subprocess.run(
            ["cc", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True, capture_output=True)
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = C.CDLL(_LIB)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.nexus_vm_run.restype = C.c_long
    lib.nexus_vm_run.argtypes = [
        u8p, u8p, C.c_uint32,                      # mem, mode, end
        C.c_uint32, C.c_uint32,                    # prog start/end
        u8p, u8p, u8p, u8p, u8p, u32p, u32p,       # decode cache
        C.c_uint32, C.c_uint32, C.c_uint32,        # exit/heap/stack
        C.c_uint32,                                # entry
        u8p, C.c_uint32,                           # priv
        u8p, C.c_uint32, u32p, C.c_uint32,         # logs
        u32p,                                      # ram_ts
        u32p, u64p, u32p,                          # regs, reg_ts, stats
        C.c_int,                                   # record
        u32p, u32p, u32p, u32p, u32p, C.c_long,    # keccak log
        u32p, u32p, u32p, u32p, u8p, u8p, u8p, u8p, u32p,
        u32p, u32p, u32p, u32p, u32p, u32p, u32p, u8p,
        u32p, u8p, u8p, u32p, u32p, u32p, u32p,
        C.c_long, C.c_long, C.POINTER(C.c_int),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def run_native(mem, mode, prog_start, prog_end, decode_cache,
               exit_addr, heap_start, stack_top, entry,
               private_input: bytes, cap: int, max_steps=None,
               record: bool = True, kk_cap: int = 0):
    """Run the C emulator.  mem/mode are uint8 arrays (mutated in
    place).  Returns dict with steps SoA, regs, reg_ts, ram_ts, logs,
    exit_code, stats — or raises RuntimeError on VM fault."""
    lib = _load()
    assert lib is not None
    mem = np.ascontiguousarray(mem, np.uint8)
    mode = np.ascontiguousarray(mode, np.uint8)
    priv = np.frombuffer(private_input or b"\0", np.uint8).copy()
    log_buf = np.zeros(1 << 20, np.uint8)
    log_splits = np.zeros(4096, np.uint32)
    ram_ts = np.zeros(len(mem) // 4, np.uint32)
    regs = np.zeros(32, np.uint32)
    reg_ts = np.zeros(32, np.uint64)
    stats = np.zeros(4, np.uint32)
    exit_code = C.c_int(-1)
    kkn = max(int(kk_cap), 1)
    kk_clk = np.zeros(kkn, np.uint32)
    kk_addr = np.zeros(kkn, np.uint32)
    kk_in = np.zeros(kkn * 50, np.uint32)
    kk_out = np.zeros(kkn * 50, np.uint32)
    kk_pts = np.zeros(kkn * 50, np.uint32)

    while True:
        u32 = lambda: np.zeros(cap if record else 1, np.uint32)
        u8 = lambda: np.zeros(cap if record else 1, np.uint8)
        soa = dict(clk=u32(), pc=u32(), next_pc=u32(), word=u32(),
                   opcode=u8(), rd=u8(), rs1=u8(), rs2=u8(), imm=u32(),
                   a_val=u32(), b_val=u32(), c_val=u32(), a_prev=u32(),
                   ts1_prev=u32(), ts2_prev=u32(), ts3_prev=u32(),
                   rd_written=u8(), mem_addr=u32(), mem_size=u8(),
                   mem_store=u8(), mem_val=u32(), mem_prev_val=u32(),
                   mem_new=u32(), mem_prev_ts=u32())
        mem_run = mem.copy()
        ram_ts[:] = 0
        regs[:] = 0
        reg_ts[:] = 0
        n = lib.nexus_vm_run(
            mem_run, mode, np.uint32(len(mem)),
            np.uint32(prog_start), np.uint32(prog_end),
            decode_cache["opc"], decode_cache["type"],
            decode_cache["rd"], decode_cache["rs1"],
            decode_cache["rs2"], decode_cache["imm"],
            decode_cache["word"],
            np.uint32(exit_addr), np.uint32(heap_start),
            np.uint32(stack_top), np.uint32(entry),
            priv, np.uint32(len(private_input or b"")),
            log_buf, np.uint32(len(log_buf)), log_splits,
            np.uint32(len(log_splits)),
            ram_ts, regs, reg_ts, stats, int(record),
            kk_clk, kk_addr, kk_in, kk_out, kk_pts, int(kk_cap),
            soa["clk"], soa["pc"], soa["next_pc"], soa["word"],
            soa["opcode"], soa["rd"], soa["rs1"], soa["rs2"],
            soa["imm"], soa["a_val"], soa["b_val"], soa["c_val"],
            soa["a_prev"], soa["ts1_prev"], soa["ts2_prev"],
            soa["ts3_prev"], soa["rd_written"], soa["mem_addr"],
            soa["mem_size"], soa["mem_store"], soa["mem_val"],
            soa["mem_prev_val"], soa["mem_new"], soa["mem_prev_ts"],
            cap, -1 if max_steps is None else int(max_steps),
            C.byref(exit_code))
        if n == -1:
            cap *= 4
            continue
        if n == -2:
            raise RuntimeError("native VM fault")
        if n == -3:
            raise RuntimeError("native VM hit step limit without exit")
        n = int(n)
        splits = log_splits[:stats[2]].tolist()
        logs, prev = [], 0
        for s in splits:
            logs.append(bytes(log_buf[prev:s]))
            prev = s
        n_keccak = int(stats[3])
        keccak_log = [
            {"clk": int(kk_clk[i]), "addr": int(kk_addr[i]),
             "in_words": kk_in[50 * i:50 * i + 50].tolist(),
             "out_words": kk_out[50 * i:50 * i + 50].tolist(),
             "prev_ts": kk_pts[50 * i:50 * i + 50].tolist()}
            for i in range(min(n_keccak, int(kk_cap)))]
        return {
            # views into the exact-capacity buffers (no copy)
            "steps": {k: v[:n] for k, v in soa.items()},
            "n_steps": n,
            "mem_final": mem_run,
            "ram_ts": ram_ts,
            "regs": regs.copy(),
            "reg_ts": reg_ts.copy(),
            "logs": logs,
            "exit_code": int(exit_code.value) & 0xFFFFFFFF,
            "max_heap": int(stats[0]),
            "min_stack": int(stats[1]),
            "n_keccak": n_keccak,
            "keccak_log": keccak_log,
        }
