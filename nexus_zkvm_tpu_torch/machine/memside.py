"""Memory-side components: register file, RAM init/final, output binding.

Counterparts: FinalReg + RamInitFinal extensions of the legacy prover
(`nexus-zkvm/prover/src/extensions/final_reg.rs`,
`ram_init_final.rs`) and the RegisterMemory/MemoryBoundary components of
prover2 (`nexus-zkvm/prover2/machine/src/components/`).

Multiset memory-check protocol over the `mem` relation
(addr, val_lo, val_hi, ts) and `reg` relation (r, val_lo, val_hi, ts):

* `RamTouched` — one row per touched word, addresses strictly
  increasing (range-checked difference => uniqueness): opens each
  address's access chain by emitting its initial state at ts 0 and
  closes it by consuming the final state.  Initial values are either
  zero (addr >= heap_start, proven by range decomposition) or bound to
  the public image through the `meminit` relation.
* `MemInit` — fully preprocessed (addr, value) enumeration of the
  public initial image (program words, IO sentinels, input tape,
  static data, exit/output words); provides `meminit` with a 0/1 mult.
* `OutputCheck` — preprocessed (addr, expected value) rows for the
  public output region + exit code; inserts a virtual *read* at
  TS_CHECK (beyond any execution timestamp, clk < 2^28 => ts < 3*2^28
  < TS_CHECK), forcing the final value of each output word to equal
  the public claim.
* `RegFile` — 32 preprocessed register indices; emits (r, 0, 0, 0) at
  init, consumes the final register state.

All fills are vectorized numpy over the row axis.
"""

from __future__ import annotations

import numpy as np

from ..air import Component
from .schema import Schema, Cols

__all__ = ["RegFile", "RamTouched", "MemInit", "OutputCheck",
           "TS_CHECK", "fill_reg_file", "fill_ram_touched",
           "build_mem_image"]

TS_CHECK = (1 << 30) - 1


def _halves(words: np.ndarray):
    w = np.asarray(words, np.uint64)
    return (w & 0xFFFF).astype(np.uint32), (w >> 16).astype(np.uint32)


# ---------------------------------------------------------------------------
# RegFile
# ---------------------------------------------------------------------------

REG_SCHEMA = Schema([
    ("final_lo", 1), ("final_hi", 1), ("final_ts", 1),
])


class RegFile(Component):
    """32 preprocessed rows; x2 (sp) starts at the public stack top
    (the emulator seeds sp before execution)."""
    name = "regfile"
    n_main = REG_SCHEMA.n_cols
    log_size = 5

    def __init__(self, stack_top: int = 0):
        self.stack_top = int(stack_top)

    def preprocessed(self, log_size: int):
        n = 1 << log_size
        idx = np.arange(n, dtype=np.uint32)
        flag = (idx < 32).astype(np.uint32)
        init_lo = np.zeros(n, np.uint32)
        init_hi = np.zeros(n, np.uint32)
        if n > 2:
            init_lo[2] = self.stack_top & 0xFFFF
            init_hi[2] = self.stack_top >> 16
        return [("reg_idx", idx), ("reg_flag", flag),
                ("reg_init_lo", init_lo), ("reg_init_hi", init_hi)]

    def evaluate(self, ctx):
        c = Cols(ctx, REG_SCHEMA)
        r, flag = ctx.pre(0), ctx.pre(1)
        ctx.add_fraction(flag, "reg", [r, ctx.pre(2), ctx.pre(3), 0])
        ctx.add_fraction(-flag, "reg",
                         [r, c("final_lo"), c("final_hi"), c("final_ts")])


def fill_reg_file(reg_vals, reg_ts, log_size: int = 5) -> dict:
    f = REG_SCHEMA.alloc(1 << log_size)
    lo, hi = _halves(np.asarray(reg_vals, np.uint64))
    f["final_lo"][:32] = lo
    f["final_hi"][:32] = hi
    f["final_ts"][:32] = np.asarray(reg_ts, np.uint32)
    return f


# ---------------------------------------------------------------------------
# RamTouched
# ---------------------------------------------------------------------------

RAM_SCHEMA = Schema([
    ("flag", 1),
    ("addr", 1),
    ("init_lo", 1), ("init_hi", 1),
    ("final_lo", 1), ("final_hi", 1),
    ("final_ts", 1),
    ("z", 1), ("g", 1),          # zero-init / image-init flags
    ("d", 4),                    # (addr_next - addr - 1) limbs 8/8/8/6
    ("zd", 4),                   # (addr - heap_start) limbs 8/8/8/6
])


class RamTouched(Component):
    name = "ram_touched"
    n_main = RAM_SCHEMA.n_cols

    def __init__(self, heap_start: int):
        self.heap_start = int(heap_start)

    def params(self):
        return {"heap_start": self.heap_start}

    def preprocessed(self, log_size: int):
        nl = np.ones(1 << log_size, np.uint32)
        nl[-1] = 0
        return [("rt_not_last", nl)]

    def evaluate(self, ctx):
        c = Cols(ctx, RAM_SCHEMA)
        f, addr = c("flag"), c("addr")
        z, g = c("z"), c("g")
        ctx.constraint(f * (f - 1))
        ctx.constraint(z * (z - 1))
        ctx.constraint(g * (g - 1))
        ctx.constraint(z + g - f)
        # flags form a prefix: once f=0, every later row has f=0 (gated
        # off the circle wrap row n-1 -> row 0 by the preprocessed
        # not-last column).  Without this, a flag gap would let two
        # disjoint flagged runs open independent access chains at the
        # same address (stale-read memory forking).
        f_next = c("flag", 0, 1)
        not_last = ctx.pre(0)
        ctx.constraint((f_next - f * f_next) * not_last)
        # strict address ordering between consecutive real rows
        d = c("d", 0) + c("d", 1) * (1 << 8) + c("d", 2) * (1 << 16) \
            + c("d", 3) * (1 << 24)
        ctx.constraint(f * f_next * (c("addr", 0, 1) - addr - 1 - d))
        # zero-init rows live at/above the heap
        zd = c("zd", 0) + c("zd", 1) * (1 << 8) + c("zd", 2) * (1 << 16) \
            + c("zd", 3) * (1 << 24)
        ctx.constraint(z * (addr - ctx.param("heap_start") - zd))
        ctx.constraint(z * c("init_lo"))
        ctx.constraint(z * c("init_hi"))
        # range checks backing the decompositions
        for name in ("d", "zd"):
            for i in range(3):
                ctx.add_fraction(1, "r256", [c(name, i)])
            ctx.add_fraction(1, "r64", [c(name, 3)])
        # the access chain: open at ts 0, close at the final state
        ctx.add_fraction(f, "mem", [addr, c("init_lo"), c("init_hi"), 0])
        ctx.add_fraction(-f, "mem", [addr, c("final_lo"), c("final_hi"),
                                     c("final_ts")])
        # image-initialized rows look their value up in MemInit
        ctx.add_fraction(g, "meminit", [addr, c("init_lo"), c("init_hi")])


def fill_ram_touched(addrs, init_vals, final_vals, final_ts,
                     heap_start: int, log_size: int) -> dict:
    """All inputs sorted by word address (vectorized)."""
    n = len(addrs)
    f = RAM_SCHEMA.alloc(1 << log_size)
    a = np.asarray(addrs, np.uint64)
    assert n == 0 or (np.all(np.diff(a) >= 1) and a[-1] < (1 << 30))
    f["flag"][:n] = 1
    f["addr"][:n] = a
    f["init_lo"][:n], f["init_hi"][:n] = _halves(init_vals)
    f["final_lo"][:n], f["final_hi"][:n] = _halves(final_vals)
    f["final_ts"][:n] = np.asarray(final_ts, np.uint32)
    z = (a >= heap_start).astype(np.uint32)
    f["z"][:n] = z
    f["g"][:n] = 1 - z
    if n > 1:
        d = (a[1:] - a[:-1] - 1).astype(np.uint64)
        for i in range(4):
            f["d"][:n - 1, i] = (d >> (8 * i)) & (0xFF if i < 3 else 0x3F)
    zd = (a - heap_start) * z
    for i in range(4):
        f["zd"][:n, i] = (zd >> np.uint64(8 * i)) \
            & (0xFF if i < 3 else 0x3F)
    return f


# ---------------------------------------------------------------------------
# MemInit
# ---------------------------------------------------------------------------

class MemInit(Component):
    """Preprocessed public-image words; main col = 0/1 provide mult."""
    name = "mem_init"
    n_main = 1

    def __init__(self, image_addrs, image_vals):
        self.addrs = np.asarray(image_addrs, np.uint32)
        self.vals = np.asarray(image_vals, np.uint32)

    def preprocessed(self, log_size: int):
        n = 1 << log_size
        addr = np.zeros(n, np.uint32)
        lo = np.zeros(n, np.uint32)
        hi = np.zeros(n, np.uint32)
        flag = np.zeros(n, np.uint32)
        k = min(len(self.addrs), n)
        addr[:k] = self.addrs[:k]
        l, h = _halves(self.vals[:k])
        lo[:k], hi[:k] = l, h
        flag[:k] = 1
        return [("mi_addr", addr), ("mi_lo", lo), ("mi_hi", hi),
                ("mi_flag", flag)]

    def evaluate(self, ctx):
        m = ctx.main(0)
        flag = ctx.pre(3)
        ctx.constraint(m * (m - 1))
        # padding rows (flag=0) carry the all-zero tuple; forbid them
        # from providing a spurious (0,0,0) meminit entry
        ctx.constraint(m * (flag - 1))
        ctx.add_fraction(-m, "meminit", [ctx.pre(0), ctx.pre(1),
                                         ctx.pre(2)])


def build_mem_image(view) -> tuple:
    """Public initial-image words from a View: program + initial-memory
    byte entries + zeroed exit/output words.  Returns (addrs, vals)
    sorted by address (word granularity)."""
    words = {}
    for pc, w in view.program_info.program:
        words[pc & ~3] = w
    by_word = {}
    for addr, byte in view.initial_memory:
        by_word.setdefault(addr & ~3, {})[addr & 3] = byte
    for wa, bs in by_word.items():
        base = words.get(wa, 0)
        for o, byte in bs.items():
            base = (base & ~(0xFF << (8 * o))) | (byte << (8 * o))
        words[wa] = base
    lay = view.memory_layout
    for wa in range(lay.exit_code, lay.public_output_end, 4):
        words.setdefault(wa, 0)
    addrs = np.array(sorted(words), np.uint32)
    vals = np.array([words[a] for a in addrs], np.uint32)
    return addrs, vals


# ---------------------------------------------------------------------------
# OutputCheck
# ---------------------------------------------------------------------------

OUT_SCHEMA = Schema([
    ("prev_ts", 1),
    ("tsd", 4),                  # (TS_CHECK - prev_ts - 1) limbs 8/8/8/6
])


class OutputCheck(Component):
    name = "output_check"
    n_main = OUT_SCHEMA.n_cols

    def __init__(self, view):
        lay = view.memory_layout
        addrs = list(range(lay.exit_code, lay.public_output_end, 4))
        data = (int(view.exit_code & 0xFFFFFFFF).to_bytes(4, "little")
                + view.public_output)
        vals = [int.from_bytes(data[i:i + 4].ljust(4, b"\0"), "little")
                for i in range(0, len(addrs) * 4, 4)]
        self.addrs = np.asarray(addrs, np.uint32)
        self.vals = np.asarray(vals, np.uint32)

    def preprocessed(self, log_size: int):
        n = 1 << log_size
        addr = np.zeros(n, np.uint32)
        lo = np.zeros(n, np.uint32)
        hi = np.zeros(n, np.uint32)
        flag = np.zeros(n, np.uint32)
        k = min(len(self.addrs), n)
        addr[:k] = self.addrs[:k]
        l, h = _halves(self.vals[:k])
        lo[:k], hi[:k] = l, h
        flag[:k] = 1
        return [("oc_addr", addr), ("oc_lo", lo), ("oc_hi", hi),
                ("oc_flag", flag)]

    def evaluate(self, ctx):
        c = Cols(ctx, OUT_SCHEMA)
        addr, lo, hi, flag = (ctx.pre(i) for i in range(4))
        prev_ts = c("prev_ts")
        tsd = c("tsd", 0) + c("tsd", 1) * (1 << 8) \
            + c("tsd", 2) * (1 << 16) + c("tsd", 3) * (1 << 24)
        ctx.constraint(flag * (TS_CHECK - prev_ts - 1 - tsd))
        for i in range(3):
            ctx.add_fraction(1, "r256", [c("tsd", i)])
        ctx.add_fraction(1, "r64", [c("tsd", 3)])
        ctx.add_fraction(-flag, "mem", [addr, lo, hi, prev_ts])
        ctx.add_fraction(flag, "mem", [addr, lo, hi, TS_CHECK])

    def fill(self, prev_ts_by_addr: dict, log_size: int) -> dict:
        f = OUT_SCHEMA.alloc(1 << log_size)
        k = len(self.addrs)
        pts = np.array([prev_ts_by_addr.get(int(a), 0)
                        for a in self.addrs], np.uint64)
        f["prev_ts"][:k] = pts
        tsd = TS_CHECK - pts - 1
        for i in range(4):
            f["tsd"][:k, i] = (tsd >> np.uint64(8 * i)) \
                & (0xFF if i < 3 else 0x3F)
        return f
