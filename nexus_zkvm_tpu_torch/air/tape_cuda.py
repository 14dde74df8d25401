"""Kernel K7 generated from a constraint tape: the tape's row program
written out as straight-line CUDA C++.

A tape (``air/tape.py``) is the same for every row and every proof of a
component, and it is known on the host before any launch.  So instead of
interpreting it on the card, :func:`pieces` turns it into source text for
the template ``csrc/air_eval_gen.cuh``: one statement per row operation,
in the order of the tape's kernel schedule (``Tape.program``, depth-first
from each output so that values die soon after they are made), every
value a local ``uint32_t``, every load at a literal column and offset,
every constant a literal, every challenge-derived uniform a word of the
piece's table in constant memory.

A tape whose outputs need more than :data:`PIECE_OPS` row operations,
more than :data:`PIECE_LIVE` values alive at once or more than
:data:`PIECE_TABLE_WORDS` table words is cut by output range into
pieces (keccak's tapes); each piece recomputes the values it shares
with the others.  The composition is linear in the constraints
and M31 addition is exact, so the pieces' bucket additions sum to the
one-piece result; operand pieces write disjoint words.

Each piece builds at first use into ``build/kernels/`` (``kernels.
build_generated``: the source beside its library, the library's name
carrying a digest of the text and the headers it includes).
:func:`launch` runs every piece of a tape in turn on the current stream
and counts one launch of the wrapper's kernel name.  The same text
compiles with a host compiler under ``-DNZT_HOST`` (``csrc/host_shim.h``),
which the CPU tests use to hold it to the plain interpreter.

Print a tape's generated source on the CPU with ``python -m
nexus_zkvm_tpu_torch.air.tape --source cpu`` (``--kind gen`` for the
operands).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import kernels

__all__ = ["PIECE_OPS", "PIECE_LIVE", "PIECE_TABLE_WORDS", "LOAD_REUSE",
           "Piece", "pieces", "build", "launch"]

# the most row operations one piece runs (the CPU component's composition
# tape, 6,480, is one piece)
PIECE_OPS = 8192
# the most values one piece keeps alive at once (row values and loaded
# words, in its program order): with the pointers, the accumulator and
# the temporaries they fit a thread's 128 registers (the CPU component's
# composition needs 79)
PIECE_LIVE = 96
# the most uniform-table words one piece reads (of the 16,384 that the
# 64 KiB of constant memory hold; the CPU component's composition reads
# 1,793): a piece of more of keccak's many small constraints takes
# ptxas half a minute
PIECE_TABLE_WORDS = 2048
# a loaded word is kept in its variable for the uses that follow within
# this many statements; a later use loads it again (from L1 or L2), so
# that a load read all along a tape does not hold a register all along
LOAD_REUSE = 32

# kernel opcodes and operand words of Tape.program (tape.py)
_K_ADD, _K_SUB, _K_MUL, _K_NEG, _K_EMIT1, _K_EMITQ_LO, _K_EMITQ_HI, \
    _K_STORE = range(8)
_FN = {_K_ADD: "nzt_add", _K_SUB: "nzt_sub", _K_MUL: "nzt_mul"}
# constraints added between two folds of the accumulator (its bound)
_FOLD_EVERY = 3
_LOCK = threading.Lock()


@dataclass
class Piece:
    """One generated kernel of a tape."""
    stem: str                  # file name before the digest
    text: str                  # the CUDA C++ source
    lib: Path                  # its library (`kernels.generated_path`)
    table: np.ndarray          # full-table index of each of its table words
    n_ops: int                 # row operations it runs
    live: int                  # the most values it keeps alive at once
    outputs: tuple             # [lo, hi) of the tape's outputs


def _decode(tape):
    """The program as SSA: per row operation its opcode and operands, per
    output its opcode, destination field and operands, and the order of
    both in the program.  An operand is ("v", row operation), ("c",
    value) for a constant, ("u", table index) for another uniform or
    ("l", load index)."""
    prog = tape.program.view(np.uint32).astype(np.int64)
    consts = dict(zip(tape.u_const[0].tolist(), tape.u_const[1].tolist()))
    u_pos = tape.u_table.tolist()
    writer, ops, outs = {}, [], []

    def ref(w):
        kind, idx = w >> 30, w & 0x3FFFFFFF
        if kind == 0:
            return ("v", writer[idx])
        if kind == 2:
            return ("l", idx)
        return ("c", consts[u_pos[idx]]) if u_pos[idx] in consts \
            else ("u", idx)
    seq = []                    # program order: op x, or ~output j
    i = 0
    while i < len(prog):
        code, dst, a, b = prog[i].tolist()
        if code <= _K_NEG:
            opnds = (ref(a),) if code == _K_NEG else (ref(a), ref(b))
            writer[dst] = len(ops)
            seq.append(len(ops))
            ops.append((code, opnds))
            i += 1
            continue
        if code == _K_EMITQ_LO:
            _c, dst, c, d = prog[i + 1].tolist()
            outs.append((_K_EMITQ_HI, dst, (ref(a), ref(b), ref(c), ref(d))))
            i += 1
        else:
            outs.append((code, dst, (ref(a),)))
        seq.append(~(len(outs) - 1))
        i += 1
    return ops, outs, seq


class _Cut:
    """One candidate piece: outputs [lo, hi) and the row operations they
    need (``members``).  Once built: ``stmts`` in program order, ("ld",
    var, load) a load into a fresh variable, ("op", x, args) row
    operation x, ("out", j, args) output j, an argument ("v", x), ("l",
    var), ("c", value) or ("u", table index); ``table`` the uniform-table
    words read; ``live`` the most variables alive at once (a value from
    its definition to its last use, a load's variable from the load to
    its last use)."""

    def __init__(self, ops, outs, at, deps, lo, hi):
        self.lo, self.hi = lo, hi
        self.ops, self.outs, self.at = ops, outs, at
        members, stack = set(), [y for j in range(lo, hi)
                                 for k, y in outs[j][2] if k == "v"]
        while stack:
            x = stack.pop()
            if x not in members:
                members.add(x)
                stack += deps[x]
        self.members, self.n_ops, self.stmts = members, len(members), None

    def build(self) -> "_Cut":
        if self.stmts is not None:
            return self
        ops, outs = self.ops, self.outs
        table, stmts, last, loads = set(), [], {}, {}
        # program order: row operations are numbered in it, and output j
        # follows row operation at[j] - 1
        order = sorted([(x, 0, x) for x in self.members]
                       + [(self.at[j], 1, j)
                          for j in range(self.lo, self.hi)])
        for _p, is_out, x in order:
            opnds = outs[x][2] if is_out else ops[x][1]
            for kind, y in opnds:          # loads first: fresh, or kept
                if kind == "l":
                    got = loads.get(y)
                    if got is None or len(stmts) - got[1] > LOAD_REUSE:
                        k = 0 if got is None else got[0] + 1
                        got = loads[y] = [k, 0, f"{y}_{k}"]
                        stmts.append(("ld", got[2], y))
            args, n = [], len(stmts)
            for r in opnds:
                kind, y = r
                if kind == "l":
                    got = loads[y]
                    got[1] = last[got[2]] = n
                    r = ("l", got[2])
                elif kind == "v":
                    last[y] = n
                elif kind == "u":
                    table.add(y)
                args.append(r)
            if is_out:
                code, dst, _o = outs[x]
                if code != _K_STORE:
                    table.update(range(dst, dst + 4))
                stmts.append(("out", x, args))
            else:
                stmts.append(("op", x, args))
        ev = np.zeros(len(stmts) + 1, np.int64)
        for i, st in enumerate(stmts):
            if st[0] != "out":
                ev[i] += 1
                ev[last.get(st[1], i)] -= 1
        self.live = int(np.cumsum(ev).max()) if stmts else 0
        self.stmts, self.table = stmts, sorted(table)
        return self

    def fits(self) -> bool:
        if self.n_ops > PIECE_OPS:
            return False
        self.build()
        return self.live <= PIECE_LIVE and len(self.table) <= PIECE_TABLE_WORDS


def _plan(ops, outs, seq) -> list:
    """Cut the outputs into consecutive ranges, each the longest from
    where the last ended that fits the caps (one output at least): the
    previous range's length is tried first (a tape repeats itself), then
    longer ones by doubling, then a bisection."""
    deps = [[y for k, y in opnds if k == "v"] for _c, opnds in ops]
    at, n_ops = [], 0               # row operations before each output
    for x in seq:
        if x >= 0:
            n_ops += 1
        else:
            at.append(n_ops)
    plan, lo, n = [], 0, 1
    while lo < len(outs):
        def fits(k):
            return _Cut(ops, outs, at, deps, lo, lo + k).fits()
        left = len(outs) - lo
        n = min(n, left)
        if fits(n):                     # the last length, or longer
            good, bad = n, None
            k = n + 1
            while good < left and bad is None:
                if fits(k):
                    good, k = k, min(2 * k, left)
                else:
                    bad = k
        else:                           # shorter: one output always goes
            good, bad = 1, n
        while bad is not None and bad - good > 1:
            mid = (good + bad) // 2
            if fits(mid):
                good = mid
            else:
                bad = mid
        plan.append(_Cut(ops, outs, at, deps, lo, lo + good).build())
        lo, n = lo + good, good
    return plan


def _source(tape, ops, outs, cut: _Cut, index: int, count: int) -> str:
    """The piece's CUDA C++ text on the template."""
    compact = {k: i for i, k in enumerate(cut.table)}

    def show(r):
        kind, y = r
        return (f"v{y}" if kind == "v" else f"l{y}" if kind == "l"
                else f"{y}u" if kind == "c" else f"U({compact[y]})")
    lines, n_loads, n_emits = [], 0, 0
    for kind, x, args in cut.stmts:
        if kind == "ld":                # x a variable, args its load
            role, col, off = tape.loads[args].tolist()
            lines.append(f"  const uint32_t l{x} = LD({role}, {col}, {off});")
            n_loads += 1
            continue
        a = [show(r) for r in args]
        if kind == "op":
            code = ops[x][0]
            expr = (f"nzt_neg({a[0]})" if code == _K_NEG
                    else f"{_FN[code]}({a[0]}, {a[1]})")
            lines.append(f"  const uint32_t v{x} = {expr};")
            continue
        code, dst, _o = outs[x]
        if code != _K_STORE:
            if n_emits and n_emits % _FOLD_EVERY == 0:
                lines.append("  FOLD();")
            n_emits += 1
        if code == _K_EMIT1:
            lines.append(f"  EMIT1({compact[dst]}, {a[0]});")
        elif code == _K_EMITQ_HI:
            lines.append(f"  EMITQ({compact[dst]}, {', '.join(a)});")
        else:
            _v, sa, sb, step = tape.store_terms[dst].tolist()
            lines.append(f"  ST({sa}, {sb}, {step}, {a[0]});")
    compose = int(tape.kind == "domain")
    head = [
        f"// K7, generated by nexus_zkvm_tpu_torch/air/tape_cuda.py from the "
        f"{tape.kind} tape",
        f"// of component {tape.name!r}, piece {index + 1} of {count}: "
        f"outputs [{cut.lo}, {cut.hi}) of {len(outs)},",
        f"// {cut.n_ops} row operations, {n_loads} loads, {len(cut.table)} "
        f"table words, at most {cut.live} values alive.",
        f"#define NZT_COMPOSE {compose}",
        f"#define NZT_STRIDE {tape.stride}",
        f"#define NZT_NU {len(cut.table)}",
        '#include "air_eval_gen.cuh"',
        "",
        "__device__ __forceinline__ void nzt_tape_body(const NztRow& r, "
        "NztAcc& acc) {"]
    if not compose:
        head.append("  (void)acc;")
    return "\n".join(head + lines) + "\n}\n"


def pieces(tape) -> list:
    """The generated kernels of ``tape`` (cached on the tape)."""
    with _LOCK:
        got = tape._dev.get("pieces")
    if got is not None:
        return got
    ops, outs, seq = _decode(tape)
    plan = _plan(ops, outs, seq)
    out = []
    for i, cut in enumerate(plan):
        stem = f"air_{tape.name}_{tape.kind}_{i}"
        text = _source(tape, ops, outs, cut, i, len(plan))
        out.append(Piece(stem=stem, text=text,
                         lib=kernels.generated_path(stem, text),
                         table=np.asarray(cut.table, np.int64),
                         n_ops=cut.n_ops, live=cut.live,
                         outputs=(cut.lo, cut.hi)))
    with _LOCK:
        tape._dev.setdefault("pieces", out)
        return tape._dev["pieces"]


def _name(tape) -> str:
    return "air_eval_composition" if tape.kind == "domain" \
        else "air_eval_operands"


def build(tapes) -> dict:
    """Build every piece of ``tapes`` not yet loaded, all in one batch
    (`kernels.build_generated`); returns its record."""
    return kernels.build_generated([(_name(t), p.lib, p.text) for t in tapes
                                    for p in pieces(t)])


def _table(tape, table: np.ndarray, device):
    """The pieces' table words on ``device``, one after another, and each
    piece's first word; cached for the last table seen (a tape's launches
    of one proof share their challenges)."""
    key = ("table", str(device))
    raw = np.asarray(table, np.int64).tobytes()
    with _LOCK:
        got = tape._dev.get(key)
    if got is not None and got[0] == raw:
        return got[1], got[2]
    ps = pieces(tape)
    words = np.concatenate([np.asarray(table, np.int64)[p.table]
                            for p in ps]).astype(np.uint32)
    starts = np.cumsum([0] + [len(p.table) for p in ps])[:-1].tolist()
    dev = torch.from_numpy(words.view(np.int32)).to(device)
    with _LOCK:
        tape._dev[key] = (raw, dev, starts)
    return dev, starts


def launch(tape, table: np.ndarray, bases: list, args: tuple,
           device) -> None:
    """Run every piece of ``tape`` on ``device``'s current stream: each
    piece's entry gets the four role pointers ``bases``, the wrapper's
    arguments ``args`` and its table words (from ``table``, the tape's
    uniforms and, for the composition, its weights).  Counts one launch
    of ``air_eval_composition`` / ``air_eval_operands``."""
    name = _name(tape)
    fns = tape._dev.get("entries")
    if fns is None:
        fns = kernels.generated_entries(
            name, [(p.lib, p.text) for p in pieces(tape)])
        tape._dev["entries"] = fns
    words, starts = _table(tape, table, device)
    ptr = words.data_ptr()
    kernels.launch_generated(
        name, [(fn, (*bases, *args, ptr + 4 * s))
               for fn, s in zip(fns, starts)], device=device)
