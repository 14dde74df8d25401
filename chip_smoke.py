#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build   — compile every CUDA source of ``nexus_zkvm_tpu_torch/csrc``
             with nvcc for sm_90a; print the card's name and power limit.
2. kernel  — every kernel against its plain PyTorch version on the same
             CUDA tensors (uint32 equality), first at the shapes of the
             synthetic slice (phase 4), then, timed, at the largest
             shapes the machine proof (phase 5) gives it: its time, the
             plain version's time and the bound the card sets for the
             work.  The CPU trace fill (K5) runs on a mixed-opcode
             program and on the step record of the fib guest at 2^20
             rows; the LogUp columns (K6) on the fractions of that
             trace's CPU component; K1-K4 at that proof's shapes (see
             `check_prover_kernels`).
3. parity  — a proof at 2^10 rows on the CPU (plain path) and on the
             card (kernels) must be equal field by field.
4. slice   — the prover core at the size of a fib 2^20 proof: one
             component of 64 squares (192 main columns, 128 constraints,
             64 LogUp fractions) at 2^20 rows and its lookup table at 2^4,
             default PcsConfig; prove, verify, reject a tampered proof;
             every kernel of the prover core must have been launched.
5. machine — the zkVM's main path: the fib guest (examples/guests/fib.s)
             with n = 209,700 (a CPU component of 2^20 rows) through
             ``sdk.LocalProver`` on the card, default PcsConfig: a cold
             and a warm prove (phase times), verify, reject a tampered
             opening and another program's claim; every kernel must have
             been launched.  Then the fib guest at n = 10 proved on the
             CPU and on the card: the proof bytes must be equal.
6. kernels — one JSON line with every kernel's numbers: launches from
             the machine phase, times at its shapes (phase 2).

The last line is {"ok": true, "device": {...}}.  Without a CUDA device
the script exits with code 2 and prints no result.

Bounds: the least time the card could take, the larger of bytes moved
(each input read once, each output written once) over 3.35 TB/s and
32-bit integer operations over 33.5 Tops/s.  That rate is the issue
limit, 4 schedulers x 32 lanes = 128 lane operations per SM per clock
(132 SMs, 1.98 GHz), which is the table's 67 TFLOP/s float32 rate with
an FMA counted as one operation; the INT32 pipe alone (64 lanes per SM)
is half of it, so the bound is a floor, not a target.  Operation counts
follow a simple model: an M31 product (widening multiply and fold) is 6
operations, an M31 add or subtract 3, a Blake2s compression 968 (80 G
mixes of 12: a three-input add counts once, as IADD3 does it, and so
does a three-input xor, as LOP3 does it; plus 8 for the output xors).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
MUL, ADD = 6, 3
COMPRESS = 80 * 12 + 8
QM31_MUL = 16 * MUL + 14 * ADD
QM31_INV = 57 * MUL + 20 * ADD
M31_INV = 37 * MUL

K_SQUARES = 64
FULL_LOG = 20
TABLE_LOG = 4
PARITY_LOG = 10
FIB_N = 209_700          # 5 steps an iteration: a 2^20-row CPU component
FIB_PARITY_N = 10

EXIT_ASM = """
    addi a0, zero, 0
    addi a7, zero, 0x201
    ecall
"""

# ALU, shifts, bitwise, loads/stores of every width, compares, branches,
# jumps and syscalls: the fill's branches that fib leaves unexercised
MIXED_SRC = """
        li   t0, 23
        li   t1, 0x12345678
        addi a7, zero, 0x403     # heap pointer -> a0
        ecall
        mv   s2, a0
    loop:
        add  t2, t0, t1
        sub  t3, t1, t0
        xor  t4, t2, t3
        and  t5, t2, t3
        or   t6, t2, t3
        sll  s3, t1, t0
        srl  s4, t1, t0
        sra  s5, t1, t0
        slt  s6, t0, t1
        sltu s7, t1, t0
        sw   t2, 0(s2)
        lw   s8, 0(s2)
        sb   t3, 1(s2)
        lb   s9, 1(s2)
        lh   s10, 2(s2)
        lui  s11, 0xABCDE
        auipc a2, 4
        addi t0, t0, -1
        bne  t0, zero, loop
        jal  ra, next
    next:
        lw   t1, 0x84(zero)
        sw   t0, 0(t1)
""" + EXIT_ASM

# a different claim: a proof of fib must not verify against it
OTHER_SRC = """
        addi t0, zero, 3
        lw   t1, 0x84(zero)
        sw   t0, 0(t1)
""" + EXIT_ASM


def fib_guest():
    from nexus_zkvm_tpu_torch.sdk import Guest
    return Guest.from_asm((ROOT / "examples" / "guests" / "fib.s")
                          .read_text())


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max()) if d.numel() else 0


# ---------------------------------------------------------------------------
# Workload: the test fixture of tests/test_stark_e2e.py, widened
# ---------------------------------------------------------------------------

def make_components():
    from nexus_zkvm_tpu_torch.air import Component

    class WideSquares(Component):
        """64 copies of: y = x^2, z = next-row x, y looked up in 'vals'."""
        name = "wide_squares"
        n_main = 3 * K_SQUARES

        def evaluate(self, ctx):
            for k in range(K_SQUARES):
                x, y, z = (ctx.main(3 * k + i) for i in range(3))
                ctx.constraint(y - x * x)
                ctx.constraint(z - ctx.main(3 * k, 1))
                ctx.add_fraction(1, "vals", [y])

    class Table(Component):
        """(val, mult) table consuming the 'vals' relation."""
        name = "vals_table"
        n_main = 2

        def evaluate(self, ctx):
            val, mult = ctx.main(0), ctx.main(1)
            ctx.add_fraction(-mult, "vals", [val])

    return [WideSquares(), Table()]


def make_traces(log_n: int):
    rows = np.arange(1 << log_n, dtype=np.int64)
    x = ((rows[None, :] + np.arange(K_SQUARES)[:, None]) % 7).astype(np.uint32)
    y = x * x
    z = np.roll(x, -1, axis=1)
    main = []
    for k in range(K_SQUARES):
        main += [x[k], y[k], z[k]]
    vals = np.zeros(1 << TABLE_LOG, np.uint32)
    mult = np.zeros(1 << TABLE_LOG, np.uint32)
    uniq, counts = np.unique(y, return_counts=True)
    vals[:len(uniq)] = uniq
    mult[:len(uniq)] = counts
    return [main, [vals, mult]]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

REPLACES = {
    "circle_ifft": ("cfft.cu", "nexus_zkvm_tpu/ops/cfft.py:73"),
    "circle_fft": ("cfft.cu", "nexus_zkvm_tpu/ops/cfft.py:137"),
    "blake2s_messages": ("blake2s.cu", "nexus_zkvm_tpu/ops/blake2s.py:158"),
    "blake2s_parents": ("blake2s.cu", "nexus_zkvm_tpu/ops/merkle.py:135"),
    "deep_quotients": ("quotients.cu", "nexus_zkvm_tpu/ops/quotients.py:157"),
    "fri_fold": ("fri.cu", "nexus_zkvm_tpu/ops/fri.py:209"),
    "cpu_fill": ("fill.cu", "nexus_zkvm_tpu/machine/fill_dev.py:143"),
    "logup_columns": ("logup.cu", "nexus_zkvm_tpu/air/component.py:346"),
}

# integer operations of a CPU-fill row besides its three M31 inverses
# (shifts, masks, compares, selects, stores and ~100 histogram adds)
FILL_ROW_OPS = 600


def check(name, shape, kernel_fn, plain_fn, nbytes, ops, timed, reps=10,
          plain_reps=2):
    """Run the kernel and its plain version on the same inputs; raise
    unless their outputs are equal; time both when ``timed``."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    before = kernels.launch_counts()[name]
    got = kernel_fn()
    torch.cuda.synchronize()
    if kernels.launch_counts()[name] == before:
        raise RuntimeError(f"{name}: the wrapper did not launch its kernel")
    want = plain_fn()
    got, want = (tuple(x) if isinstance(x, tuple) else (x,)
                 for x in (got, want))
    if len(got) != len(want) or not all(
            g.shape == w.shape and torch.equal(g, w)
            for g, w in zip(got, want)):
        err = max(max_abs_err(g, w) if g.shape == w.shape else -1
                  for g, w in zip(got, want))
        raise RuntimeError(f"{name} {shape}: kernel and plain version "
                           f"differ (max abs err {err})")
    del got, want
    rec = {"phase": "kernel", "name": name, "shape": shape, "equal": True,
           "max_abs_err": 0}
    if timed:
        b_ms, b_by = bound(nbytes, ops)
        rec.update(ms=cuda_ms(kernel_fn, reps),
                   plain_ms=cuda_ms(plain_fn, plain_reps),
                   bound_ms=b_ms, bound_by=b_by)
    emit(rec)
    return rec


def quotient_cost(rows, M: int, gcs: np.ndarray):
    """Bytes and operations of one deep_quotients launch: the blocks and
    the points read, the (M, 4) output written; per row, each (sample,
    column) term's product and add in 4 coordinates, and per sample the
    denominator's products and inverse."""
    nnz = int((gcs != 0).any(axis=2).sum())
    return (4 * sum(rows) * M + 8 * M + 16 * M,
            M * (nnz * 4 * (MUL + 2) + len(gcs) * (3 * QM31_MUL + QM31_INV)))


def check_kernels(full: bool = True) -> dict:
    """Every kernel of the prover core (K1-K4) at small shapes and
    (``full``) at the shapes of the 2^20 slice, untimed; then K5 and K6
    and, timed, K1-K4 at the machine proof's shapes.  Returns {kernel
    name: timed record}."""
    import torch
    from nexus_zkvm_tpu_torch.ops import (blake2s, cfft, fri, quotients,
                                          circle)
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    P = (1 << 31) - 1
    timed = {}

    def rand(shape, hi=P):
        return from_u32(rng.integers(0, hi, shape, dtype=np.uint32), dev)

    # K1 --------------------------------------------------------------------
    for n in (4, 10, 21) if full else (4, 10):
        for C in (1, 192):
            x = rand((C, 1 << n))
            check("circle_ifft", [C, 1 << n], lambda: cfft.interpolate(x),
                  lambda: cfft.interpolate_plain(x), 0, 0, False)
            check("circle_fft", [C, 1 << n], lambda: cfft.evaluate(x),
                  lambda: cfft.evaluate_plain(x), 0, 0, False)
            del x
    # K2 --------------------------------------------------------------------
    for W in (1, 4, 16, 192):
        m = rand((1 << 14, W), 1 << 32)
        check("blake2s_messages", [1 << 14, W],
              lambda: blake2s.hash_rows(m), lambda: blake2s.hash_rows_plain(m),
              0, 0, False)
    R = 1 << 21 if full else 1 << 12
    mat = rand((192, R))
    leaves = blake2s.hash_rows(mat.t())
    check("blake2s_messages", [R, 192], lambda: blake2s.hash_rows(mat.t()),
          lambda: blake2s.hash_rows_plain(mat.t()), 0, 0, False)
    del mat
    check("blake2s_parents", [R, 8], lambda: blake2s.hash_parents(leaves),
          lambda: blake2s.hash_rows_plain(leaves.reshape(-1, 16)), 0, 0,
          False)
    del leaves
    # K3: a size group of the slice (pre 1 + main 192 + inter 128 columns,
    # samples at offsets -1, 0, +1) -------------------------------------------
    s = 21 if full else 8
    M = 1 << s
    rows = (1, 192, 128)
    blocks = [rand((r, M)) for r in rows]
    K = sum(rows)
    gcs = rng.integers(0, P, (3, K, 4), dtype=np.uint32)
    gcs[0, :-4] = 0                      # offset -1: the last inter batch
    gcs[2, :1] = 0                       # offset +1: every third main column
    gcs[2, 1 + 192:] = 0
    gcs[2, 1:193][np.arange(192) % 3 != 0] = 0
    gcs_t = from_u32(gcs, dev)
    consts = rand((3, 6, 4))
    xs, ys = circle.dev_committed_points(s, dev)
    check("deep_quotients", [K, M],
          lambda: quotients.accumulate_blocks(blocks, xs, ys, consts, gcs_t),
          lambda: quotients.accumulate_blocks_plain(blocks, xs, ys, consts,
                                                    gcs_t), 0, 0, False)
    del blocks
    # K4: the first circle fold of the slice (2^23 -> 2^22) and a landing
    # fold with injection -------------------------------------------------------
    s0 = 23 if full else 9
    v = rand((1 << s0, 4))
    tw = fri.dev_circle_fold_twiddles(s0, dev)
    alpha = rng.integers(0, P, 4).astype(np.uint64)
    check("fri_fold", [1 << s0, 4], lambda: fri.fold(v, alpha, tw),
          lambda: fri.fold_plain(v, alpha, tw), 0, 0, False)
    del v
    inj = rand((1 << 6, 4))
    ltw = fri.dev_line_fold_twiddles(6, dev)
    cur = rand((1 << 6, 4))
    w2 = rng.integers(0, P, 4).astype(np.uint64)
    check("fri_fold", [1 << 6, 4],
          lambda: fri.fold(cur, alpha, ltw, inj, fri.dev_circle_fold_twiddles(
              6, dev), w2),
          lambda: fri.fold_plain(cur, alpha, ltw, inj,
                                 fri.dev_circle_fold_twiddles(6, dev), w2),
          0, 0, False)
    timed.update(check_machine_kernels(full))
    torch.cuda.empty_cache()
    return timed


def logup_ops(meta) -> int:
    """Operations per row of one logup_columns launch, counted from the
    operand modes of each pair (modes 0 and 1 are M31): a product with
    one M31 factor is 4 M31 products, with two it is one; a denominator
    product in M31 is inverted in M31; then the pair's running-sum add,
    and the row scan's add once per row."""
    def mul(a, b):
        return MUL if a and b else 4 * MUL if a or b else QM31_MUL
    ops = 4 * ADD
    for n1, d1, n2, d2 in meta[..., 1].t().tolist():
        n1, d1, n2, d2 = (m < 2 for m in (n1, d1, n2, d2))
        num, den = n1 and d2 and n2 and d1, d1 and d2
        ops += (mul(n1, d2) + mul(n2, d1) + (ADD if num else 4 * ADD)
                + mul(d1, d2) + (M31_INV if den else QM31_INV)
                + mul(num, den) + 4 * ADD)
    return ops


def check_machine_kernels(full: bool = True) -> dict:
    """K5 on the mixed-opcode program and on the fib guest's step record
    (2^20 rows when ``full``); K6 on the LogUp fractions of that trace's
    CPU component, as the prover's interaction phase builds them; K1-K4
    at the shapes of that trace's machine proof."""
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air.component import (
        GenContext, component_info, logup_columns, logup_columns_plain,
        logup_operands, _pair_entries)
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.machine import fill_dev
    from nexus_zkvm_tpu_torch.machine.driver import (
        build_components, build_machine_traces, _clog2)
    from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    from nexus_zkvm_tpu_torch.vm import asm, k_trace
    dev = torch.device("cuda")
    timed = {}

    def rows_of(view, trace):
        comps, _f, (lo, hi) = build_components(view, 1)
        log = _clog2(len(trace.steps["clk"]), lo=4)
        rows, prm = fill_dev.step_rows(trace, view, log, lo, hi)
        return comps, log, from_u32(rows, dev), prm

    # K5 --------------------------------------------------------------------
    def fill_cost(comps, rows):
        N = int(rows.shape[1])
        return (4 * N * (len(rows) + comps[0].n_main) + 4 * fill_dev.N_HIST,
                N * (3 * 37 * MUL + FILL_ROW_OPS))

    comps, log, rows, prm = rows_of(*k_trace(asm.assemble(MIXED_SRC)))
    check("cpu_fill", [len(rows), 1 << log],
          lambda: fill_dev.cpu_fill(rows, prm),
          lambda: fill_dev.cpu_fill_plain(rows, prm),
          *fill_cost(comps, rows), full)
    view, trace = LocalProver(fib_guest()).trace(
        public_input=encode_u32s(FIB_N if full else 50))
    comps, log, rows, prm = rows_of(view, trace)
    if full and log != FULL_LOG:
        raise RuntimeError(f"fib({FIB_N}) gives a 2^{log} CPU component")
    N = 1 << log
    rec = check("cpu_fill", [len(rows), N],
                lambda: fill_dev.cpu_fill(rows, prm),
                lambda: fill_dev.cpu_fill_plain(rows, prm),
                *fill_cost(comps, rows), full)
    if "ms" in rec:
        timed["cpu_fill"] = rec
    del rows
    comps, log_sizes, traces = build_machine_traces(view, trace, device=dev)
    mat = traces[0]
    del traces
    # K6 --------------------------------------------------------------------
    cpu = comps[0]
    relations = draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))
    ctx = GenContext(mat, None, relations, log, dev, params=cpu.params())
    cpu.evaluate(ctx)
    src, meta = logup_operands(_pair_entries(ctx.entries, ctx.be), N)
    del ctx, mat
    B = int(meta.shape[1])
    words = {0: 1, 1: N, 2: 4, 3: 4 * N}
    in_bytes = 4 * sum(words[m] for m in meta[..., 1].reshape(-1).tolist())
    rec = check("logup_columns", [B, N, 4],
                lambda: logup_columns(src, meta, N),
                lambda: logup_columns_plain(src, meta, N),
                in_bytes + 16 * B * N, N * logup_ops(meta), full, reps=5)
    if "ms" in rec:
        timed["logup_columns"] = rec
    del src
    timed.update(check_prover_kernels(comps, log_sizes))
    return timed


def check_prover_kernels(comps, log_sizes) -> dict:
    """K1-K4, timed, at the largest shapes a machine proof of these
    components gives them: the interaction columns of its largest
    component (4 per LogUp batch) interpolated on its trace domain,
    evaluated on the 4x domain for the composition and hashed as leaves
    of their commitment; the first parent layer of the composition's
    tree; the quotients of the largest component's size group (every
    role's columns, samples at its mask offsets); and the first FRI
    fold.  Returns {kernel name: record}."""
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.ops import blake2s, cfft, circle, fri, quotients
    from nexus_zkvm_tpu_torch.prover.stark import _build_samples, build_plan
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(2027)
    P = (1 << 31) - 1

    def rand(shape, hi=P):
        return from_u32(rng.integers(0, hi, shape, dtype=np.uint32), dev)

    def felt():
        return rng.integers(0, P, 4).astype(np.uint64)

    def butterflies(C, k):
        return C * k * (1 << (k - 1))

    cfg = T.PcsConfig()
    blowup = cfg.fri.log_blowup
    infos = [component_info(c) for c in comps]
    plan = build_plan(log_sizes, infos, cfg)
    n = max(log_sizes)
    C = 4 * infos[log_sizes.index(n)].n_logup_cols
    out = {}

    def keep(rec):
        out[rec["name"]] = rec

    # K1: commit:inter's interpolation, then the composition's LDE
    N = 1 << n
    x = rand((C, N))
    keep(check("circle_ifft", [C, N], lambda: cfft.interpolate(x),
               lambda: cfft.interpolate_plain(x), 2 * 4 * C * N + 4 * N,
               butterflies(C, n) * (2 * ADD + MUL) + C * N * MUL, True))
    del x
    E = 1 << (n + 2)
    x = rand((C, E))
    keep(check("circle_fft", [C, E], lambda: cfft.evaluate(x),
               lambda: cfft.evaluate_plain(x), 2 * 4 * C * E + 4 * E,
               butterflies(C, n + 2) * (2 * ADD + MUL), True))
    del x
    # K2: the interaction commitment's leaves; the composition tree's
    # first parent layer
    R = 1 << (n + blowup)
    mat = rand((C, R))
    keep(check("blake2s_messages", [R, C], lambda: blake2s.hash_rows(mat.t()),
               lambda: blake2s.hash_rows_plain(mat.t()), 4 * C * R + 32 * R,
               R * -(-4 * C // 64) * COMPRESS, True, reps=5))
    del mat
    s0 = plan.n_comp_trace_log + blowup
    leaves = rand((1 << s0, 8), 1 << 32)
    keep(check("blake2s_parents", [1 << s0, 8],
               lambda: blake2s.hash_parents(leaves),
               lambda: blake2s.hash_rows_plain(leaves.reshape(-1, 16)),
               48 * (1 << s0), (1 << (s0 - 1)) * COMPRESS, True))
    del leaves
    # K3: the largest component's size group, as prove() builds it
    s = n + blowup
    roles = list(dict.fromkeys(plan.metas[i].role for i in plan.groups[s]))
    rows = [len(plan.role_size_cols(r, s)) for r in roles]
    M = 1 << s
    blocks = [rand((r, M)) for r in rows]
    sampled = [np.stack([felt() for _ in m.offsets]) for m in plan.metas]
    samples = _build_samples(plan, circle.oods_point_from_felt(felt()),
                             sampled)[s]
    a = quotients.prep_args_full(samples, felt(), 0, sum(rows))
    consts, gcs = from_u32(a["consts"], dev), from_u32(a["gcs"], dev)
    xs, ys = circle.dev_committed_points(s, dev)
    keep(check("deep_quotients", [sum(rows), M],
               lambda: quotients.accumulate_blocks(blocks, xs, ys, consts,
                                                   gcs),
               lambda: quotients.accumulate_blocks_plain(blocks, xs, ys,
                                                         consts, gcs),
               *quotient_cost(rows, M, a["gcs"]), True, reps=5))
    del blocks
    # K4: the first circle fold of the composition's domain
    v = rand((1 << s0, 4))
    tw = fri.dev_circle_fold_twiddles(s0, dev)
    alpha = felt()
    L = 1 << (s0 - 1)
    keep(check("fri_fold", [1 << s0, 4], lambda: fri.fold(v, alpha, tw),
               lambda: fri.fold_plain(v, alpha, tw), L * 52,
               L * (QM31_MUL + 4 * MUL + 12 * ADD), True))
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: parity and the slice
# ---------------------------------------------------------------------------

def tree_eq(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tree_eq(u, v) for u, v in zip(a, b))
    if hasattr(a, "__dict__"):
        return tree_eq(vars(a), vars(b))
    if hasattr(a, "shape"):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def phase_parity(comps, log_n: int = PARITY_LOG):
    import nexus_zkvm_tpu_torch as T
    t0 = time.perf_counter()
    p_cpu = T.prove(comps, [log_n, TABLE_LOG], make_traces(log_n),
                    T.Blake2sChannel(), T.PcsConfig(), device="cpu")
    t1 = time.perf_counter()
    p_gpu = T.prove(comps, [log_n, TABLE_LOG], make_traces(log_n),
                    T.Blake2sChannel(), T.PcsConfig(), device="cuda")
    t2 = time.perf_counter()
    if not tree_eq(p_cpu, p_gpu):
        raise RuntimeError("CPU and CUDA proofs differ")
    if not T.verify(comps, p_gpu, T.Blake2sChannel(), T.PcsConfig(),
                    device="cuda"):
        raise RuntimeError("parity proof does not verify")
    emit({"phase": "parity", "log_rows": log_n, "equal": True,
          "cpu_prove_s": t1 - t0, "cuda_prove_s": t2 - t1})


def phase_slice(comps, log_n: int = FULL_LOG) -> dict:
    import copy
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    cfg = T.PcsConfig()
    traces = make_traces(log_n)
    log_sizes = [log_n, TABLE_LOG]
    kernels.reset_launches()
    # the first proof is cold: it builds the host twiddle tables and the
    # device constants; the second, warm, is timed with its phase
    # breakdown (each phase synchronizes the card)
    t0 = time.perf_counter()
    T.prove(comps, log_sizes, traces, T.Blake2sChannel(), cfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with profiled() as prof:
        t0 = time.perf_counter()
        proof = T.prove(comps, log_sizes, traces, T.Blake2sChannel(), cfg)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ok = T.verify(comps, proof, T.Blake2sChannel(), cfg)
    verify_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if not ok:
        raise RuntimeError("the 2^20 proof does not verify")
    bad = copy.deepcopy(proof)
    dec = bad.openings["main"][0][1]
    dec.column_values[0] = np.array(dec.column_values[0])
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % ((1 << 31) - 1)
    if T.verify(comps, bad, T.Blake2sChannel(), cfg):
        raise RuntimeError("a tampered proof verifies")
    # every kernel of the prover core: all but the machine's trace fill
    missing = [k for k, v in launches.items() if v == 0 and k != "cpu_fill"]
    if missing:
        raise RuntimeError(f"kernels not launched on the slice: {missing}")
    emit({"phase": "slice", "log_rows": log_n, "main_columns": 3 * K_SQUARES,
          "constraints": 2 * K_SQUARES, "lookup_fractions": K_SQUARES,
          "verified": True, "tampered_rejected": True,
          "prove_s": prove_s, "prove_cold_s": cold_s, "verify_s": verify_s,
          "rows_per_s": (1 << log_n) / prove_s, "peak_bytes": peak,
          "phase_s": prof.times, "launches": launches})
    return launches


def fib_u32(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, (a + b) & 0xFFFFFFFF
    return a


# ---------------------------------------------------------------------------
# Bounds of the device programs that are still plain PyTorch (rows 11-13)
# ---------------------------------------------------------------------------

class CountingBackend:
    """The numpy Felt backend with a tally of 32-bit operations per trace
    row, under the same operation model as the kernels' bounds: each
    result element counts its operation once, per row of the evaluation
    (values shared by all rows, as constants, are not counted)."""
    name = "np"

    def __init__(self, rows: int):
        from nexus_zkvm_tpu_torch.air.expr import NP
        self.np, self.rows, self.ops = NP, rows, 0.0

    def _tally(self, out, per_element):
        size = np.asarray(out).size
        if size >= self.rows:
            self.ops += per_element * size / self.rows
        return out

    def m31_add(self, a, b):
        return self._tally(self.np.m31_add(a, b), ADD)

    def m31_sub(self, a, b):
        return self._tally(self.np.m31_sub(a, b), ADD)

    def m31_neg(self, a):
        return self._tally(self.np.m31_neg(a), ADD)

    def m31_mul(self, a, b):
        return self._tally(self.np.m31_mul(a, b), MUL)

    def qm31_mul(self, a, b):
        return self._tally(self.np.qm31_mul(a, b), QM31_MUL / 4)

    def qm31_mul_m31(self, q, m):
        return self._tally(self.np.qm31_mul_m31(q, m), MUL)

    def embed(self, m):
        return self.np.embed(m)

    def const(self, x):
        return self.np.const(x)

    def qconst(self, x):
        return self.np.qconst(x)


def constraint_ops_per_row(comp) -> float:
    """Operations per evaluation row of one component's composition:
    its constraints and LogUp constraints as evaluate() writes them, the
    alpha accumulation of each, the division by v_n, the alpha shift and
    the bucket add."""
    from nexus_zkvm_tpu_torch.air.component import (InfoContext,
                                                    _finalize_logup)
    from nexus_zkvm_tpu_torch.air.expr import Felt

    class Counting(InfoContext):
        def __init__(self, params, be):
            super().__init__(params=params)
            self.be = be

        def _felt(self, f):
            return Felt(f.v, f.kind, self.be, f.deg)

        def main(self, i, off=0):
            return self._felt(super().main(i, off))

        def pre(self, j, off=0):
            return self._felt(super().pre(j, off))

        def inter(self, b, off=0):
            return self._felt(super().inter(b, off))

        @property
        def is_first(self):
            return self._felt(InfoContext.is_first.fget(self))

    be = CountingBackend(InfoContext.ROWS)
    ctx = Counting(comp.params(), be)
    comp.evaluate(ctx)
    _finalize_logup(ctx)
    K = ctx.n_constraints
    return be.ops + K * (QM31_MUL + 4 * ADD) + 4 * MUL + QM31_MUL + 4 * ADD


def interaction_eval_cost(comps, log_sizes):
    """Bytes and operations of the evaluate part of the interaction phase
    (table row 10b), which builds the operands K6 takes: every main and
    preprocessed column read once; per fraction and row, its denominator
    sum_i alpha^i v_i - z (QM31 x M31 products and QM31 adds) written as
    a QM31, and its numerator written as an M31 where it is a column.
    The tuple values' own expressions are not counted."""
    from nexus_zkvm_tpu_torch.air.component import InfoContext
    from nexus_zkvm_tpu_torch.air.expr import Felt

    class Fractions(InfoContext):
        def __init__(self, params):
            super().__init__(params=params)
            self.fractions = []        # (numerator is a column, width)

        def add_fraction(self, mult, rel, values):
            column = isinstance(mult, Felt) and np.asarray(mult.v).size > 1
            self.fractions.append((column, len(values)))
            super().add_fraction(mult, rel, values)

    ops = nbytes = 0.0
    for comp, n in zip(comps, log_sizes):
        ctx = Fractions(comp.params())
        comp.evaluate(ctx)
        rows = 1 << n
        nbytes += 4 * rows * (comp.n_main + len(comp.preprocessed(4)))
        for column, w in ctx.fractions:
            nbytes += rows * (16 + 4 * column)
            ops += rows * ((w - 1) * (4 * MUL + 4 * ADD) + 4 * ADD)
    return nbytes, ops


def plain_phase_bounds(comps, log_sizes, proof, config) -> dict:
    """Least times of the plain-PyTorch programs of a proof (table rows
    10b-13) from its shapes: the interaction phase's evaluate part,
    composition over the 4x domains, the OODS Kron-basis dots, and the
    opening gather."""
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.prover.stark import build_plan
    infos = [component_info(c) for c in comps]
    nbytes, ops = interaction_eval_cost(comps, log_sizes)
    out = {"interaction_eval": dict(zip(("bound_ms", "bound_by"),
                                        bound(nbytes, ops)),
                                    ops=ops, bytes=nbytes)}
    ops = nbytes = 0.0
    for comp, info, n in zip(comps, infos, log_sizes):
        rows = 1 << (n + 2)
        ops += constraint_ops_per_row(comp) * rows
        nbytes += rows * (4 * (info.n_main + info.n_pre + 1)
                          + 16 * info.n_logup_cols + 16)
    out["composition"] = dict(zip(("bound_ms", "bound_by"),
                                  bound(nbytes, ops)), ops=ops, bytes=nbytes)
    plan = build_plan(log_sizes, infos, config)
    ops = nbytes = 0.0
    groups = {}
    for m in plan.metas:
        nbytes += 4 * (1 << m.trace_log)
        for o in m.offsets:
            groups[(m.role, m.trace_log, o)] = \
                groups.get((m.role, m.trace_log, o), 0) + 1
    for (_role, tlog, _o), C in groups.items():
        ops += (1 << tlog) * (C * 4 * (MUL + ADD) + QM31_MUL)
    out["oods"] = dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops)),
                       ops=ops, bytes=nbytes)
    decs = [d for v in proof.openings.values() for _s, d in v] \
        + list(proof.fri_proof.inner_decommitments)
    nbytes = 2 * sum(sum(len(v) * 4 for v in d.column_values)
                     + len(d.sibling_hashes) * 32 for d in decs)
    out["openings"] = dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0)),
                           ops=0, bytes=nbytes)
    return out


def phase_machine() -> dict:
    """The fib guest through LocalProver on the card at a 2^20-row CPU
    component; returns the launch counts of that run."""
    import copy
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine.driver import verify_machine
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s, decode_u32s
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    from nexus_zkvm_tpu_torch.vm import asm, k_trace
    prover = LocalProver(fib_guest())          # default PcsConfig, card
    public = encode_u32s(FIB_N)
    t0 = time.perf_counter()
    _v, trace = prover.trace(public_input=public)
    emulate_s = time.perf_counter() - t0
    steps = int(len(trace.steps["clk"]))
    del trace
    kernels.reset_launches()
    # the first proof is cold (host twiddle tables, device constants);
    # the second is warm; the third repeats it with its phase breakdown
    # (each phase synchronizes the card)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        prover.prove_with_input(public_input=public)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    cold_s, prove_s = secs
    torch.cuda.reset_peak_memory_stats()
    with profiled() as prof:
        t0 = time.perf_counter()
        view, proof = prover.prove_with_input(public_input=public)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ok = prover.verify(view, proof)
    verify_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if not ok:
        raise RuntimeError("the machine proof does not verify")
    cpu_log = proof.stark.log_sizes[0]
    if cpu_log != FULL_LOG:
        raise RuntimeError(f"CPU component at 2^{cpu_log}, not 2^{FULL_LOG}")
    if decode_u32s(view.public_output, 1)[0] != fib_u32(FIB_N):
        raise RuntimeError("wrong fib output")
    bad = copy.deepcopy(proof)
    dec = bad.stark.openings["main"][0][1]
    dec.column_values[0] = np.array(dec.column_values[0])
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % ((1 << 31) - 1)
    if prover.verify(view, bad):
        raise RuntimeError("a tampered machine proof verifies")
    view2, _t = k_trace(asm.assemble(OTHER_SRC))
    if verify_machine(view2, proof, prover.config, device=prover.device):
        raise RuntimeError("the proof verifies another program's claim")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the machine path: "
                           f"{missing}")
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    comps = build_components(view, 1)[0]
    emit({"phase": "plain_bounds", "log_sizes": proof.stark.log_sizes,
          "programs": plain_phase_bounds(comps, proof.stark.log_sizes,
                                         proof.stark, prover.config)})
    emit({"phase": "machine", "guest": "examples/guests/fib.s", "n": FIB_N,
          "steps": steps, "cpu_log_rows": cpu_log,
          "log_sizes": proof.stark.log_sizes, "verified": True,
          "tampered_rejected": True, "other_claim_rejected": True,
          "emulate_s": emulate_s, "prove_s": prove_s, "prove_cold_s": cold_s,
          "prove_profiled_s": profiled_s,
          "verify_s": verify_s, "rows_per_s": (1 << cpu_log) / prove_s,
          "steps_per_s": steps / prove_s, "peak_bytes": peak,
          "phase_s": prof.times, "launches": launches})
    return launches


def phase_machine_parity(n: int = FIB_PARITY_N):
    """The fib guest at a small n proved on the CPU (plain path) and on
    the card: the serialized proofs must be byte-equal."""
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    out, secs = {}, {}
    for device in ("cpu", "cuda"):
        prover = LocalProver(fib_guest(), device=device)
        t0 = time.perf_counter()
        view, proof = prover.prove_with_input(public_input=encode_u32s(n))
        secs[device] = time.perf_counter() - t0
        out[device] = proof_to_bytes(proof)
    if out["cpu"] != out["cuda"]:
        raise RuntimeError("CPU and CUDA machine proofs differ")
    if not prover.verify(view, proof):
        raise RuntimeError("the small machine proof does not verify")
    emit({"phase": "machine_parity", "n": n, "equal_bytes": True,
          "proof_bytes": len(out["cuda"]), "cpu_prove_s": secs["cpu"],
          "cuda_prove_s": secs["cuda"]})


def gpu_name_and_limit() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from nexus_zkvm_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    card = gpu_name_and_limit()
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    ptxas = {}
    for f in sorted(kernels.BUILD_DIR.glob("*.ptxas.txt")):
        ptxas[f.name.split("-")[0]] = [ln.strip() for ln in
                                       f.read_text().splitlines()
                                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "gpu": card, "ptxas": ptxas})

    timed = check_kernels(full=True)
    comps = make_components()
    phase_parity(comps)
    phase_slice(comps)
    launches = phase_machine()
    phase_machine_parity()

    from nexus_zkvm_tpu_torch.kernels import KERNELS
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"nexus_zkvm_tpu_torch/csrc/{REPLACES[name][0]}",
        "replaces": REPLACES[name][1], "launches": launches[name],
        "max_abs_err": timed[name]["max_abs_err"], "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"], "library_ms": None,
        "shape": timed[name]["shape"]} for name in KERNELS]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
