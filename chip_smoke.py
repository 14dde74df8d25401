#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-machine [CHECKOUT]
    python3 chip_smoke.py --time-stream [CHECKOUT]
    python3 chip_smoke.py --time-mesh [CHECKOUT]
    python3 chip_smoke.py --mesh-nccl
    python3 chip_smoke.py --time-memory

The second form only times warm fib 2^20 machine proofs (phase 5's
path) and kernel K7 at that proof's shapes (`time_k7`), the third warm
fib 2^22 proofs in the memory mode (phase 6's path) and kernels K10 and
K11 at that proof's shapes (`time_stream_kernels`); both then time K6
and K8 (`time_k6_k8`), K3 and K12 (`time_k3_k12`) and K9 (`time_k9`:
the opening gather, its host tables and the whole opening call; the
memory mode's streamed chunk gather) on one more proof's own calls
(`record_timing_calls`).  The fourth times the warm fib proofs of
phase 8 over gloo ranks sharing the card (`time_mesh`).  Each runs with
the package of another checkout (this one by default), so that two
checkouts can be compared on one card: run it for each in turn.  The
fifth, on a machine of two cards or more, proves the fib 2^20 guest
over NCCL, a rank a card, on 4 ranks (with four cards) and on 2, with
the checks of phase 8 against one process alone (`mesh_nccl`).  The
sixth measures the memory mode's routes (`time_memory`): the fib guest
at 2^21, 2^22 and 2^23-row CPU components under each route of
MEMORY_ROUTES (resident in 1, 2 and 4 composition passes, the
interaction tree streamed alone, both trees streamed in 2 and 4 passes,
STREAM_FORCED's thresholds), each in a fresh process: cold and warm
seconds (the median of 3), the phases, the allocated and reserved
peaks, out of memory or not, the proofs of a size byte-equal; then the
fastest route at each size whose reserved peak stays within FIT_SHARE
of the card's memory, and 2^24 rows by the default route.  The
defaults of ``MemoryConfig.for_device`` were chosen from its output.
Then segmented proofs (SEGMENTED_ROUTES: a route name ending in
``_s<k>`` proves in 2^k-step segments): fib at 2^24 steps in 2^21-,
2^22- and 2^23-step segments by the default route and STREAM_FORCED's,
and at 2^25 steps in 2^22-step segments, the proofs of one (steps,
segment log) byte-equal; then machine2's routes (MACHINE2_ROUTES: a
route name starting ``m2_``): the fib guest through ``prove_machine2``
with its largest family, ex_alu, at 2^21, 2^22 and 2^23 rows by the
card's default route and `machine2_forced`'s, and at 16,777,200 steps
(ex_alu at 2^24) in one proof by the default route, each with the
process's peak resident host memory; ``LOG:ROUTE`` arguments run only
those (``--time-memory 24:default_s22``, ``23:m2_default``).

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build   — compile every CUDA source of ``nexus_zkvm_tpu_torch/csrc``
             (kernels K1-K6, K8-K12) with nvcc for sm_90a; print the
             card's name and power limit.  Then K7, generated from each
             constraint tape: the pieces of both tapes of every
             component of the fib proof, built in one batch (`build_k7`:
             seconds, and each piece's registers and spill bytes).
2. kernel  — every kernel against its plain PyTorch version on the same
             CUDA tensors (uint32 equality), first at the shapes of the
             synthetic slice (phase 4), then, timed, at the shapes the
             machine proof (phase 5) gives it: its time, the plain
             version's time and the bound the card sets for the work.
             The CPU trace fill (K5) runs on a mixed-opcode program and
             on the step record of the fib guest at 2^20 rows.  A fib
             proof at that size is then recorded on the card: every
             call of the constraint tapes (K7: the composition of every
             component over its 4x domain, the CPU component's 2^22
             rows and keccak included, and every component's LogUp
             operands), of the LogUp columns (K6: every component's,
             then the largest again with zero denominators), of the OODS
             dots (K8: the proof's one launch over every (role, size,
             offset) group, then each group alone), of the opening
             gather (K9: its host tables timed, the five largest pieces
             printed) and of the DEEP quotients (K3: every size
             group, then the largest with one sample's V forced to 0)
             is run again through the kernel and the plain version on
             its own inputs; all of the proof's K6 and K3 launches are
             timed in turn.  K1-K4 at that proof's shapes (see
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
             ``sdk.LocalProver`` on the card, default PcsConfig and
             MemoryConfig: a cold and a warm prove (phase times), verify,
             reject a tampered opening and another program's claim.  It
             stays resident (the prover notes no streamed tree and one
             composition pass): every kernel but the memory mode's three
             must have been launched, and those three not.  Then the fib guest at n = 10
             proved on the CPU and on the card: the proof bytes must be
             equal.  Then the keccak guest (``KECCAK_SRC``, one keccak-f
             permutation) the same way (`phase_keccak_parity`): its
             keccak component's real rows through K7's pieces.
5a. selftest — the prover's self-test (``selftest=True``) on the fib
             guest at n = 10 through machine v1: the same bytes as
             without it, no OODS sample mismatch, every component OK and
             the total equal to the composition's sampled value, read
             from the returned report; then with the CPU component's
             domain accumulator moved by one: BAD on it alone, its
             constraints equal one by one (the plain tape interpreter
             on the card's tensors).
5b. machine2 — the same fib guest and n through
             ``machine2.prove_machine2`` on the card (default PcsConfig
             and MemoryConfig): the families ex_alu at (51, 2^20) and
             ex_branch at (54, 2^18) filled on the host (numpy, scope
             ``f:machine2``), K7 on the 12 families' generated tapes; a
             cold and a warm, profiled prove (`machine2_prove`), verify,
             reject a tampered opening, another claim, the exit code
             flipped and the proof under machine v1's verifier; the
             launches must be
             MACHINE2_KERNELS (no K5, none of the memory mode's three);
             rows/s beside phase 5's.  One more proof has its calls of
             K3, K4 and K6-K9 recorded and each run again through the kernel
             and its plain version, as phase 2 does for machine v1
             (`check_recorded`, phases ``machine2_*``), and K1-K4 are
             checked at that proof's shapes (`check_prover_kernels`,
             untimed).
5c. machine2_parity — the fib guest at n = 10 and the keccak guest
             through machine2 on the CPU and the card, byte-equal; the
             constraint harness (``air.testing``) on the n = 10 machine2
             traces on the card finds no violation.
5d. machine2_large — machine2 above 2^20 rows: the fib guest at n =
             838,858 (ex_alu at (51, 2^22)) through ``prove_machine2``
             by the card's default route (`machine2_prove`: cold, then
             warm and profiled, verify, the four forgeries rejected),
             the reserved peak within FIT_SHARE of the card and the
             host's resident memory within FIT_SHARE of the host's;
             then one more proof by that route and one by a route
             forced to stream the main and interaction trees of 2^23
             leaves and compose ex_alu in 4 passes, the first call of
             each shape of K1-K4 and K6-K12 over the two held to its
             plain version as the proof makes it (`check_inline`,
             INLINE_M2): the same bytes, and no kernel either launched
             left unheld; the routes launch every kernel but K5
             between them.
5e. cli    — ``python -m nexus_zkvm_tpu_torch.cli prove`` of the fib
             guest at n = 10 on the card and with ``--cpu``, each a
             process: byte-equal bundles, equal to the JAX package's CLI
             bundle; ``verify`` exits 0, and 1 on a bundle with one byte
             flipped.
6. machine_stream — the large-trace memory mode, forced by
             STREAM_FORCED: the fib guest at n = 838,858 (a CPU component
             of 2^22 rows) through ``LocalProver``, a cold and a warm,
             profiled prove; the prover notes its main and interaction
             trees streamed and its CPU component composed in 4 row
             passes (one K7 launch a pass); verify, reject a tampered
             opening and another claim.  Every kernel must have been
             launched.
6b. machine_large — the same guest by the card's default route
             (``MemoryConfig.for_device``): a cold and a warm prove,
             verify, reject a tampered opening and another claim; its
             bytes equal to phase 6's proof, its reserved peak within
             FIT_SHARE of the card's memory.
6c. machine_segments — segmented machine proofs
             (``machine.prove_machine(..., segment_log=k)``, each
             2^k-step segment its own CPU component): SEGMENTED_SRC at
             2^4-step segments under the CPU tests' PcsConfig, its
             blake2s the JAX package's SEGMENTED_PROOF_BLAKE2S, and the
             fib guest at n = 10 in four segments, default PcsConfig,
             each byte-equal to the port's CPU proof (proved in a
             process of its own meanwhile); then fib at n = 3,355,438
             (16,777,200 steps) in 2^22-step segments, four 2^22-row
             CPU components, by the card's default route: a cold and a
             warm, profiled proof (each segment's `f:cpu`, the peaks by
             phase), verify, a tampered opening and another claim
             rejected, the reserved peak of both within FIT_SHARE of
             the card, every kernel K1-K12 launched; then one more
             proof whose calls are held to their plain versions as it
             makes them (every segment's K5, one call of each shape of
             K3, K7, K8 and K11) and K5 on each segment's first steps
             against the numpy host fill.
7. stream_parity — the fib 2^20 proof again under a MemoryConfig that
             streams every tree of 2^21 rows or more in 16-column chunks
             and composes the CPU component in 4 passes: its proof bytes
             must equal the default route's and its peak device memory
             must be lower.  Then the memory mode's kernels (K10-K12, and
             K7 over one pass) against their plain versions, timed, at
             the shapes of phase 6 (STREAM_FORCED's chunks and passes);
             and K9 on every streamed chunk's
             gather of one more 2^22 proof, then timed at that chunk's
             shape beside `torch.index_select` (`check_stream_gathers`).
8. parallel — the prover over a mesh (``nexus_zkvm_tpu_torch.parallel``),
             each rank a process holding its row windows: 4 gloo ranks
             sharing the card commit the interaction's shape of phase 5
             in windows (root equal to the single process's; each rank's
             step times and its bound); the fib guest of phase 5 on 2
             gloo ranks and at a 2^19-row CPU component on 4: on every
             rank the proof bytes equal the single process's and verify,
             its peak device memory within a share of the single
             process's, and rank 0's calls of every kernel wrapper equal
             their plain versions at its windows, shares and chunks.
             NCCL across cards is the mode ``--mesh-nccl`` (`mesh_nccl`).
9. kernels — one JSON line with every kernel's numbers: launches from
             the path it belongs to (phase 5, or phase 6 for the memory
             mode's three; K1 counts one launch a transform, K8 one a
             proof), from phase 5b's two proofs
             (``machine2_launches``) and from phase 6c's two 2^24-step
             proofs (``segments_launches``), from phase 5d's two
             default proofs and its forced one (``machine2_large_launches``,
             ``machine2_forced_launches``), times at that path's shapes;
             ``circle_fft`` adds ``extend``, the composition's
             zero-extending LDE (see `check_prover_kernels`), and
             ``oods_dot`` ``all_groups``, its launch over all of a
             proof's groups, ``gather_openings`` ``streamed_chunk``, the
             memory mode's gather beside ``torch.index_select`` (its
             ``library_ms``; no PyTorch call gathers a whole proof's
             openings).

The last line is {"ok": true, "device": {...}}.  Without a CUDA device
the script exits with code 2 and prints no result.

Bounds: the least time the card could take, the larger of bytes moved
(each input read once, each output written once) over 3.35 TB/s and
32-bit integer operations over 33.5 Tops/s.  That rate is the issue
limit, 4 schedulers x 32 lanes = 128 lane operations per SM per clock
(132 SMs, 1.98 GHz), which is the table's 67 TFLOP/s float32 rate with
an FMA counted as one operation; the INT32 pipe alone (64 lanes per SM)
is half of it, so the bound is a floor, not a target (nvcc issues some
integer adds, shifts and moves on the FMA pipe as IMAD, so a kernel can
beat the INT32 pipe's rate alone).  K9's times are queued behind a sleep (`cuda_ms`): a
launch of a few us would otherwise time the host.  Operation counts
follow a simple model: an M31 product (widening multiply and fold) is 6
operations, an M31 add or subtract 3, a widening multiply-add into a
uint64 sum 2 and that sum's reduction 6 (K6's lazy products, K8's
sums), a Blake2s compression 968 (80 G
mixes of 12: a three-input add counts once, as IADD3 does it, and so
does a three-input xor, as LOP3 does it; plus 8 for the output xors).
A constraint tape (K7) counts the field operations of its instructions
(`tape_cost`), not the interpreter's decode.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# cycles of `torch.cuda._sleep` that timed launches queue behind (about
# 50 ms at 1.98 GHz), so that their events measure the card, not the
# host's launches
QUEUE_CYCLES = 100_000_000
MUL, ADD = 6, 3
P31 = (1 << 31) - 1
COMPRESS = 80 * 12 + 8
QM31_MUL = 16 * MUL + 14 * ADD
QM31_INV = 57 * MUL + 20 * ADD
M31_INV = 37 * MUL
# a widening 32 x 32 -> 64-bit multiply-add, and the reduction of a
# uint64 sum to a word (two folds and a subtract)
MAD, RED = 2, 6
# K6's lazily reduced products (csrc/logup.cu): a QM31 product (16
# products, each coordinate reduced once); the norm |A^2 - R B^2|^2 of
# a QM31 denominator and the conjugate products (A - B u) conj(.)
QMUL_LAZY = 16 * MAD + 4 * RED + 5 * ADD
NORM = 16 * MAD + 9 * RED + 7 * ADD

K_SQUARES = 64
FULL_LOG = 20
TABLE_LOG = 4
PARITY_LOG = 10
FIB_N = 209_700          # 5 steps an iteration: a 2^20-row CPU component
FIB_PARITY_N = 10
FIB_STREAM_N = 838_858   # 4,194,300 steps: a 2^22-row CPU component
STREAM_LOG = 22
# the fib guest's n for at most 2^log steps (5 n + 10), a CPU component
# of 2^log rows (`--time-memory`)
FIB_MEMORY_N = {21: 419_428, 22: FIB_STREAM_N, 23: 1_677_718,
                24: 3_355_438, 25: 6_710_884}
# MemoryConfig fields that stream every size group above 2 GiB (the main
# and interaction trees of 2^23 leaves of the 2^22 proof) in 16-column
# chunks and compose its CPU component in 4 passes (phase 6)
STREAM_FORCED = {"stream_commit_bytes": 2 << 30,
                 "stream_chunk_bytes": 1 << 28, "comp_nat_budget": 8 << 30}
# the share of the card's memory a default route may reserve at its peak
FIT_SHARE = 0.85
# phase machine_segments: fib at 16,777,200 steps in 2^22-step segments,
# four 2^22-row CPU components, by the card's default route
SEGMENT_LOG = 22
FIB_SEGMENTS_N = 3_355_438
SEGMENTS = 4
# SEGMENTED_SRC proved at SEGMENTED_LOG under SEGMENTED_CONFIG (the CPU
# tests' PcsConfig), and the blake2s of the JAX package's proof of it
# (recorded in tests/test_torch_machine.py)
SEGMENTED_LOG = 4
SEGMENTED_CONFIG = {"pow_bits": 2, "log_blowup": 1, "log_last_layer": 0,
                    "n_queries": 8}
SEGMENTED_PROOF_BLAKE2S = \
    "fab8c4cc264ec28196de01b162e68a7f37d2888e38bd5e40bd983d5158d3cc92"
# steps of each segment whose K5 rows are also held to the numpy host
# fill (`cpu.fill_cpu`)
FILL_NUMPY_STEPS = 1 << 16

# the kernels that run only in the large-trace memory mode
MEMORY_MODE = ("blake2s_leaves_stream", "quotient_colsums",
               "quotient_finalize")

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

# one keccak-f permutation (the custom instruction) of a heap block: the
# keccak component's real rows through its generated K7 pieces
KECCAK_SRC = """
        addi a7, zero, 0x403
        ecall
        mv   t1, a0
        li   t2, 0x12345678
        sw   t2, 4(t1)
        keccakf x0, t1, x0
        lw   t3, 8(t1)
        lw   t4, 0x84(zero)
        sw   t3, 0(t4)
""" + EXIT_ASM

# a different claim: a proof of fib must not verify against it
OTHER_SRC = """
        addi t0, zero, 3
        lw   t1, 0x84(zero)
        sw   t0, 0(t1)
""" + EXIT_ASM


# tests/test_torch_machine.py's segmented program: 2^4-step segments
# give several CPU components
SEGMENTED_SRC = """
        addi t0, zero, 40
    loop:
        addi t0, t0, -1
        bne  t0, zero, loop
        lw   t1, 0x84(zero)
        sw   t0, 0(t1)
""" + EXIT_ASM


def fib_guest():
    from nexus_zkvm_tpu_torch.sdk import Guest
    return Guest.from_asm((ROOT / "examples" / "guests" / "fib.s")
                          .read_text())


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def proof_digest(blob: bytes) -> str:
    return hashlib.blake2s(blob).hexdigest()


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """ms a call of ``fn`` by CUDA events over ``reps`` calls after a
    warm one; ``queued``: the calls are launched behind a sleep of
    QUEUE_CYCLES, so the events time the card's work alone (a call of a
    few us would otherwise time the host's launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    """ms of one call of ``fn`` on the host's clock, the card
    synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    import torch
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max()) if d.numel() else 0


# ---------------------------------------------------------------------------
# Workload: the test fixture of tests/test_stark_e2e.py, widened
# ---------------------------------------------------------------------------

def make_components(k_squares: int = K_SQUARES):
    """With one square: the fixture of tests/test_stark_e2e.py."""
    from nexus_zkvm_tpu_torch.air import Component

    class WideSquares(Component):
        """k copies of: y = x^2, z = next-row x, y looked up in 'vals'."""
        name = "wide_squares"
        n_main = 3 * k_squares

        def evaluate(self, ctx):
            for k in range(k_squares):
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


def make_traces(log_n: int, k_squares: int = K_SQUARES):
    rows = np.arange(1 << log_n, dtype=np.int64)
    x = ((rows[None, :] + np.arange(k_squares)[:, None]) % 7).astype(np.uint32)
    y = x * x
    z = np.roll(x, -1, axis=1)
    main = []
    for k in range(k_squares):
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
    "air_eval_composition": ("air_eval_gen.cuh",
                             "nexus_zkvm_tpu/air/component.py:601"),
    "air_eval_operands": ("air_eval_gen.cuh",
                          "nexus_zkvm_tpu/air/component.py:346"),
    "oods_dot": ("oods.cu", "nexus_zkvm_tpu/prover/stark.py:197"),
    "gather_openings": ("gather.cu", "nexus_zkvm_tpu/ops/merkle.py:440"),
    "blake2s_leaves_stream": ("blake2s.cu",
                              "nexus_zkvm_tpu/prover/pcs.py:269"),
    "quotient_colsums": ("quotients.cu",
                         "nexus_zkvm_tpu/ops/quotients.py:196"),
    "quotient_finalize": ("quotients.cu",
                          "nexus_zkvm_tpu/ops/quotients.py:215"),
}

# integer operations of a CPU-fill row besides its three M31 inverses
# (shifts, masks, compares, selects, stores and ~100 histogram adds)
FILL_ROW_OPS = 600


def check(name, shape, kernel_fn, plain_fn, nbytes, ops, timed, reps=10,
          plain_reps=2, timed_fn=None, queued=False):
    """Run the kernel and its plain version on the same inputs; raise
    unless their outputs are equal, or unless the wrapper launched its
    kernel on CUDA inputs (on CPU ones it runs the plain version, as
    the CPU tests of the mesh's rank programs have it); time both when
    ``timed`` (the kernel through ``timed_fn`` where given: a launch
    that updates a buffer in place, with no copy to time beside it;
    ``queued``: behind a sleep, see `cuda_ms`)."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    before = kernels.launch_counts()[name]
    got = kernel_fn()
    got, want = (tuple(x) if isinstance(x, tuple) else (x,)
                 for x in (got, plain_fn()))
    if got[0].is_cuda:
        torch.cuda.synchronize()
        if kernels.launch_counts()[name] == before:
            raise RuntimeError(f"{name}: the wrapper did not launch its "
                               f"kernel")
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
        rec.update(ms=cuda_ms(timed_fn or kernel_fn, reps, queued),
                   plain_ms=cuda_ms(plain_fn, plain_reps),
                   bound_ms=b_ms, bound_by=b_by)
    emit(rec)
    return rec


def quotient_epilogue_ops(S: int, points: int) -> float:
    """Operations a point of the epilogue K3 and K12 share
    (csrc/quotients.cu `quotient_sum`): per sample V = x dy - y dx + c0
    (two multiply-adds, an add and a reduction a coordinate), num = sum -
    A y - B (a multiply-add, two adds, a reduction), the norm and
    adjugate (`NORM`), num times the adjugate (`QMUL_LAZY`), 3 products
    of the batched inversion and the term t / m (4 products, a QM31
    add); one M31 inverse for the thread's S x ``points`` norms."""
    per_sample = (4 * (2 * MAD + ADD + RED) + 4 * (MAD + 2 * ADD + RED)
                  + NORM + QMUL_LAZY + 3 * MUL + 4 * MUL + 4 * ADD)
    return S * per_sample + M31_INV / points


def quotient_cost(rows, M: int, gcs: np.ndarray):
    """Bytes and operations of one deep_quotients launch: the blocks and
    the points read, the (M, 4) output written; per point, each (sample,
    column) term's 4 widening multiply-adds, every sample's fold (a mask,
    a shift and an add a coordinate, counted as an add) after every 4
    columns, and the epilogue (`quotient_epilogue_ops`, one inverse a
    thread's points)."""
    from nexus_zkvm_tpu_torch.ops.quotients import quotient_plan
    S, K = len(gcs), sum(rows)
    nnz = int((gcs != 0).any(axis=2).sum())
    points = quotient_plan(rows, M, S)["points"]
    return (4 * K * M + 8 * M + 16 * M,
            M * (nnz * 4 * MAD + S * 4 * -(-K // 4) * ADD
                 + quotient_epilogue_ops(S, points)))


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

    # K1 (and the LDE's zero-extension by 1 and 2) ----------------------------
    for n in (4, 10, 21) if full else (4, 10):
        for C in (1, 192):
            x = rand((C, 1 << n))
            check("circle_ifft", [C, 1 << n], lambda: cfft.interpolate(x),
                  lambda: cfft.interpolate_plain(x), 0, 0, False)
            check("circle_fft", [C, 1 << n], lambda: cfft.evaluate(x),
                  lambda: cfft.evaluate_plain(x), 0, 0, False)
            for b in (1, 2):
                check("circle_fft", [C, 1 << n, 1 << (n + b)],
                      lambda: cfft.evaluate(x, n + b),
                      lambda: cfft.evaluate_plain(
                          cfft.extend_coeffs(x, n + b)), 0, 0, False)
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


def logup_ops(meta, chunk: int) -> int:
    """Operations per row of one logup_columns launch, counted from the
    operand modes of each pair (modes 0 and 1 are M31): a product with
    one M31 factor is 4 M31 products, with two it is one, with none a
    lazily reduced QM31 product; a QM31 denominator's norm and conjugate
    products (`NORM`) and t = num * adj, an M31 one none; every pair's
    share of the batched inversion (3 M31 products), t / m (4) and its
    running-sum add; one M31 inverse a ``chunk`` of pairs; the row
    scan's add once per row."""
    def mul(a, b):
        return MUL if a and b else 4 * MUL if a or b else QMUL_LAZY
    pairs = meta[..., 1].t().tolist()
    ops = 4 * ADD + M31_INV * -(-len(pairs) // chunk)
    for n1, d1, n2, d2 in pairs:
        n1, d1, n2, d2 = (m < 2 for m in (n1, d1, n2, d2))
        num, den = n1 and d2 and n2 and d1, d1 and d2
        ops += (mul(n1, d2) + mul(n2, d1) + (ADD if num else 4 * ADD)
                + mul(d1, d2) + (0 if den else NORM + mul(num, False))
                + 3 * MUL + 4 * MUL + 4 * ADD)
    return ops


def oods_cost(shapes) -> tuple:
    """Bytes and operations of one oods_dot launch over groups of
    ``shapes`` [(rows, log_n)]: every sampled word read once, (rows, 4)
    written; a widening multiply-add into a uint64 sum (`MAD`) for each
    of a word's 4 coordinates, a fold (one more) after every 4 words;
    each unit's end: its (row, lo) sums reduced and multiplied by B_lo
    (`stark.oods_plan`: 2^(log_n - k) / H units a row); the basis tables'
    QM31 products."""
    from nexus_zkvm_tpu_torch.prover.stark import OODS_CHUNK, OODS_LO_BITS
    nbytes = ops = 0
    for r, n in shapes:
        k = min(n, OODS_LO_BITS)
        units = (1 << (n - k)) // min(1 << (n - k), OODS_CHUNK)
        nbytes += 4 * (r << n) + 16 * r
        ops += (r << n) * 5 * MAD + r * units * (1 << k) * (
            4 * RED + QM31_MUL + 4 * ADD) + ((1 << k) * k + (
                1 << (n - k)) * (n - k)) * QM31_MUL
    return nbytes, ops


def check_machine_kernels(full: bool = True) -> dict:
    """K5 on the mixed-opcode program and on the fib guest's step record
    (2^20 rows when ``full``); K6-K9 on the recorded calls of a proof of
    that trace (`check_recorded`); K1-K4 at the shapes of that proof."""
    import torch
    from nexus_zkvm_tpu_torch.machine import driver, fill_dev
    from nexus_zkvm_tpu_torch.machine.driver import build_components, _clog2
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
    n = FIB_N if full else 50
    view, trace = LocalProver(fib_guest()).trace(public_input=encode_u32s(n))
    comps, log, rows, prm = rows_of(view, trace)
    if full and log != FULL_LOG:
        raise RuntimeError(f"fib({FIB_N}) gives a 2^{log} CPU component")
    rec = check("cpu_fill", [len(rows), 1 << log],
                lambda: fill_dev.cpu_fill(rows, prm),
                lambda: fill_dev.cpu_fill_plain(rows, prm),
                *fill_cost(comps, rows), full)
    if "ms" in rec:
        timed["cpu_fill"] = rec
    del rows, trace
    log_sizes, recorded = record_main_path(n)
    timed.update(check_recorded(recorded, full))
    del recorded
    torch.cuda.empty_cache()
    timed.update(check_prover_kernels(comps, log_sizes))
    return timed


# the wrappers whose calls a recorded proof keeps: (module, function)
RECORDED = {
    "air_eval_composition": ("nexus_zkvm_tpu_torch.air.tape",
                             "air_eval_composition"),
    "air_eval_operands": ("nexus_zkvm_tpu_torch.air.tape",
                          "air_eval_operands"),
    "logup_columns": ("nexus_zkvm_tpu_torch.air.tape", "logup_columns"),
    "oods_dot_groups": ("nexus_zkvm_tpu_torch.prover.stark",
                        "oods_dot_groups"),
    "gather_openings": ("nexus_zkvm_tpu_torch.ops.merkle",
                        "gather_openings"),
    "accumulate_blocks": ("nexus_zkvm_tpu_torch.ops.quotients",
                          "accumulate_blocks"),
    "fold": ("nexus_zkvm_tpu_torch.ops.fri", "fold"),
}
# K1 and K2, whose calls a mesh proof keeps one of each shape: the
# column shares, the composition's coefficient chunks, the row windows
# and their subtrees (the mesh commit calls them through their modules)
RECORDED_BY_SHAPE = {
    "interpolate": ("nexus_zkvm_tpu_torch.ops.cfft", "interpolate"),
    "evaluate": ("nexus_zkvm_tpu_torch.ops.cfft", "evaluate"),
    "hash_rows": ("nexus_zkvm_tpu_torch.ops.blake2s", "hash_rows"),
    "hash_parents": ("nexus_zkvm_tpu_torch.ops.blake2s", "hash_parents"),
}


def _signature(args) -> tuple:
    """A call's shapes, strides and other arguments."""
    return tuple((tuple(a.shape), a.stride()) if hasattr(a, "stride")
                 else a for a in args)


def record_calls(prove_fn, names=tuple(RECORDED)):
    """Run ``prove_fn()`` with the wrappers ``names`` (of RECORDED and
    RECORDED_BY_SHAPE) wrapped: each call's arguments are kept (the
    composition's bucket as it was before the call, an interpolation in
    place its input), of RECORDED_BY_SHAPE's only the first call of each
    signature, and the call goes on.  Returns (what ``prove_fn``
    returned, {name: [args]})."""
    import importlib
    calls = {name: [] for name in names}
    seen = set()
    saved = []
    for name in names:
        mod, fn = {**RECORDED, **RECORDED_BY_SHAPE}[name]
        m = importlib.import_module(mod)
        orig = getattr(m, fn)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            kept = list(args)
            if _name in RECORDED_BY_SHAPE:
                key = (_name, _signature(args), tuple(kw))
                if key in seen:
                    return _orig(*args, **kw)
                seen.add(key)
            if _name == "air_eval_composition":
                kept[-1] = args[-1].clone()
            elif _name == "interpolate" and (len(args) > 1 or kw):
                kept = [args[0].clone()]      # in place: its input
            calls[_name].append(kept)
            return _orig(*args, **kw)
        saved.append((m, fn, orig))
        setattr(m, fn, wrapped)
    try:
        out = prove_fn()
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
    return out, calls


def record_main_path(n: int, device="cuda"):
    """Prove the fib guest at ``n`` on the card with the wrappers of
    K3, K4 and K6-K9 wrapped (`record_calls`).  Returns (log sizes, {name:
    [args]})."""
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    (_v, proof), calls = record_calls(
        lambda: LocalProver(fib_guest(), device=device)
        .prove_with_input(public_input=encode_u32s(n)))
    return proof.stark.log_sizes, calls


def tape_cost(tape, N: int) -> tuple:
    """Bytes and operations of one K7 launch over N rows: every loaded
    column read once, the outputs written once (composition: 1 / v_n
    read, the (N, 4) bucket read and written; operands: the packed
    buffer of N rows); per row the field operations of the tape's instructions
    (an emit adds its constraint times a row-independent QM31 weight:
    four M31 products for an M31 constraint, a QM31 product for a QM31
    one, and a QM31 add) and the composition epilogue."""
    from nexus_zkvm_tpu_torch.air import tape as tp
    code = tape.program[:, 0]
    per_row = (MUL * int((code == tp.K_MUL).sum())
               + ADD * int(np.isin(code, (tp.K_ADD, tp.K_SUB, tp.K_NEG))
                           .sum())
               + (4 * MUL + 4 * ADD) * int((code == tp.K_EMIT1).sum())
               + (QM31_MUL + 4 * ADD) * int((code == tp.K_EMITQ_HI).sum()))
    cols = len({(r, c) for r, c, _o in tape.loads.tolist()})
    nbytes = 4 * N * cols
    if tape.kind == "domain":
        per_row += 4 * MUL + QM31_MUL + 4 * ADD
        nbytes += 4 * N + 32 * N
    else:
        nbytes += 4 * tape.layout(N)[2]
    return nbytes, N * per_row


def zero_denominators(src, meta, M: int, chunk: int):
    """A copy of K6's operands with the first denominator of some pairs
    set to 0: the first, middle and last pair of the first chunk, the
    first of the second (a boundary) and the last pair; a column's at
    rows 0, 1, M // 2 and M - 1, a constant at every row."""
    out = src.clone()
    B = int(meta.shape[1])
    for b in sorted({0, chunk // 2, chunk - 1, chunk, B - 1} & set(range(B))):
        off, mode = (int(x) for x in meta[1, b])
        w = (1, 1, 4, 4)[mode]
        for r in ((0,) if mode in (0, 2) else (0, 1, M // 2, M - 1)):
            out[off + w * r:off + w * r + w] = 0
    return out


def check_recorded(calls, timed_run: bool, path: str = "") -> dict:
    """Every recorded call (`record_calls`) again through the kernel and
    its plain version, uint32-exact: K7 (the composition of every
    component over its 4x domain from halo-extended blocks, one window
    [0, N) each or, on a mesh rank, its window of it; and every
    component's LogUp operands, on a mesh rank over its natural window
    where the rows split), K6 (every component's LogUp columns, the
    largest also with zero denominators and with a nonzero carry, on a
    mesh rank every call with a nonzero carry), K3 on every size group
    (the largest also with a zero V), K8 on all of the proof's groups in
    its one launch and on each group alone, K9 on the proof's whole
    opening gather, K4 on every fold, and K1 and K2 on each call kept
    (`RECORDED_BY_SHAPE`); timed (``timed_run``) at the largest: the
    largest component's composition and operands (K7) and LogUp columns
    (K6), K8's launch and its largest group, the whole opening gather
    (K9); and all of the proof's K6 and K3 launches in turn.  ``path``
    prefixes the phases of the summaries it emits ("machine2_" for
    machine2's proof, "mesh_" for a mesh rank's)."""
    import torch
    from nexus_zkvm_tpu_torch.air import component as cmp, tape as tp
    from nexus_zkvm_tpu_torch.air import tape_cuda
    from nexus_zkvm_tpu_torch.ops import blake2s, cfft, fri, merkle, quotients
    from nexus_zkvm_tpu_torch.prover import stark
    out = {}

    def keep(rec):
        if "ms" in rec:
            out[rec["name"]] = rec

    comps = sorted(calls["air_eval_composition"], key=lambda a: -a[4])
    for i, (tape, mats, uni, lo, L, hneg, alpha, shift, invv, bucket) in \
            enumerate(comps):
        def run(fn):
            b = bucket.clone()
            fn(tape, mats, uni, lo, L, hneg, alpha, shift, invv, b)
            return b
        rec = check("air_eval_composition",
                    [len(tape.program), tape.n_slots, L],
                    lambda: run(tp.air_eval_composition),
                    lambda: run(tp.air_eval_composition_plain),
                    *tape_cost(tape, L), timed_run and i == 0, reps=5,
                    plain_reps=1)
        keep(rec)
    # a call over a mesh rank's window carries (lo, L, hneg) after N
    ops = sorted(calls["air_eval_operands"],
                 key=lambda a: -(a[5] if len(a) > 4 else a[3]))
    for i, (tape, mats, uni, N, *win) in enumerate(ops):
        L = win[1] if win else N
        keep(check("air_eval_operands", [len(tape.program), tape.n_slots, L],
                   lambda: tp.air_eval_operands(tape, mats, uni, N, *win),
                   lambda: tp.air_eval_operands_plain(tape, mats, uni, N,
                                                      *win),
                   *tape_cost(tape, L), timed_run and i == 0, reps=5,
                   plain_reps=1))
    # K6 on each call as it was made (a later mesh rank's with the carry
    # of the ranks before it), and with a nonzero carry: every call of a
    # mesh rank's, the largest of another path's
    logups = sorted(calls["logup_columns"], key=lambda a: -a[2])
    carry_rng = np.random.default_rng(2031)
    for i, (src, meta, M, *carry) in enumerate(logups):
        B = int(meta.shape[1])
        words = {0: 1, 1: M, 2: 4, 3: 4 * M}
        in_bytes = 4 * sum(words[m] for m in meta[..., 1].reshape(-1).tolist())
        keep(check("logup_columns", [B, M, 4],
                   lambda: cmp.logup_columns(src, meta, M, *carry),
                   lambda: cmp.logup_columns_plain(src, meta, M, *carry),
                   in_bytes + 16 * B * M,
                   M * logup_ops(meta, cmp.LOGUP_CHUNK), timed_run and i == 0,
                   reps=5, plain_reps=1))
        if path == "mesh_" or i == 0:
            nz = torch.from_numpy(carry_rng.integers(
                1, (1 << 31) - 1, 4, dtype=np.int64).astype(np.int32)) \
                .to(src.device)
            check("logup_columns", [B, M, 4, "carry"],
                  lambda: cmp.logup_columns(src, meta, M, nz),
                  lambda: cmp.logup_columns_plain(src, meta, M, nz),
                  0, 0, False)
    # K6 again: the largest component's operands with zero denominators
    # (each place of a chunk, across chunk boundaries, the last pair);
    # then all of the proof's launches in turn
    src, meta, M, *_carry = logups[0]
    zsrc = zero_denominators(src, meta, M, cmp.LOGUP_CHUNK)
    check("logup_columns", [int(meta.shape[1]), M, 4, "zero denominators"],
          lambda: cmp.logup_columns(zsrc, meta, M),
          lambda: cmp.logup_columns_plain(zsrc, meta, M), 0, 0, False)
    del zsrc
    if timed_run:
        emit({"phase": f"{path}logup_launches", "launches": len(logups),
              "all_launches_ms": cuda_ms(lambda: [
                  cmp.logup_columns(*a) for a in logups], 3)})
    # K8: the proof's one launch over every (role, size, offset) group,
    # then each group alone (timed: the largest)
    (groups,), = calls["oods_dot_groups"]
    shapes = [(int(b.shape[0]) if r is None else len(r),
               int(b.shape[1]).bit_length() - 1) for b, r, _f in groups]
    everything = check("oods_dot", [len(groups), sum(r for r, _n in shapes)],
                       lambda: stark.oods_dot_groups(groups),
                       lambda: stark.oods_dot_groups_plain(groups),
                       *oods_cost(shapes), timed_run, plain_reps=1)
    for i, g in enumerate(sorted(range(len(groups)),
                                 key=lambda g: -(shapes[g][0] << shapes[g][1]))):
        r, n = shapes[g]
        keep(check("oods_dot", [r, 1 << n],
                   lambda: stark.oods_dot_groups([groups[g]]),
                   lambda: stark.oods_dot_groups_plain([groups[g]]),
                   *oods_cost([shapes[g]]), timed_run and i == 0,
                   plain_reps=1))
    if timed_run:
        out["oods_dot_all"] = everything
        emit({"phase": f"{path}oods_groups", "groups": len(groups),
              "all_groups_ms": everything["ms"],
              "all_groups_bound_ms": everything["bound_ms"]})
    # K9: the proof's openings, one gather (on a mesh rank its pieces at
    # their places); its host tables (the plan packed and copied to the
    # card) are built and timed apart from the launch: the first build
    # (`gather_tables_host_ms`), then the median of 21
    # (`gather_tables_median_ms`)
    (args,) = calls["gather_openings"]
    pieces, buf_words = args[0], (args[1] if len(args) > 1 else None)
    words = sum(p.words for p in pieces)
    tables_ms, tables = [None], (None, None, None)
    if pieces[0].src.is_cuda:
        tables_ms = [host_ms(lambda: merkle.gather_tables(pieces, buf_words))
                     for _ in range(21)]
        tables = merkle.gather_tables(pieces, buf_words)
    rec = check("gather_openings", [len(pieces), words],
                lambda: merkle.gather_openings(pieces, buf_words),
                lambda: merkle.gather_openings_plain(pieces, buf_words),
                8 * words + 8 * int(tables[0].numel()) if timed_run else 0,
                0, timed_run, plain_reps=3, queued=True,
                timed_fn=lambda: merkle.gather_launch(*tables))
    if timed_run:
        rec.update(units=tables[2], library_ms=None,
                   library_note="no single PyTorch call gathers a proof's "
                   "value and digest pieces into one buffer")
    keep(rec)
    largest = sorted(pieces, key=lambda p: -p.words)[:5]
    # K3: every size group's quotients (the proof's own evaluations and
    # coefficients), the largest again with its first sample's V forced
    # to 0 (dx = dy = 0); all of the proof's launches in turn
    qcalls = sorted(calls["accumulate_blocks"],
                    key=lambda a: -int(a[4].shape[1]) * int(a[1].shape[0]))
    for blocks, xs, ys, consts, gcs in qcalls:
        check("deep_quotients", [int(gcs.shape[0]), int(gcs.shape[1]),
                                 int(xs.shape[0])],
              lambda: quotients.accumulate_blocks(blocks, xs, ys, consts,
                                                  gcs),
              lambda: quotients.accumulate_blocks_plain(blocks, xs, ys,
                                                        consts, gcs),
              0, 0, False)
    blocks, xs, ys, consts, gcs = qcalls[0]
    zconsts = consts.clone()
    zconsts[0, 2:4] = 0
    check("deep_quotients", [int(gcs.shape[1]), int(xs.shape[0]), "zero V"],
          lambda: quotients.accumulate_blocks(blocks, xs, ys, zconsts, gcs),
          lambda: quotients.accumulate_blocks_plain(blocks, xs, ys, zconsts,
                                                    gcs), 0, 0, False)
    if timed_run:
        emit({"phase": f"{path}quotient_groups", "launches": len(qcalls),
              "shapes": [[int(a[4].shape[0]), int(a[4].shape[1]),
                          int(a[1].shape[0])] for a in qcalls],
              "all_groups_ms": cuda_ms(lambda: [
                  quotients.accumulate_blocks(*a) for a in qcalls], 3)})
    del qcalls, blocks, zconsts
    # K4: every fold of the FRI commit (the landing folds with their
    # injected input)
    for args in calls["fold"]:
        check("fri_fold", [int(args[0].shape[0]), 4, len(args)],
              lambda: fri.fold(*args), lambda: fri.fold_plain(*args),
              0, 0, False)
    # K1 and K2 on the calls kept of each shape; the plain transforms 64
    # columns at a time
    def by_cols(plain):
        return lambda x, *a: torch.cat([plain(x[i:i + 64], *a) for i in
                                        range(0, int(x.shape[0]), 64)])
    plains = {
        "interpolate": ("circle_ifft", cfft.interpolate,
                        by_cols(cfft.interpolate_plain)),
        "evaluate": ("circle_fft", cfft.evaluate, by_cols(
            lambda x, log=None: cfft.evaluate_plain(cfft.extend_coeffs(
                x, max(log or 0, int(x.shape[1]).bit_length() - 1))))),
        "hash_rows": ("blake2s_messages", blake2s.hash_rows,
                      blake2s.hash_rows_plain),
        "hash_parents": ("blake2s_parents", blake2s.hash_parents,
                         lambda x: blake2s.hash_rows_plain(x.reshape(-1, 16)))}
    for key in RECORDED_BY_SHAPE:
        name, kernel, plain = plains[key]
        for args in calls.get(key, ()):
            check(name, [list(args[0].shape), *args[1:2]],
                  lambda: kernel(*args), lambda: plain(*args), 0, 0, False)
    emit({"phase": f"{path}recorded",
          "calls": {k: len(v) for k, v in calls.items()},
          "compositions": len(comps),
          "operand_tapes": len(ops), "logup_launches": len(logups),
          "oods_groups": len(groups),
          "opening_pieces": len(pieces), "opening_words": words,
          "opening_units": tables[2],
          "gather_tables_host_ms": tables_ms[0],
          "gather_tables_median_ms": (None if tables_ms[0] is None else
                                      float(np.median(tables_ms))),
          "largest_pieces": [{"rows": p.rows, "positions": len(p.idx),
                              "W": p.width, "words": p.words}
                             for p in largest],
          "tapes": [{"component": c[0].name, "component_rows": c[4],
                     "instructions": len(c[0].program),
                     "slots": c[0].n_slots, "loads": len(c[0].loads),
                     "uniforms": len(c[2]),
                     "pieces": len(tape_cuda.pieces(c[0]))} for c in comps]})
    return out


def check_prover_kernels(comps, log_sizes, timed: bool = True) -> dict:
    """K1-K4 at the largest shapes a machine proof of these components
    gives them (timed when ``timed``): the interaction columns of its largest
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
               butterflies(C, n) * (2 * ADD + MUL) + C * N * MUL, timed))
    del x
    E = 1 << (n + 2)
    x = rand((C, E))
    keep(check("circle_fft", [C, E], lambda: cfft.evaluate(x),
               lambda: cfft.evaluate_plain(x), 2 * 4 * C * E + 4 * E,
               butterflies(C, n + 2) * (2 * ADD + MUL), timed))
    del x
    # K1 extending: the composition's LDE of every column of the largest
    # component (main, preprocessed, interaction) from 2^n to the 4x
    # domain, zero-extended in the kernel's first pass.  Bytes: the
    # compact input read once, the output written once, the twiddles
    # once; operations: the n stages whose odd halves are not zero.  The
    # plain version runs 64 columns at a time (its int64 stages of the
    # whole matrix would not fit beside it).
    big = infos[log_sizes.index(n)]
    Cc = big.n_main + big.n_pre + 4 * big.n_logup_cols
    x = rand((Cc, N))
    rec = check("circle_fft", [Cc, N, E], lambda: cfft.evaluate(x, n + 2),
                lambda: torch.cat([cfft.evaluate_plain(cfft.extend_coeffs(
                    x[i:i + 64], n + 2)) for i in range(0, Cc, 64)]),
                4 * Cc * (N + E) + 4 * E,
                Cc * n * (E // 2) * (2 * ADD + MUL), timed, reps=5,
                plain_reps=1)
    out["circle_fft_extend"] = rec
    del x
    # K2: the interaction commitment's leaves; the composition tree's
    # first parent layer
    R = 1 << (n + blowup)
    mat = rand((C, R))
    keep(check("blake2s_messages", [R, C], lambda: blake2s.hash_rows(mat.t()),
               lambda: blake2s.hash_rows_plain(mat.t()), 4 * C * R + 32 * R,
               R * -(-4 * C // 64) * COMPRESS, timed, reps=5))
    del mat
    s0 = plan.n_comp_trace_log + blowup
    leaves = rand((1 << s0, 8), 1 << 32)
    keep(check("blake2s_parents", [1 << s0, 8],
               lambda: blake2s.hash_parents(leaves),
               lambda: blake2s.hash_rows_plain(leaves.reshape(-1, 16)),
               48 * (1 << s0), (1 << (s0 - 1)) * COMPRESS, timed))
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
               *quotient_cost(rows, M, a["gcs"]), timed, reps=5))
    del blocks
    # K4: the first circle fold of the composition's domain
    v = rand((1 << s0, 4))
    tw = fri.dev_circle_fold_twiddles(s0, dev)
    alpha = felt()
    L = 1 << (s0 - 1)
    keep(check("fri_fold", [1 << s0, 4], lambda: fri.fold(v, alpha, tw),
               lambda: fri.fold_plain(v, alpha, tw), L * 52,
               L * (QM31_MUL + 4 * MUL + 12 * ADD), timed))
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
    # and the memory mode's (the slice stays resident)
    check_path("slice", launches, set(launches) - {"cpu_fill"}
               - set(MEMORY_MODE))
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


def check_path(path: str, launches: dict, expected) -> None:
    """Raise unless the kernels launched on ``path`` are ``expected``."""
    ran = {k for k, v in launches.items() if v}
    if ran != set(expected):
        raise RuntimeError(f"{path}: kernels not launched "
                           f"{sorted(set(expected) - ran)}, launched but not "
                           f"expected {sorted(ran - set(expected))}")


def rejects_tampering(verify, view, proof) -> None:
    """A tampered opening of the main trace and another program's claim
    must both fail ``verify(view, proof)``."""
    import copy
    from nexus_zkvm_tpu_torch.vm import asm, k_trace
    bad = copy.deepcopy(proof)
    dec = bad.stark.openings["main"][0][1]
    dec.column_values[0] = np.array(dec.column_values[0])
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % P31
    if verify(view, bad):
        raise RuntimeError("a tampered machine proof verifies")
    view2, _t = k_trace(asm.assemble(OTHER_SRC))
    if verify(view2, proof):
        raise RuntimeError("the proof verifies another program's claim")


def _route_trees(proof) -> list:
    """Every (role, eval size) tree of a machine proof."""
    return [(role, s) for role, roots in proof.stark.roots.items()
            for s, _r in roots]


def phase_machine() -> tuple:
    """The fib guest through LocalProver on the card at a 2^20-row CPU
    component; returns the launch counts of that run, the blake2s
    digest of the proof's bytes and the phase's record."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          decode_u32s, proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
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
    rejects_tampering(prover.verify, view, proof)
    # resident at 2^20: no streamed tree, one composition pass
    route = prof.notes
    if route["streamed"] or max(route["composition_passes"]) != 1:
        raise RuntimeError(f"the 2^20 proof left the resident route: {route}")
    check_path("machine", launches, set(launches) - set(MEMORY_MODE))
    if launches["oods_dot"] != 3:
        raise RuntimeError(f"K8 launched {launches['oods_dot']} times in "
                           f"3 proofs, not once a proof")
    digest = proof_digest(proof_to_bytes(proof))
    rec = {"phase": "machine", "guest": "examples/guests/fib.s", "n": FIB_N,
           "steps": steps, "cpu_log_rows": cpu_log, "proof_blake2s": digest,
           "log_sizes": proof.stark.log_sizes, "streamed": route["streamed"],
           "composition_passes": max(route["composition_passes"]),
           "verified": True,
           "tampered_rejected": True, "other_claim_rejected": True,
           "emulate_s": emulate_s, "prove_s": prove_s, "prove_cold_s": cold_s,
           "prove_profiled_s": profiled_s,
           "verify_s": verify_s, "rows_per_s": (1 << cpu_log) / prove_s,
           "steps_per_s": steps / prove_s, "peak_bytes": peak,
           "phase_s": prof.times, "launches": launches}
    emit(rec)
    return launches, digest, rec


def phase_machine_stream():
    """The fib guest through LocalProver at a 2^22-row CPU component in
    the large-trace memory mode, forced by STREAM_FORCED: both trees of
    2^23 leaves streamed, the CPU component composed in 4 passes.
    Returns (launch counts, components, log sizes, the proof's blake2s
    digest)."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          decode_u32s, proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    prover = LocalProver(fib_guest(), memory=MemoryConfig(**STREAM_FORCED))
    public = encode_u32s(FIB_STREAM_N)
    t0 = time.perf_counter()
    _v, trace = prover.trace(public_input=public)
    emulate_s = time.perf_counter() - t0
    steps = int(len(trace.steps["clk"]))
    del trace
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prover.prove_with_input(public_input=public)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold = kernels.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with profiled() as prof:
        t0 = time.perf_counter()
        view, proof = prover.prove_with_input(public_input=public)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    warm = {k: v - cold[k] for k, v in kernels.launch_counts().items()}
    t0 = time.perf_counter()
    ok = prover.verify(view, proof)
    verify_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if not ok:
        raise RuntimeError("the 2^22 machine proof does not verify")
    cpu_log = proof.stark.log_sizes[0]
    if cpu_log != STREAM_LOG:
        raise RuntimeError(f"CPU component at 2^{cpu_log}, not 2^{STREAM_LOG}")
    if decode_u32s(view.public_output, 1)[0] != fib_u32(FIB_STREAM_N):
        raise RuntimeError("wrong fib output")
    route = prof.notes
    s = STREAM_LOG + prover.config.fri.log_blowup
    passes = route["composition_passes"][0]
    if not {("main", s), ("inter", s)} <= set(route["streamed"]) or \
            passes != 4:
        raise RuntimeError(f"the 2^22 proof is not in the forced memory "
                           f"mode: {route}")
    # one K7 composition launch a pass of every component
    if warm["air_eval_composition"] != sum(route["composition_passes"]):
        raise RuntimeError("composition passes and K7 launches differ")
    if warm["oods_dot"] != 1:
        raise RuntimeError(f"K8 launched {warm['oods_dot']} times in a "
                           f"proof, not once")
    rejects_tampering(prover.verify, view, proof)
    check_path("machine_stream", launches, set(launches))
    digest = proof_digest(proof_to_bytes(proof))
    emit({"phase": "machine_stream", "guest": "examples/guests/fib.s",
          "n": FIB_STREAM_N, "steps": steps, "cpu_log_rows": cpu_log,
          "log_sizes": proof.stark.log_sizes, "memory": route["memory"],
          "streamed": route["streamed"], "composition_passes": passes,
          "proof_blake2s": digest,
          "verified": True, "tampered_rejected": True,
          "other_claim_rejected": True, "emulate_s": emulate_s,
          "prove_s": prove_s, "prove_cold_s": cold_s, "verify_s": verify_s,
          "rows_per_s": (1 << cpu_log) / prove_s,
          "steps_per_s": steps / prove_s, "peak_bytes": peak,
          "phase_s": prof.times, "launches_warm": warm,
          "launches": launches})
    return (launches, build_components(view, 1)[0], proof.stark.log_sizes,
            digest)


def phase_machine_large(stream_digest: str) -> None:
    """The 2^22 guest of phase 6 by the card's default route
    (``MemoryConfig.for_device``): a cold and a warm, profiled prove,
    verify, reject a tampered opening and another claim; the proof's
    bytes must equal phase 6's forced streamed proof, and the reserved
    peak of both proofs must stay within FIT_SHARE of the card's
    memory."""
    import dataclasses
    import torch
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    prover = LocalProver(fib_guest())          # default configs, card
    public = encode_u32s(FIB_STREAM_N)
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prover.prove_with_input(public_input=public)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    with profiled() as prof:
        t0 = time.perf_counter()
        view, proof = prover.prove_with_input(public_input=public)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    t0 = time.perf_counter()
    ok = prover.verify(view, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("the default-route 2^22 proof does not verify")
    rejects_tampering(prover.verify, view, proof)
    route = prof.notes
    if route["memory"] != dataclasses.asdict(MemoryConfig.for_device(
            "cuda")):
        raise RuntimeError(f"the prover took {route['memory']}, not the "
                           f"card's default")
    digest = proof_digest(proof_to_bytes(proof))
    if digest != stream_digest:
        raise RuntimeError("the default-route and forced streamed 2^22 "
                           "proofs differ")
    if reserved > FIT_SHARE * total:
        raise RuntimeError(f"the default route reserved {reserved} bytes, "
                           f"over {FIT_SHARE} of the card's {total}")
    emit({"phase": "machine_large", "n": FIB_STREAM_N,
          "cpu_log_rows": proof.stark.log_sizes[0], "memory": route["memory"],
          "streamed": route["streamed"],
          "composition_passes": max(route["composition_passes"]),
          "proof_blake2s": digest, "equal_to_machine_stream": True,
          "verified": True, "tampered_rejected": True,
          "other_claim_rejected": True, "prove_s": prove_s,
          "prove_cold_s": cold_s, "verify_s": verify_s,
          "rows_per_s": (1 << STREAM_LOG) / prove_s, "peak_bytes": peak,
          "peak_reserved_bytes": reserved, "total_memory": total,
          "reserved_share": reserved / total, "phase_s": prof.times})
    # the next phases' processes share the card
    del view, proof, prover
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6c: segmented machine proofs
# ---------------------------------------------------------------------------

def segmented_config():
    """The PcsConfig of SEGMENTED_CONFIG (the CPU tests')."""
    import nexus_zkvm_tpu_torch as T
    c = SEGMENTED_CONFIG
    return T.PcsConfig(pow_bits=c["pow_bits"], fri=T.FriConfig(
        log_blowup=c["log_blowup"], log_last_layer=c["log_last_layer"],
        n_queries=c["n_queries"]))


def segmented_parity_proofs(device) -> dict:
    """The small segmented proofs at SEGMENTED_LOG on ``device``, each
    verified there: ``pinned``, SEGMENTED_SRC under SEGMENTED_CONFIG (the
    JAX package's digest SEGMENTED_PROOF_BLAKE2S), and ``fib``, the fib
    guest at FIB_PARITY_N under the default PcsConfig.  {name: {"bytes",
    "prove_s", "log_sizes"}}."""
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.machine import prove_machine, verify_machine
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from nexus_zkvm_tpu_torch.vm import asm, k_trace
    out = {}
    for name, (view, trace), config in (
            ("pinned", k_trace(asm.assemble(SEGMENTED_SRC),
                               backend="python"), segmented_config()),
            ("fib", LocalProver(fib_guest(), device=device).trace(
                public_input=encode_u32s(FIB_PARITY_N)), T.PcsConfig())):
        t0 = time.perf_counter()
        proof = prove_machine(view, trace, config,
                              segment_log=SEGMENTED_LOG, device=device)
        secs = time.perf_counter() - t0
        if not verify_machine(view, proof, config, device=device):
            raise RuntimeError(f"the segmented {name} proof does not verify "
                               f"on {device}")
        out[name] = {"bytes": proof_to_bytes(proof), "prove_s": secs,
                     "log_sizes": proof.stark.log_sizes}
    return out


def segments_cpu(out_dir: str) -> None:
    """`segmented_parity_proofs` on the CPU, each proof's bytes written to
    ``out_dir``/NAME.bin (phase machine_segments runs this in a process
    of its own while the card proves)."""
    import torch
    torch.set_num_threads(4)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    got = segmented_parity_proofs("cpu")
    for name, rec in got.items():
        (out / f"{name}.bin").write_bytes(rec["bytes"])
    emit({name: {"prove_s": rec["prove_s"], "log_sizes": rec["log_sizes"]}
          for name, rec in got.items()})


def fill_numpy(trace, view, log: int, static_lo, static_hi) -> tuple:
    """The numpy host fill of a trace segment (`cpu.fill_cpu`, its table
    counts by `tables.count_multiplicity`), as K5 gives it: ((193, 2^log)
    uint32 matrix, (N_HIST,) uint32 histograms)."""
    from nexus_zkvm_tpu_torch.machine import cpu, fill_dev
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.machine.tables import (_Table,
                                                     count_multiplicity)
    fill, emits = cpu.fill_cpu(trace, view, log, static_lo, static_hi)
    comps, fixed, _w = build_components(view, 1)
    tables = {c.relation: c for c in comps if isinstance(c, _Table)}
    hist = [count_multiplicity(tables[rel], emits.get(
        rel, np.zeros(0, np.int64)), fixed[tables[rel].name])[:size]
        for rel, size in fill_dev.RELATION_SIZES.items()]
    return (np.stack(cpu.CPU_SCHEMA.to_columns(fill)).astype(np.uint32),
            np.concatenate(hist).astype(np.uint32))


_FILL = "nexus_zkvm_tpu_torch.machine.fill_dev"
_TAPE = "nexus_zkvm_tpu_torch.air.tape"
_STARK = "nexus_zkvm_tpu_torch.prover.stark"
_QUOT = "nexus_zkvm_tpu_torch.ops.quotients"
_MERKLE = "nexus_zkvm_tpu_torch.ops.merkle"
# the wrappers whose calls a segmented proof holds to their plain
# versions as it makes them (`check_inline`): wrapper -> (the kernel it
# launches, (module, function), (module, plain function) with None for
# this script, the argument the call updates in place)
INLINE = {
    "cpu_fill": ("cpu_fill", (_FILL, "cpu_fill"), (_FILL, "cpu_fill_plain"),
                 None),
    "air_eval_operands": ("air_eval_operands", (_TAPE, "air_eval_operands"),
                          (_TAPE, "air_eval_operands_plain"), None),
    "air_eval_composition": ("air_eval_composition",
                             (_TAPE, "air_eval_composition"),
                             (_TAPE, "air_eval_composition_plain"), 9),
    "oods_dot": ("oods_dot", (_STARK, "oods_dot_groups"),
                 (None, "_oods_plain_rows"), None),
    "deep_quotients": ("deep_quotients", (_QUOT, "accumulate_blocks"),
                       (_QUOT, "accumulate_blocks_plain"), None),
    "quotient_colsums": ("quotient_colsums", (_QUOT, "colsum_fold"),
                         (_QUOT, "colsum_fold_plain"), 0),
}
# the wrappers machine2_large's two routes hold to their plain versions
# as they call them: INLINE's but K5 (machine2 fills on the host), and
# K1, K2 (merkle's names, which its trees call), K4, K6, K9 (both
# entries), K10 (its leaf states updated in place, made on a tree's
# first chunk) and K12
INLINE_M2 = {
    **{k: v for k, v in INLINE.items() if k != "cpu_fill"},
    "interpolate": ("circle_ifft", ("nexus_zkvm_tpu_torch.ops.cfft",
                                    "interpolate"),
                    (None, "_interpolate_plain"), None),
    "evaluate": ("circle_fft", ("nexus_zkvm_tpu_torch.ops.cfft", "evaluate"),
                 (None, "_evaluate_plain"), None),
    "hash_rows": ("blake2s_messages", (_MERKLE, "hash_rows"),
                  (None, "_hash_rows_plain"), None),
    "hash_parents": ("blake2s_parents", (_MERKLE, "hash_parents"),
                     (None, "_hash_parents_plain"), None),
    "fold": ("fri_fold", ("nexus_zkvm_tpu_torch.ops.fri", "fold"),
             ("nexus_zkvm_tpu_torch.ops.fri", "fold_plain"), None),
    "logup_columns": ("logup_columns", (_TAPE, "logup_columns"),
                      ("nexus_zkvm_tpu_torch.air.component",
                       "logup_columns_plain"), None),
    "gather_openings": ("gather_openings", (_MERKLE, "gather_openings"),
                        (_MERKLE, "gather_openings_plain"), None),
    "gather_columns": ("gather_openings", (_MERKLE, "gather_columns"),
                       (None, "_gather_columns_plain"), None),
    "blake2s_leaves_stream": ("blake2s_leaves_stream",
                              ("nexus_zkvm_tpu_torch.ops.blake2s",
                               "leaves_stream"),
                              ("nexus_zkvm_tpu_torch.ops.blake2s",
                               "leaves_stream_plain"), 0),
    "quotient_finalize": ("quotient_finalize", (_QUOT, "colsum_finalize"),
                          (_QUOT, "colsum_finalize_plain"), None),
}


def _inline_shape(name: str, args, kw) -> tuple:
    """What makes two calls of wrapper ``name`` the same shape: a tape's
    program and rows (the CPU component's segments share theirs), the
    blocks', sums', batches' and layers' shapes; None (K5): every
    call."""
    if name in ("air_eval_composition", "air_eval_operands"):
        tape = args[0]
        rows = args[4] if name == "air_eval_composition" else (
            args[5] if len(args) > 5 else args[3])
        return (tape.name, tape.kind, len(tape.program), int(rows))
    if name == "deep_quotients":
        return tuple(tuple(b.shape) for b in args[0]) + (
            tuple(args[4].shape),)
    if name == "quotient_colsums":
        return (tuple(args[0].shape), tuple(args[1].shape), bool(args[3]))
    if name == "logup_columns":
        return (int(args[1].shape[1]), int(args[2]))
    if name == "blake2s_leaves_stream":
        return (tuple(args[1].shape), args[0] is None, bool(args[4]))
    if name == "oods_dot":
        return tuple((tuple(b.shape), None if r is None else len(r))
                     for b, r, _f in args[0])
    if name == "interpolate":
        return (tuple(args[0].shape), "out" in kw)
    if name == "evaluate":
        return (tuple(args[0].shape), args[1] if len(args) > 1 else
                kw.get("log_size"))
    if name == "hash_rows":
        return (tuple(args[0].shape), args[0].stride())
    if name == "fold":
        return (tuple(args[0].shape), len(args) > 3 and args[3] is not None)
    if name == "gather_openings":
        return (len(args[0]), args[1] if len(args) > 1 else
                kw.get("words"))
    if name == "gather_columns":
        return (tuple(args[0].shape), len(args[1]))
    if name in ("hash_parents", "quotient_finalize"):
        return (tuple(args[0].shape),)
    return None


def _by_rows(plain, x, rows: int):
    """``plain`` on ``rows`` rows of the (R, ...) ``x`` at a time, so
    that its int64 work stays small beside the proof's tensors."""
    import torch
    return torch.cat([plain(x[i:i + rows]) for i in range(0, len(x), rows)])


def _interpolate_plain(evals, out=None):
    """K1's inverse transform's plain version (`cfft.interpolate_plain`)
    of the call's input, 16 columns at a time."""
    from nexus_zkvm_tpu_torch.ops import cfft
    return _by_rows(cfft.interpolate_plain, evals, 16)


def _evaluate_plain(coeffs, log_size=None):
    """K1's forward transform's plain version: the coefficients
    zero-extended to 2^log_size, then `cfft.evaluate_plain`, 16 columns
    at a time."""
    from nexus_zkvm_tpu_torch.ops import cfft
    n = max(coeffs.shape[-1].bit_length() - 1, log_size or 0)
    return _by_rows(lambda x: cfft.evaluate_plain(cfft.extend_coeffs(x, n)),
                    coeffs, 16)


def _hash_rows_plain(msgs):
    """K2's `hash_rows_plain` of the call's rows, 2^20 rows at a time;
    fewer than 2^16 rows (the wide rows of keccak's columns: hundreds of
    blocks, each many operations on a few rows) on a host copy, where a
    small operation costs a few microseconds instead of a launch."""
    from nexus_zkvm_tpu_torch.ops import blake2s
    if msgs.shape[0] < 1 << 16:
        return blake2s.hash_rows_plain(msgs.cpu()).to(msgs.device)
    return _by_rows(blake2s.hash_rows_plain, msgs, 1 << 20)


def _hash_parents_plain(layer):
    """K2's parent layer by `hash_rows_plain` on the children's digest
    pairs, 2^20 parents at a time."""
    from nexus_zkvm_tpu_torch.ops import blake2s
    return _by_rows(blake2s.hash_rows_plain, layer.reshape(-1, 16), 1 << 20)


def _gather_columns_plain(src, idx):
    """K9's single-piece entry by plain indexing: src[:, idx]."""
    import torch
    ix = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(
        np.asarray(idx, np.int64))
    return src[:, ix.to(src.device)]


def _oods_plain_rows(groups, words: int = 1 << 24):
    """K8's plain version (`stark.oods_dot_groups_plain`) a few rows of a
    group at a time (at least 32, at most ``words`` coefficients), so
    that its int64 products stay small beside the proof's
    coefficients."""
    import torch
    from nexus_zkvm_tpu_torch.prover import stark
    out = []
    for batch, rows, factors in groups:
        rows = range(int(batch.shape[0])) if rows is None else list(rows)
        rows_at_once = max(32, words // int(batch.shape[1]))
        for i in range(0, len(rows), rows_at_once):
            out.append(stark.oods_dot_plain(
                batch[list(rows[i:i + rows_at_once])], factors))
    return torch.cat(out).to(torch.int32)


def check_inline(prove_fn, inline=None, seen=None) -> tuple:
    """Run ``prove_fn()`` with the wrappers of ``inline`` (None: INLINE)
    wrapped: every K5 call, and the first call of each shape
    (`_inline_shape`) of every other wrapper, runs the kernel (the call
    itself, which the proof goes on with) and then the plain version on
    the same inputs (on a copy of the argument it updates), and raises
    unless they are uint32-equal and the kernel launched.  ``seen`` (a
    set, updated): the (wrapper, shape) pairs an earlier proof checked,
    not checked again.  Returns (what ``prove_fn`` returned, [{wrapper,
    kernel, shape, plain_s}])."""
    import importlib
    import torch
    from nexus_zkvm_tpu_torch import kernels
    checked, saved = [], []
    seen = set() if seen is None else seen
    for key, (kernel, (mod, fn), (plain_mod, plain_fn), inplace) in (
            inline or INLINE).items():
        m = importlib.import_module(mod)
        orig = getattr(m, fn)
        plain = (globals()[plain_fn] if plain_mod is None else
                 getattr(importlib.import_module(plain_mod), plain_fn))

        def wrapped(*args, _orig=orig, _plain=plain, _key=key,
                    _kernel=kernel, _inplace=inplace, **kw):
            shape = _inline_shape(_key, args, kw)
            if shape is not None and (_key, shape) in seen:
                return _orig(*args, **kw)
            seen.add((_key, shape))
            before = kernels.launch_counts()[_kernel]
            # (an argument updated in place may be None: the call makes it)
            kept = None if _inplace is None or args[_inplace] is None \
                else args[_inplace].clone()
            got = _orig(*args, **kw)
            torch.cuda.synchronize()
            if kernels.launch_counts()[_kernel] == before:
                raise RuntimeError(f"{_key}: the wrapper did not launch its "
                                   f"kernel")
            t0 = time.perf_counter()
            if kept is None:
                want = _plain(*args, **kw)
            else:
                plain_args = list(args)
                plain_args[_inplace] = kept
                ret = _plain(*plain_args, **kw)
                got = args[_inplace] if got is None else got
                want = kept if ret is None else ret
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            if not all(g.shape == w.shape and torch.equal(g, w)
                       for g, w in zip(got_t, want_t)):
                raise RuntimeError(f"{_key} {shape}: kernel and plain "
                                   f"version differ in the checked proof")
            checked.append({"wrapper": _key, "kernel": _kernel, "shape": (
                list(shape) if shape else [list(g.shape) for g in got_t]),
                "plain_s": plain_s})
            del kept, want, want_t
            return got
        saved.append((m, fn, orig))
        setattr(m, fn, wrapped)
    try:
        out = prove_fn()
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
    return out, checked


def phase_machine_segments() -> dict:
    """Segmented machine proofs (``machine.prove_machine(...,
    segment_log=k)``) on the card.  (a) SEGMENTED_SRC at SEGMENTED_LOG
    under SEGMENTED_CONFIG: the proof's blake2s equals the JAX package's
    SEGMENTED_PROOF_BLAKE2S and its bytes the port's CPU proof; (b) the
    fib guest at FIB_PARITY_N at SEGMENTED_LOG (four CPU components),
    default PcsConfig: CPU and card byte-equal (the CPU proofs run in a
    process of their own, `segments_cpu`, while the card proves).
    (c) fib at FIB_SEGMENTS_N (16,777,200 steps) in 2^SEGMENT_LOG-step
    segments, SEGMENTS CPU components of 2^22 rows, by the card's
    default route: emulated once, then a cold proof and a warm, profiled
    one (each phase's allocated and reserved peaks), verify, a tampered
    opening and another claim rejected, the reserved peak of both
    proofs within FIT_SHARE of the card; every kernel K1-K12 launched;
    then one more proof whose calls are held to their plain versions
    as it makes them (`check_inline`: every segment's K5, one call of
    each shape of K3, K7, K8 and K11), and the first FILL_NUMPY_STEPS
    steps of every segment through K5 against the numpy host fill.
    Returns the launch counts of (c)'s cold and warm proofs."""
    import dataclasses
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine import prove_machine, verify_machine
    from nexus_zkvm_tpu_torch.machine import driver, fill_dev
    from nexus_zkvm_tpu_torch.machine.driver import build_components, _clog2
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          decode_u32s, proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.device import to_u32
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    out_dir = ROOT / "build" / "segments_cpu"
    cpu_run = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--segments-cpu",
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT)
    try:
        card = segmented_parity_proofs("cuda")
        if proof_digest(card["pinned"]["bytes"]) != SEGMENTED_PROOF_BLAKE2S:
            raise RuntimeError("the card's segmented proof differs from the "
                               "JAX package's recorded digest")

        # (c) the full-width execution
        prover = LocalProver(fib_guest())            # default configs, card
        public = encode_u32s(FIB_SEGMENTS_N)
        total = torch.cuda.get_device_properties(0).total_memory
        t0 = time.perf_counter()
        view, trace = prover.trace(public_input=public)
        emulate_s = time.perf_counter() - t0
        steps = trace.n_steps
        # the components besides the CPU's (the same for every fib input)
        n_fixed = len(build_components(view, 1)[0]) - 1
        if len(card["fib"]["log_sizes"]) - n_fixed < 3:
            raise RuntimeError("the fib parity proof has fewer than 3 "
                               "segments")

        def prove():
            return prove_machine(view, trace, prover.config,
                                 segment_log=SEGMENT_LOG)
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        cold = kernels.launch_counts()
        peaks = {"cold": [torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_reserved()]}
        torch.cuda.reset_peak_memory_stats()
        # each segment's fill (`f:cpu`: its step rows to the card, K5),
        # timed call by call
        f_cpu, fill = [], driver.fill_cpu_dev

        def timed_fill(*args, **kw):
            t = time.perf_counter()
            got = fill(*args, **kw)
            torch.cuda.synchronize()
            f_cpu.append(time.perf_counter() - t)
            return got
        driver.fill_cpu_dev = timed_fill
        try:
            with profiled(memory=True) as prof:
                t0 = time.perf_counter()
                proof = prove()
                torch.cuda.synchronize()
                prove_s = time.perf_counter() - t0
        finally:
            driver.fill_cpu_dev = fill
        peaks["warm"] = [max([torch.cuda.max_memory_allocated(),
                              *prof.peaks.values()]),
                         max([torch.cuda.max_memory_reserved(),
                              *prof.reserved.values()])]
        launches = kernels.launch_counts()
        warm = {k: v - cold[k] for k, v in launches.items()}
        t0 = time.perf_counter()
        ok = verify_machine(view, proof, prover.config)
        verify_s = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("the segmented 2^24-step proof does not "
                               "verify")
        rejects_tampering(prover.verify, view, proof)
        if decode_u32s(view.public_output, 1)[0] != fib_u32(FIB_SEGMENTS_N):
            raise RuntimeError("wrong fib output")
        logs = proof.stark.log_sizes
        segs = len(logs) - n_fixed
        if segs != SEGMENTS or logs[:segs] != [SEGMENT_LOG] * segs:
            raise RuntimeError(f"{segs} CPU components of 2^{logs[:segs]}, "
                               f"not {SEGMENTS} of 2^{SEGMENT_LOG}")
        route = prof.notes
        if route["memory"] != dataclasses.asdict(MemoryConfig.for_device(
                "cuda")):
            raise RuntimeError(f"the prover took {route['memory']}, not the "
                               f"card's default")
        if warm["air_eval_composition"] != sum(route["composition_passes"]):
            raise RuntimeError("composition passes and K7 launches differ")
        if warm["cpu_fill"] != SEGMENTS or warm["oods_dot"] != 1:
            raise RuntimeError(f"K5 launched {warm['cpu_fill']} times and K8 "
                               f"{warm['oods_dot']} in the warm proof")
        check_path("machine_segments", warm, set(warm))
        reserved = max(p[1] for p in peaks.values())
        if reserved > FIT_SHARE * total:
            raise RuntimeError(f"the segmented proofs reserved {reserved} "
                               f"bytes, over {FIT_SHARE} of the card's "
                               f"{total}")
        digest = proof_digest(proof_to_bytes(proof))
        del proof

        # one more proof, its calls held to their plain versions
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proof, checked = check_inline(prove)
        checked_s = time.perf_counter() - t0
        if proof_digest(proof_to_bytes(proof)) != digest:
            raise RuntimeError("the checked segmented proof differs")
        del proof
        fills = [c for c in checked if c["kernel"] == "cpu_fill"]
        if len(fills) != SEGMENTS or {c["wrapper"] for c in checked} != \
                set(INLINE):
            raise RuntimeError(f"calls checked: {checked}")
        torch.cuda.empty_cache()
        # K5 on the first steps of every segment against the numpy fill
        st_lo, st_hi = build_components(view, 1)[2]
        numpy_fill = []
        for i, seg in enumerate(trace.split_by(1 << SEGMENT_LOG)):
            head = seg.split_by(FILL_NUMPY_STEPS)[0]
            log = _clog2(head.n_steps, lo=4)
            mat, hist = fill_dev.fill_cpu_dev(head, view, log, st_lo, st_hi)
            want = fill_numpy(head, view, log, st_lo, st_hi)
            if not (np.array_equal(to_u32(mat), want[0])
                    and np.array_equal(to_u32(hist), want[1])):
                raise RuntimeError(f"K5 differs from the numpy fill on "
                                   f"segment {i}")
            numpy_fill.append({"segment": i, "clk0": int(seg.steps["clk"][0]),
                               "steps": head.n_steps})

        # (a) and (b) on the CPU
        stdout, stderr = cpu_run.communicate(timeout=600)
        if cpu_run.returncode:
            raise RuntimeError(f"the CPU segmented proofs failed:\n"
                               f"{stderr[-3000:]}")
        cpu_rec = json.loads([ln for ln in stdout.splitlines()
                              if ln.startswith("{")][-1])
        for name in ("pinned", "fib"):
            if (out_dir / f"{name}.bin").read_bytes() != card[name]["bytes"]:
                raise RuntimeError(f"the CPU and card segmented {name} "
                                   f"proofs differ")
    finally:
        if cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    rows = SEGMENTS << SEGMENT_LOG
    emit({"phase": "machine_segments",
          "pinned": {"src": "SEGMENTED_SRC", "segment_log": SEGMENTED_LOG,
                     "config": SEGMENTED_CONFIG,
                     "proof_blake2s": SEGMENTED_PROOF_BLAKE2S,
                     "equal_to_jax_digest": True, "equal_to_cpu": True,
                     "log_sizes": card["pinned"]["log_sizes"],
                     "cuda_prove_s": card["pinned"]["prove_s"],
                     "cpu_prove_s": cpu_rec["pinned"]["prove_s"]},
          "fib_parity": {"n": FIB_PARITY_N, "segment_log": SEGMENTED_LOG,
                         "segments": len(card["fib"]["log_sizes"]) - n_fixed,
                         "equal_to_cpu": True,
                         "proof_blake2s": proof_digest(card["fib"]["bytes"]),
                         "log_sizes": card["fib"]["log_sizes"],
                         "cuda_prove_s": card["fib"]["prove_s"],
                         "cpu_prove_s": cpu_rec["fib"]["prove_s"]},
          "n": FIB_SEGMENTS_N, "steps": steps, "segment_log": SEGMENT_LOG,
          "segments": segs, "log_sizes": logs, "proof_blake2s": digest,
          "verified": True, "tampered_rejected": True,
          "other_claim_rejected": True, "emulate_s": emulate_s,
          "prove_cold_s": cold_s, "prove_s": prove_s, "verify_s": verify_s,
          "f_cpu_s": f_cpu,
          "steps_per_s": steps / (emulate_s + prove_s),
          "rows_per_s": rows / (emulate_s + prove_s),
          "peak_bytes": {k: v[0] for k, v in peaks.items()},
          "peak_reserved_bytes": {k: v[1] for k, v in peaks.items()},
          "reserved_share": reserved / total, "total_memory": total,
          "phase_peak_bytes": prof.peaks,
          "phase_reserved_bytes": prof.reserved,
          "memory": route["memory"], "streamed": route["streamed"],
          "composition_passes": route["composition_passes"],
          "cache_released": route["cache_released"],
          "phase_s": prof.times, "launches_warm": warm,
          "launches_cold": cold, "checked_proof_s": checked_s,
          "checked": checked, "numpy_fill": numpy_fill})
    return launches


def phase_stream_parity():
    """The fib 2^20 proof by the default route and by a MemoryConfig that
    streams every tree of 2^21 rows or more in 16-column chunks and
    composes in 4 passes: byte-equal proofs, a lower peak."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    forced = MemoryConfig(stream_commit_bytes=(4 << 21) - 1,
                          stream_chunk_bytes=1 << 27,
                          comp_nat_budget=2 << 30)
    out = {}
    for name, memory in (("default", None), ("streamed", forced)):
        prover = LocalProver(fib_guest(), memory=memory)
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with profiled() as prof:
            t0 = time.perf_counter()
            view, proof = prover.prove_with_input(
                public_input=encode_u32s(FIB_N))
            torch.cuda.synchronize()
        out[name] = {"prove_s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "bytes": proof_to_bytes(proof), "route": prof.notes,
                     "launches": kernels.launch_counts()}
    if not prover.verify(view, proof):
        raise RuntimeError("the streamed 2^20 proof does not verify")
    d, f = out["default"], out["streamed"]
    # every tree of 2^21 rows or more, in 16-column chunks
    want = {(r, s_) for r, s_ in _route_trees(proof) if s_ >= 21}
    if d["route"]["streamed"] or \
            not want <= set(f["route"]["streamed"]) or \
            f["route"]["composition_passes"][0] < 4 or \
            any(forced.chunk_cols(s_) != 16 for _r, s_ in want):
        raise RuntimeError(f"unexpected routes: {d['route']} {f['route']}")
    check_path("stream_parity/default", d["launches"],
               set(d["launches"]) - set(MEMORY_MODE))
    check_path("stream_parity/streamed", f["launches"], set(f["launches"]))
    if d["bytes"] != f["bytes"]:
        raise RuntimeError("the streamed and resident 2^20 proofs differ")
    if f["peak_bytes"] >= d["peak_bytes"]:
        raise RuntimeError("streaming did not lower the peak")
    emit({"phase": "stream_parity", "n": FIB_N, "equal_bytes": True,
          "proof_bytes": len(f["bytes"]), "streamed": f["route"]["streamed"],
          "composition_passes": f["route"]["composition_passes"][0],
          "peak_bytes_default": d["peak_bytes"],
          "peak_bytes_streamed": f["peak_bytes"],
          "prove_s_default": d["prove_s"], "prove_s_streamed": f["prove_s"]})


def stream_k11_inputs(comps, log_sizes, rng) -> dict:
    """K11's coefficients at the 2^22 proof's shapes: the CPU component's
    size group (2^s points) with samples drawn from random OODS values
    (so its zero pattern is the proof's), and the group's first main
    column.  {"s", "K", "k0", "prep": prep_args_full's dict}."""
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.ops import circle, quotients
    from nexus_zkvm_tpu_torch.prover.stark import _build_samples, build_plan

    def felt():
        return rng.integers(0, P31, 4).astype(np.uint64)
    cfg = T.PcsConfig()
    plan = build_plan(log_sizes, [component_info(c) for c in comps], cfg)
    s = log_sizes[0] + cfg.fri.log_blowup
    K = len(plan.groups[s])
    sampled = [np.stack([felt() for _ in m.offsets]) for m in plan.metas]
    samples = _build_samples(plan, circle.oods_point_from_felt(felt()),
                             sampled)[s]
    return {"s": s, "K": K,
            "k0": [plan.metas[i].role for i in plan.groups[s]].index("main"),
            "prep": quotients.prep_args_full(samples, felt(), 0, K)}


def check_stream_kernels(comps, log_sizes) -> dict:
    """The memory mode's kernels against their plain versions at the
    shapes the 2^22 proof gives them, timed: K10 on a middle chunk of
    the main tree (16 columns of 2^23 leaves), then on the main and
    interaction trees' last, ragged chunks; K11 on a 16-column LDE chunk
    with that size group's samples, on the ragged chunks and on a
    committed-order block; K12 on its column sums; K7 on one pass of the
    CPU component (its record is printed; the kernels line times K7 on
    the 2^20 path).  K10 and K11 are timed launching in place on one
    buffer.  Inputs are random; returns {kernel name: timed record}."""
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air import tape as tp
    from nexus_zkvm_tpu_torch.air.component import (component_info,
                                                    domain_halo)
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.ops import blake2s, circle, quotients
    from nexus_zkvm_tpu_torch.prover.stark import (_natural_rows,
                                                   _relation_widths)
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(2028)
    P = (1 << 31) - 1
    memory = T.MemoryConfig(**STREAM_FORCED)
    out = {}

    def rand(shape, hi=P):
        return from_u32(rng.integers(0, hi, shape, dtype=np.uint32), dev)

    def felt():
        return rng.integers(0, P, 4).astype(np.uint64)

    def keep(rec):
        out[rec["name"]] = rec

    infos = [component_info(c) for c in comps]
    n = log_sizes[0]
    k11 = stream_k11_inputs(comps, log_sizes, rng)
    s = k11["s"]
    M = 1 << s
    c = memory.chunk_cols(s)
    C = infos[0].n_main
    # K10: a middle chunk (timed), then the main and interaction trees'
    # last, ragged chunks
    chunk, state = rand((c, M)), rand((M, 8), 1 << 32)
    buf = state.clone()
    keep(check("blake2s_leaves_stream", [c, M],
               lambda: blake2s.leaves_stream(state.clone(), chunk, c, C,
                                             False),
               lambda: blake2s.leaves_stream_plain(state, chunk, c, C, False),
               4 * c * M + 64 * M, M * (c // 16) * COMPRESS, True, reps=10,
               plain_reps=1,
               timed_fn=lambda: blake2s.leaves_stream(buf, chunk, c, C,
                                                      False)))
    del buf
    for width in (C, 4 * infos[0].n_logup_cols):
        tail = width % c or c
        last = rand((tail, M))
        check("blake2s_leaves_stream", [tail, M],
              lambda: blake2s.leaves_stream(state.clone(), last, width - tail,
                                            width, True),
              lambda: blake2s.leaves_stream_plain(state, last, width - tail,
                                                  width, True),
              0, 0, False)
    del chunk, state, last
    # K11, K12: the CPU component's size group, its first main chunk
    a, k0 = k11["prep"], k11["k0"]
    S = len(a["gcs"])
    gcs = from_u32(np.ascontiguousarray(a["gcs"][:, k0:k0 + c]), dev)
    nnz = int((a["gcs"][:, k0:k0 + c] != 0).any(axis=2).sum())
    acc, chunk = rand((S, M, 4)), rand((c, M))
    buf = acc.clone()
    keep(check("quotient_colsums", [S, c, M],
               lambda: quotients.colsum_fold(acc.clone(), chunk, gcs, True),
               lambda: quotients.colsum_fold_plain(acc.clone(), chunk, gcs,
                                                   True),
               4 * c * M + 32 * S * M,
               M * (nnz * 4 * (MUL + 2) + S * 4 * 2 * ADD), True, reps=10,
               plain_reps=1,
               timed_fn=lambda: quotients.colsum_fold(buf, chunk, gcs, True)))
    del buf
    # the ragged last chunks (layout order), a committed-order block
    for width, brev in ((C % c, True), (4 * infos[0].n_logup_cols % c, True),
                        (c, False)):
        g = from_u32(np.ascontiguousarray(a["gcs"][:, k0:k0 + width]), dev)
        check("quotient_colsums", [S, width, M, int(brev)],
              lambda: quotients.colsum_fold(acc.clone(), chunk[:width], g,
                                            brev),
              lambda: quotients.colsum_fold_plain(acc.clone(), chunk[:width],
                                                  g, brev),
              0, 0, False)
    xs, ys = circle.dev_committed_points(s, dev)
    consts = from_u32(a["consts"], dev)
    keep(check("quotient_finalize", [S, M],
               lambda: quotients.colsum_finalize(acc, xs, ys, consts),
               lambda: quotients.colsum_finalize_plain(acc, xs, ys, consts),
               16 * S * M + 8 * M + 16 * M,
               M * quotient_epilogue_ops(
                   S, quotients.QUOTIENT_PLAN["finalize_points"]), True,
               reps=5, plain_reps=1))
    del acc, chunk
    # K7: the second pass of the CPU component
    ev = n + 2
    N = 1 << ev
    L = N // memory.comp_passes(_natural_rows(infos[0]), ev)
    hneg, hpos = domain_halo(infos[0])
    rel = draw_relations(T.Blake2sChannel(), _relation_widths(infos))
    tape = tp.domain_tape(comps[0], n, rel)
    W = L + hneg + hpos
    mats = {tp.MAIN: rand((infos[0].n_main, W)),
            tp.PRE: rand((infos[0].n_pre, W)) if infos[0].n_pre else None,
            tp.INTER: rand((4 * infos[0].n_logup_cols, W)),
            tp.ISF: rand((1, W))}
    uni = tape.uniforms(rel, felt())
    alpha, shift = felt(), felt()
    invv, bucket = rand((N,)), rand((N, 4))

    def run(fn):
        b = bucket.clone()
        fn(tape, mats, uni, L, L, hneg, alpha, shift, invv, b)
        return b
    check("air_eval_composition", [len(tape.program), tape.n_slots, L],
          lambda: run(tp.air_eval_composition),
          lambda: run(tp.air_eval_composition_plain),
          *tape_cost(tape, L), True, reps=5, plain_reps=1)
    del mats, invv, bucket
    torch.cuda.empty_cache()
    # K9: every streamed chunk's gather of one more proof
    out["gather_openings_stream"] = check_stream_gathers()
    return out


def check_stream_gathers(reps: int = 20) -> dict:
    """K9 on the memory mode's path: one more fib 2^22 proof with
    `merkle.gather_columns` wrapped, each of its calls (a recomputed
    column chunk of a streamed tree at the opened positions) held to
    the plain version on its own inputs as it returns; then a random
    chunk of the first call's shape at its positions, timed (queued:
    the card's time) beside the plain version and `torch.index_select`,
    the one PyTorch call that computes this function.  Returns the timed
    record."""
    import torch
    from nexus_zkvm_tpu_torch.ops import merkle
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    orig, seen = merkle.gather_columns, []

    def wrapped(src, idx):
        got = orig(src, idx)
        ix = (idx.cpu().numpy() if isinstance(idx, torch.Tensor)
              else np.asarray(idx, np.int64))
        want = merkle.gather_openings_plain([merkle._Gather(src, ix, 1)])
        if not torch.equal(got.reshape(-1), want):
            raise RuntimeError(f"gather_openings {tuple(src.shape)} at "
                               f"{len(ix)} positions: kernel and plain "
                               f"version differ")
        seen.append((tuple(int(x) for x in src.shape), ix))
        return got
    merkle.gather_columns = wrapped
    try:
        LocalProver(fib_guest(), memory=MemoryConfig(
            **STREAM_FORCED)).prove_with_input(
                public_input=encode_u32s(FIB_STREAM_N))
    finally:
        merkle.gather_columns = orig
    if not seen:
        raise RuntimeError("the 2^22 proof gathered no streamed chunk")
    (rows, N), ix = seen[0]
    rng = np.random.default_rng(2032)
    chunk = from_u32(rng.integers(0, P31, (rows, N), dtype=np.uint32), "cuda")
    idx = torch.as_tensor(ix, device="cuda")
    n = len(ix)
    rec = check("gather_openings", [rows, N, n],
                lambda: merkle.gather_columns(chunk, idx),
                lambda: merkle.gather_openings_plain(
                    [merkle._Gather(chunk, ix, 1)]).reshape(rows, n),
                8 * rows * n + 8 * n, 0, True, reps=reps, plain_reps=reps,
                queued=True)
    rec.update(library_ms=cuda_ms(lambda: chunk.index_select(1, idx), reps,
                                  True),
               library_call="torch.Tensor.index_select(1, idx)",
               host_ms=cuda_ms(lambda: merkle.gather_columns(chunk, idx),
                               reps),
               library_host_ms=cuda_ms(lambda: chunk.index_select(1, idx),
                                       reps),
               calls_checked=len(seen))
    emit({"phase": "stream_gathers", "calls": len(seen),
          "shapes": sorted({(r, c, len(i)) for (r, c), i in seen}),
          **{k: rec[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                 "library_ms", "host_ms", "library_host_ms")}})
    del chunk
    torch.cuda.empty_cache()
    return rec


def phase_machine_parity(n: int = FIB_PARITY_N):
    """The fib guest at a small n proved on the CPU (plain path) and on
    the card: the serialized proofs must be byte-equal."""
    from nexus_zkvm_tpu_torch.sdk import encode_u32s
    emit({"phase": "machine_parity", "n": n,
          **_cpu_card_parity(fib_guest(), encode_u32s(n))})


def phase_keccak_parity():
    """The keccak guest (KECCAK_SRC: one keccak-f permutation of a heap
    block) proved on the CPU (plain path) and on the card, so that its
    keccak component's real rows run through K7's generated pieces: the
    proof bytes must be equal, and the card's proof must have launched
    both K7 entries."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.sdk import Guest
    before = kernels.launch_counts()
    rec = _cpu_card_parity(Guest.from_asm(KECCAK_SRC), b"")
    ran = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    if not ran["air_eval_composition"] or not ran["air_eval_operands"]:
        raise RuntimeError(f"the keccak proof skipped K7: {ran}")
    emit({"phase": "keccak_parity", "guest": "KECCAK_SRC", **rec,
          "k7_launches": {k: ran[k] for k in ("air_eval_composition",
                                              "air_eval_operands")}})


def _cpu_card_parity(guest, public: bytes) -> dict:
    """Prove ``guest`` on ``public`` on the CPU and on the card; raise
    unless the serialized proofs are byte-equal and verify."""
    from nexus_zkvm_tpu_torch.sdk import LocalProver, proof_to_bytes
    out, secs = {}, {}
    for device in ("cpu", "cuda"):
        prover = LocalProver(guest, device=device)
        t0 = time.perf_counter()
        view, proof = prover.prove_with_input(public_input=public)
        secs[device] = time.perf_counter() - t0
        out[device] = proof_to_bytes(proof)
    if out["cpu"] != out["cuda"]:
        raise RuntimeError("CPU and CUDA machine proofs differ")
    if not prover.verify(view, proof):
        raise RuntimeError("the machine proof does not verify")
    return {"equal_bytes": True, "log_sizes": proof.stark.log_sizes,
            "proof_bytes": len(out["cuda"]),
            "proof_blake2s": proof_digest(out["cuda"]),
            "cpu_prove_s": secs["cpu"], "cuda_prove_s": secs["cuda"]}


# ---------------------------------------------------------------------------
# machine2: the per-instruction-family prover generation
# ---------------------------------------------------------------------------

# the kernels a machine2 proof launches at the default route: every one
# but K5 (the families are filled on the host) and the memory mode's three
MACHINE2_KERNELS = ("circle_ifft", "circle_fft", "blake2s_messages",
                    "blake2s_parents", "deep_quotients", "fri_fold",
                    "logup_columns", "air_eval_composition",
                    "air_eval_operands", "oods_dot", "gather_openings")
# the fib guest's two large families at n = FIB_N: (name, columns, log
# rows); ADD and ADDI steps fill ex_alu, BNE and BEQ ex_branch
MACHINE2_SHAPES = (("ex_alu", 51, FULL_LOG), ("ex_branch", 54, 18))
# the kernels machine2's fib proof at n = FIB_STREAM_N launches by the
# default route and a route forced to stream (`phase_machine2_large`)
# between them: every one but K5
MACHINE2_LARGE_KERNELS = MACHINE2_KERNELS + MEMORY_MODE
# blake2s of the bundle the JAX package's CLI writes for `prove
# examples/guests/fib.s --input 10 --cpu` (1,566,100 bytes;
# tests/test_torch_cli.py holds the port's CPU bundle to it)
CLI_FIB10_BUNDLE_BLAKE2S = \
    "1ae79ea0eba5fb9725540a1506915687be79c9489f77ef96af222b88f200ba81"


def machine2_rejects(view, proof, config) -> None:
    """The four forgeries a machine2 proof must fail: a tampered opening
    and another program's claim (`rejects_tampering`), the exit code
    flipped, and the proof under machine v1's `verify_machine`."""
    import copy
    from nexus_zkvm_tpu_torch.machine import verify_machine
    from nexus_zkvm_tpu_torch.machine2 import verify_machine2
    rejects_tampering(lambda v, p: verify_machine2(v, p, config), view,
                      proof)
    flipped = copy.deepcopy(view)
    flipped.exit_code ^= 1
    if verify_machine2(flipped, proof, config):
        raise RuntimeError("the machine2 proof verifies a flipped exit code")
    if verify_machine(view, proof, config):
        raise RuntimeError("machine v1's verifier accepts a machine2 proof")


def machine2_families(view, proof, shapes) -> tuple:
    """The machine2 components of ``view`` and each one's log rows and
    main columns in ``proof`` ({name: log}, {name: columns}); raises
    unless every (name, columns, log rows) of ``shapes`` holds."""
    from nexus_zkvm_tpu_torch.machine2 import build_components2
    comps = build_components2(view)[0]
    logs = {c.name: n for c, n in zip(comps, proof.stark.log_sizes)}
    widths = {c.name: c.n_main for c in comps}
    for name, cols, log in shapes:
        if (widths[name], logs[name]) != (cols, log):
            raise RuntimeError(f"{name} at ({widths[name]}, 2^{logs[name]}),"
                               f" not ({cols}, 2^{log})")
    return comps, logs, widths


def machine2_prove(n: int, shapes, where: str) -> dict:
    """The fib guest at ``n`` through ``machine2.prove_machine2`` on the
    card by its default route (PcsConfig(), ``MemoryConfig.for_device``):
    a cold proof, then a warm one, profiled with each phase's allocated
    and reserved peaks; it verifies, its fib output is right, its
    families have ``shapes`` (`machine2_families`) and the four
    forgeries are rejected (`machine2_rejects`).  ``where`` names the
    phase.  Returns {"view", "trace", "config", "proof", "comps", "notes"
    (the route), "rec": the fields both machine2 phases emit, the
    launches of the two proofs among them}."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine2 import (EXEC_FAMILIES,
                                               prove_machine2,
                                               verify_machine2)
    from nexus_zkvm_tpu_torch.prover import PcsConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          decode_u32s, proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    config = PcsConfig()
    total = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    view, trace = LocalProver(fib_guest()).trace(
        public_input=encode_u32s(n))
    emulate_s = time.perf_counter() - t0
    steps = int(len(trace.steps["clk"]))
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prove_machine2(view, trace, config)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(),
             torch.cuda.max_memory_reserved()]
    with profiled(memory=True) as prof:
        t0 = time.perf_counter()
        proof = prove_machine2(view, trace, config)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    peaks = [max([peaks[0], torch.cuda.max_memory_allocated(),
                  *prof.peaks.values()]),
             max([peaks[1], torch.cuda.max_memory_reserved(),
                  *prof.reserved.values()])]
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    ok = verify_machine2(view, proof, config)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise RuntimeError(f"{where}: the machine2 proof does not verify")
    if decode_u32s(view.public_output, 1)[0] != fib_u32(n):
        raise RuntimeError(f"{where}: wrong fib output")
    comps, logs, widths = machine2_families(view, proof, shapes)
    machine2_rejects(view, proof, config)
    blob = proof_to_bytes(proof)
    route = prof.notes
    family_rows = sum(1 << logs[f.name] for f in EXEC_FAMILIES)
    rec = {"phase": where, "guest": "examples/guests/fib.s", "n": n,
           "steps": steps, "log_sizes": proof.stark.log_sizes,
           "families": {f.name: [widths[f.name], logs[f.name]]
                        for f in EXEC_FAMILIES},
           "proof_bytes": len(blob), "proof_blake2s": proof_digest(blob),
           "verified": True, "rejected": ["tampered_opening", "other_claim",
                                          "exit_code_flipped", "machine_v1"],
           "memory": route["memory"], "streamed": route["streamed"],
           "composition_passes": route["composition_passes"],
           "cache_released": route["cache_released"],
           "emulate_s": emulate_s, "prove_cold_s": cold_s,
           "prove_s": prove_s, "verify_s": verify_s,
           "host_fill_s": prof.times.get("fills/f:machine2"),
           "rows_per_s": (1 << max(proof.stark.log_sizes)) / prove_s,
           "family_rows_per_s": family_rows / prove_s,
           "steps_per_s": steps / prove_s,
           "peak_bytes": peaks[0], "peak_reserved_bytes": peaks[1],
           "reserved_share": peaks[1] / total, "total_memory": total,
           "phase_peak_bytes": prof.peaks,
           "phase_reserved_bytes": prof.reserved, "phase_s": prof.times,
           "launches": launches}
    return {"view": view, "trace": trace, "config": config, "proof": proof,
            "comps": comps, "notes": route, "rec": rec}


def phase_machine2(v1: dict) -> dict:
    """The fib guest at n = FIB_N through `machine2_prove` (cold, then
    warm and profiled; ``fills/f:machine2`` is the families' host fill):
    the resident route in one pass, K8 once a proof, the launches of the
    two proofs against MACHINE2_KERNELS, rows/s beside machine v1's
    (``v1``: phase `machine`'s record).  Then one more proof with its
    calls of K3, K4 and K6-K9 recorded (`record_calls`): its bytes equal
    the profiled proof's, and every call again through the kernel and
    its plain version (`check_recorded`: uint32-equal; the largest
    timed); and K1-K4 at that proof's shapes (`check_prover_kernels`,
    untimed).  Returns the launch counts of the two proofs and the
    proof's digest."""
    import torch
    from nexus_zkvm_tpu_torch.machine2 import prove_machine2
    from nexus_zkvm_tpu_torch.sdk import proof_to_bytes
    run = machine2_prove(FIB_N, MACHINE2_SHAPES, "machine2")
    rec, route = run["rec"], run["notes"]
    launches = rec["launches"]
    if route["streamed"] or max(route["composition_passes"]) != 1:
        raise RuntimeError(f"the machine2 proof left the resident route: "
                           f"{route}")
    check_path("machine2", launches, MACHINE2_KERNELS)
    if launches["oods_dot"] != 2:
        raise RuntimeError(f"K8 launched {launches['oods_dot']} times in "
                           f"2 proofs, not once a proof")
    emit({**rec, "machine_v1": {k: v1[k] for k in (
        "prove_s", "rows_per_s", "steps_per_s", "peak_bytes")}})
    view, trace, config = run["view"], run["trace"], run["config"]
    comps = run["comps"]
    blob = proof_to_bytes(run.pop("proof"))
    torch.cuda.empty_cache()
    proof2, calls = record_calls(
        lambda: prove_machine2(view, trace, config))
    del trace, run
    if proof_to_bytes(proof2) != blob:
        raise RuntimeError("two machine2 proofs of one trace differ")
    log_sizes = proof2.stark.log_sizes
    del proof2
    check_recorded(calls, timed_run=True, path="machine2_")
    del calls
    torch.cuda.empty_cache()
    check_prover_kernels(comps, log_sizes, timed=False)
    torch.cuda.empty_cache()
    return launches, rec["proof_blake2s"]


def phase_machine2_parity() -> None:
    """The fib guest at n = FIB_PARITY_N and the keccak guest
    (KECCAK_SRC: its ex_keccak family and keccak component through K7's
    pieces) through ``prove_machine2`` on the CPU and on the card:
    byte-equal proofs that verify, K7 launched.  Then the port's
    constraint harness (``air.testing.assert_constraints``) on the
    n = FIB_PARITY_N machine2 traces on the card (K7 and K6 make the
    interaction) raises nothing."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.air.testing import assert_constraints
    from nexus_zkvm_tpu_torch.machine2 import (build_machine2_traces,
                                               prove_machine2,
                                               verify_machine2)
    from nexus_zkvm_tpu_torch.sdk import (Guest, LocalProver, encode_u32s,
                                          proof_to_bytes)
    rec = {"phase": "machine2_parity"}
    for name, guest, public in (
            ("fib", fib_guest(), encode_u32s(FIB_PARITY_N)),
            ("keccak", Guest.from_asm(KECCAK_SRC), b"")):
        view, trace = LocalProver(guest, device="cpu").trace(
            public_input=public)
        blobs, secs = {}, {}
        before = kernels.launch_counts()
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            proof = prove_machine2(view, trace, device=device)
            secs[device] = time.perf_counter() - t0
            blobs[device] = proof_to_bytes(proof)
        ran = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if blobs["cpu"] != blobs["cuda"]:
            raise RuntimeError(f"{name}: CPU and CUDA machine2 proofs differ")
        if not verify_machine2(view, proof):
            raise RuntimeError(f"{name}: the machine2 proof does not verify")
        if not ran["air_eval_composition"] or not ran["air_eval_operands"]:
            raise RuntimeError(f"{name}: the machine2 proof skipped K7")
        rec[name] = {"equal_bytes": True, "log_sizes": proof.stark.log_sizes,
                     "proof_bytes": len(blobs["cuda"]),
                     "proof_blake2s": proof_digest(blobs["cuda"]),
                     "cpu_prove_s": secs["cpu"], "cuda_prove_s": secs["cuda"]}
    view, trace = LocalProver(fib_guest(), device="cpu").trace(
        public_input=encode_u32s(FIB_PARITY_N))
    comps, log_sizes, traces = build_machine2_traces(view, trace,
                                                     device="cuda")
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    assert_constraints(comps, log_sizes, traces, device="cuda")
    ran = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    if not ran["air_eval_operands"] or not ran["logup_columns"]:
        raise RuntimeError(f"the harness on the card skipped K7 or K6: {ran}")
    rec["harness"] = {"components": len(comps), "seconds":
                      time.perf_counter() - t0, "violations": 0,
                      "launches": {k: ran[k] for k in (
                          "air_eval_operands", "logup_columns")}}
    emit(rec)


def machine2_forced(view, log: int) -> dict:
    """MemoryConfig fields that stream the main and interaction trees of
    machine2's fib proof whose largest family, ex_alu, has 2^log rows
    (the threshold half the smaller of the two at 2^(log + 1) leaves),
    in 16-column chunks of 2^(log + 1) rows, and compose ex_alu in 4
    passes."""
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.machine2 import build_components2
    from nexus_zkvm_tpu_torch.prover.stark import _natural_rows
    alu = next(c for c in build_components2(view)[0] if c.name == "ex_alu")
    info = component_info(alu)
    cols = min(info.n_main, 4 * info.n_logup_cols)
    return {"stream_commit_bytes": cols * (4 << (log + 1)) // 2,
            "stream_chunk_bytes": 16 * (4 << (log + 1)),
            "comp_nat_budget": _natural_rows(info) * (4 << (log + 2)) // 4}


def machine2_passes(view, log: int, total: int, passes: int) -> dict:
    """MemoryConfig fields of a card of ``total`` bytes
    (`MemoryConfig.for_bytes`, not fitted to the proof) but for a budget
    that composes machine2's ex_alu at 2^log rows in ``passes`` row
    passes."""
    import dataclasses
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.machine2 import build_components2
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.prover.stark import _natural_rows
    alu = next(c for c in build_components2(view)[0] if c.name == "ex_alu")
    fields = dataclasses.asdict(MemoryConfig.for_bytes(total))
    fields["comp_nat_budget"] = _natural_rows(
        component_info(alu)) * (4 << (log + 2)) // passes
    if "fit_bytes" in fields:
        fields["fit_bytes"] = None
    return fields


def phase_selftest() -> dict:
    """The prover's self-test on the card: the fib guest at n =
    FIB_PARITY_N through ``machine.prove_machine(..., selftest=True)``
    (default PcsConfig): its bytes equal the proof without it; the
    returned report (``prof.notes["selftest"]``) reads no OODS sample
    mismatch, every component OK and ``match``.  Then once more with the
    CPU component's domain accumulator moved by one (`perturbed`): it
    alone reads BAD, and the per-constraint check (the plain tape
    interpreter on the card's tensors) finds every constraint equal, as
    it must when the accumulator is at fault.  Returns the launches of
    the self-test's proof."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine import prove_machine
    from nexus_zkvm_tpu_torch.prover import stark
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    view, trace = LocalProver(fib_guest()).trace(
        public_input=encode_u32s(FIB_PARITY_N))
    t0 = time.perf_counter()
    plain = proof_to_bytes(prove_machine(view, trace))
    plain_s = time.perf_counter() - t0
    before = kernels.launch_counts()
    with profiled() as prof:
        t0 = time.perf_counter()
        blob = proof_to_bytes(prove_machine(view, trace, selftest=True))
        selftest_s = time.perf_counter() - t0
    ran = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    rep = prof.notes["selftest"]
    if blob != plain:
        raise RuntimeError("the self-test changed the proof")
    bad = [c["name"] for c in rep["components"] if not c["ok"]]
    if rep["sampling_mismatches"] or bad or not rep["match"]:
        raise RuntimeError(f"the self-test failed: {rep['lines']}")
    orig = stark._domain_accumulator

    def perturbed(component, *args):
        acc = orig(component, *args)
        if component.name == "cpu":
            acc = acc.clone()
            acc[0, 0] = (acc[0, 0] + 1) % P31
        return acc
    stark._domain_accumulator = perturbed
    try:
        with profiled() as prof:
            prove_machine(view, trace, selftest=True)
    finally:
        stark._domain_accumulator = orig
    perturbed_rep = prof.notes["selftest"]
    flagged = [c for c in perturbed_rep["components"] if not c["ok"]]
    if [c["name"] for c in flagged] != ["cpu"] or flagged[0][
            "constraints"] != [] or not perturbed_rep["match"]:
        raise RuntimeError(f"the perturbed self-test read "
                           f"{perturbed_rep['lines']}")
    torch.cuda.empty_cache()
    emit({"phase": "selftest", "n": FIB_PARITY_N,
          "proof_blake2s": proof_digest(blob), "equal_bytes": True,
          "sampling_mismatches": rep["sampling_mismatches"],
          "components": len(rep["components"]), "all_ok": True,
          "match": rep["match"], "lines": rep["lines"],
          "first_prove_s": plain_s, "selftest_prove_s": selftest_s,
          "selftest_s": prof.times.get("oods/selftest"),
          "perturbed": {"bad": ["cpu"], "constraints_differing": 0,
                        "lines": [ln for ln in perturbed_rep["lines"]
                                  if " BAD " in ln
                                  or ln.startswith("[selftest]   ")]},
          "launches": ran})
    return ran


def phase_machine2_large() -> dict:
    """machine2 above 2^20 rows: the fib guest at FIB_STREAM_N (4,194,300
    steps; ex_alu at (51, 2^22)) through `machine2_prove` (the card's
    default route, ``MemoryConfig.for_device``: cold, then warm and
    profiled, verify, the four forgeries rejected), its reserved peak
    within FIT_SHARE of the card and the process's resident host memory
    (the families' numpy fills) within FIT_SHARE of the host's.  Then
    one more proof by that route and one by a route forced to stream the
    main and interaction trees and compose ex_alu in 4 passes
    (`machine2_forced`), each with its calls held to their plain
    versions as it makes them (`check_inline` with INLINE_M2: the first
    call of each shape, over both proofs, of K1-K4 and K6-K12): the same
    bytes, every kernel either proof launched held at least once.  The
    launches of the two routes together must be MACHINE2_LARGE_KERNELS.
    Returns {"default": the launches of the two default proofs,
    "forced": of the forced one}."""
    import dataclasses
    import resource
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine2 import prove_machine2
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import proof_to_bytes
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    host_total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    run = machine2_prove(FIB_STREAM_N, [("ex_alu", 51, STREAM_LOG)],
                         "machine2_large")
    rec, route = run["rec"], run["notes"]
    view, trace, config = run["view"], run["trace"], run["config"]
    default = rec["launches"]
    if route["memory"] != dataclasses.asdict(MemoryConfig.for_device(
            "cuda")):
        raise RuntimeError(f"the prover took {route['memory']}, not the "
                           f"card's default")
    if rec["reserved_share"] > FIT_SHARE:
        raise RuntimeError(f"the default route reserved "
                           f"{rec['peak_reserved_bytes']} bytes, over "
                           f"{FIT_SHARE} of the card's {rec['total_memory']}")
    digest = rec["proof_blake2s"]
    del run

    # each route once more, every call of a new shape held to its plain
    # version
    seen, routes = set(), {}
    fields = machine2_forced(view, STREAM_LOG)
    for name, memory in (("default", None),
                         ("forced", MemoryConfig(**fields))):
        torch.cuda.empty_cache()
        before = kernels.launch_counts()
        with profiled() as prof:
            t0 = time.perf_counter()
            proof, checked = check_inline(
                lambda: prove_machine2(view, trace, config, memory=memory),
                INLINE_M2, seen)
            checked_s = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if proof_digest(proof_to_bytes(proof)) != digest:
            raise RuntimeError(f"the {name} route's checked machine2 2^22 "
                               f"proof differs from the default's")
        del proof
        routes[name] = {"launches": ran, "notes": prof.notes,
                        "checked_proof_s": checked_s, "checked": checked}
    held = {c["kernel"] for r in routes.values() for c in r["checked"]}
    unheld = {k for r in routes.values() for k, v in r["launches"].items()
              if v} - held
    if unheld:
        raise RuntimeError(f"machine2_large launched {sorted(unheld)} with "
                           f"no call held to its plain version")
    froute = routes["forced"]["notes"]
    s = STREAM_LOG + config.fri.log_blowup
    if not {("main", s), ("inter", s)} <= set(froute["streamed"]) or \
            max(froute["composition_passes"]) < 2:
        raise RuntimeError(f"the forced machine2 route streamed "
                           f"{froute['streamed']} in "
                           f"{froute['composition_passes']} passes")
    forced = routes["forced"]["launches"]
    both = {k: default[k] + forced[k] for k in default}
    check_path("machine2_large", both, MACHINE2_LARGE_KERNELS)
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if host_peak > FIT_SHARE * host_total:
        raise RuntimeError(f"the process held {host_peak} bytes of host "
                           f"memory, over {FIT_SHARE} of {host_total}")
    del trace
    torch.cuda.empty_cache()
    emit({**rec, "host_peak_rss_bytes": host_peak, "host_memory": host_total,
          "held_kernels": sorted(held),
          "checked_default": {
              k: routes["default"][k] for k in (
                  "checked_proof_s", "checked", "launches")},
          "forced": {"memory": fields, "streamed": froute["streamed"],
                     "composition_passes": froute["composition_passes"],
                     "equal_bytes": True,
                     **{k: routes["forced"][k] for k in (
                         "checked_proof_s", "checked", "launches")}}})
    return {"default": default, "forced": forced}


def phase_cli() -> None:
    """The CLI as a user runs it, each command a process: `prove
    examples/guests/fib.s --input 10` on the card and with ``--cpu``:
    byte-equal bundles, equal to the JAX package's CLI bundle
    (CLI_FIB10_BUNDLE_BLAKE2S); `verify` of it exits 0 and of a copy
    with one byte flipped exits 1."""
    import tempfile

    def cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "nexus_zkvm_tpu_torch.cli",
                            *args], cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        return r, time.perf_counter() - t0

    rec = {"phase": "cli"}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        blobs = {}
        for tag, extra in (("cuda", ()), ("cpu", ("--cpu",))):
            out = tmp / f"fib10.{tag}.bundle"
            r, secs = cli("prove", "examples/guests/fib.s", "--input", "10",
                          "-o", str(out), *extra)
            if r.returncode:
                raise RuntimeError(f"cli prove ({tag}) exited "
                                   f"{r.returncode}: {r.stdout}{r.stderr}")
            blobs[tag] = out.read_bytes()
            rec[f"prove_{tag}_s"] = secs
        if blobs["cuda"] != blobs["cpu"]:
            raise RuntimeError("the CLI's card and CPU bundles differ")
        if proof_digest(blobs["cuda"]) != CLI_FIB10_BUNDLE_BLAKE2S:
            raise RuntimeError("the CLI bundle differs from the reference's")
        r, rec["verify_s"] = cli("verify", str(tmp / "fib10.cuda.bundle"))
        if r.returncode != 0 or "verified: True" not in r.stdout:
            raise RuntimeError(f"cli verify exited {r.returncode}: "
                               f"{r.stdout}{r.stderr}")
        bad = bytearray(blobs["cuda"])
        bad[len(bad) // 2] ^= 1
        (tmp / "bad.bundle").write_bytes(bytes(bad))
        r, rec["verify_flipped_s"] = cli("verify", str(tmp / "bad.bundle"))
        if r.returncode != 1:
            raise RuntimeError(f"cli verify of a flipped bundle exited "
                               f"{r.returncode}: {r.stdout}{r.stderr}")
    rec.update(bundle_bytes=len(blobs["cuda"]), equal_bytes=True,
               bundle_blake2s=proof_digest(blobs["cuda"]),
               verify_rc=0, flipped_rc=1)
    emit(rec)


# ---------------------------------------------------------------------------
# Phase 8: the prover over a mesh; each rank is a process, started and
# run by tests/torch_mesh.py (its `spawn` and rank programs)
# ---------------------------------------------------------------------------

MESH_COMMIT = (244, FULL_LOG)    # the interaction of fib 2^20: (C, log N)
MESH_SEED = 2029
MESH_RANKS = 4
FIB_MESH4_N = 104_850            # 524,260 steps: a 2^19-row CPU component
MESH4_LOG = 19
# fib at FIB_N (1,048,500 steps) in four 2^18-step segments on 2 ranks
MESH_SEGMENT_LOG = 18


def mesh_helpers(root: Path = ROOT):
    """tests/torch_mesh.py of the checkout at ``root``, the launcher and
    rank programs of the mesh checks (the ranks import it by name, so its
    folder joins the path they inherit)."""
    tests = str(root / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_mesh
    return torch_mesh


def host_copy_gbps(device, nbytes: int = 1 << 28) -> dict:
    """The copy rates of a gloo mesh's staging on a card, GB/s: device
    to pinned host memory (its sends) and back (its gathers)."""
    import torch
    x = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
    pinned = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True)
    pinned.copy_(x)
    rates = {}
    for name, fn in (("d2h", lambda: pinned.copy_(x)),
                     ("h2d", lambda: x.copy_(pinned))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates[name] = nbytes / (time.perf_counter() - t0) / 1e9
    return rates


# each rank's peak device memory against the single process's peak of
# the same proof, at most (the mesh's purpose: a rank holds its windows):
# the ratios measured with the interaction in windows (PERF.md §6),
# 0.417 and 0.253, plus 0.05
MESH_PEAK_RATIO = {2: 0.467, 4: 0.303}


def check_mesh_windows(where: str, rec, cpu_logs, halo: tuple) -> None:
    """What one rank of a mesh machine proof (``rec``, from
    torch_mesh.mesh_machine_rank) committed and held: nothing streamed;
    the proof's first components are its CPU components (or machine2's
    largest family), of 2^n rows for n in ``cpu_logs`` in turn; at each
    of their sizes the main and interaction trees committed in row
    windows over the mesh (and the composition's), and the rank's window
    of the main group M/D rows of the 2^(n + 1) domain; the interaction
    of every component with lookups, every CPU component among them,
    generated for its natural window [r·M/D, (r+1)·M/D) where the mesh
    splits its M rows, else for all of them; of the natural values only
    that window kept, with ``halo`` = (hneg, hpos) rows around it at the
    CPU components' size (the gen tapes'), and natural main values at
    each of those sizes.  Needs no card: the CPU tests run it on their
    ranks' records."""
    from nexus_zkvm_tpu_torch.parallel.commit import MIN_WINDOW
    D, r, logs = rec["ranks"], rec["rank"], rec["log_sizes"]
    k = len(cpu_logs)
    if list(logs[:k]) != list(cpu_logs):
        raise RuntimeError(f"{where}: components at 2^{logs}, not the CPU "
                           f"components at 2^{list(cpu_logs)} first")
    sizes = sorted(set(cpu_logs))
    got = {tuple(g) for g in rec["sharded"]}
    want = {(role, n + 1) for n in sizes for role in ("main", "inter")}
    if not want <= got or not any(role == "comp" for role, _s in got) or \
            rec["streamed"]:
        raise RuntimeError(f"{where}: not committed in windows over the "
                           f"mesh: {rec['sharded']}, streamed "
                           f"{rec['streamed']}")
    for n in sizes:
        w = (1 << (n + 1)) // D
        main = [g for g in rec["mesh_windows"] if tuple(g[:2]) == ("main",
                                                                 n + 1)]
        if [tuple(g[2]) for g in main] != [(r * w, (r + 1) * w)] or \
                main[0][4][1] != w:
            raise RuntimeError(f"{where}: holds {main}, not the window "
                               f"[{r * w}, {(r + 1) * w})")

    def window(m):
        return ((r * m // D, m // D) if m // D >= MIN_WINDOW else (0, m))
    inter = [tuple(g) for g in rec["interaction_windows"]]
    bad = [g for g in inter if (g[1], g[2] - g[1]) != window(
        1 << logs[g[0]])]
    if bad or not set(range(k)) <= {c for c, _lo, _hi in inter}:
        raise RuntimeError(f"{where}: interaction windows {bad} not the "
                           f"rank's, or none of a CPU component: {inter}")
    nat = rec["natural_windows"]
    for role, n_, (lo, L, hneg), shape in nat:
        m = 1 << n_
        hn, hp = halo if n_ in sizes else (hneg, shape[1] - hneg - L)
        if L == m:                  # held whole, without a halo
            hn, hp = 0, 0
        if (lo, L) != window(m) or hneg != hn or hp < 0 or \
                shape[1] != hn + L + hp:
            raise RuntimeError(f"{where}: natural {role} values at "
                               f"2^{n_} held as {(lo, L, hneg)}, "
                               f"{shape}, not the window {window(m)} "
                               f"with its halo")
    held = {n_ for role, n_, _span, _shape in nat if role == "main"}
    if not set(sizes) <= held:
        raise RuntimeError(f"{where}: no natural main values at "
                           f"2^{sorted(set(sizes) - held)}: {nat}")


def _check_mesh_machine(path: str, n: int, recs, digest: str,
                        cpu_logs, expected, single_peak, halo: tuple,
                        phase: str = "parallel",
                        kernels_held: bool = True) -> None:
    """Every rank's proof: bytes equal to the single process's (its
    digest), equal on every rank, verified; its windows as
    `check_mesh_windows` holds them (the CPU components at 2^n for n in
    ``cpu_logs``, first, and no other component at their sizes;
    ``halo`` at their size); exactly the kernels
    ``expected`` launched; its peak device memory within
    MESH_PEAK_RATIO of the single process's ``single_peak`` (when one
    was measured; emitted with its peak by phase); with
    ``kernels_held``, rank 0's calls of every kernel wrapper at its
    shapes equal to their plain versions (`RECORDED`,
    `RECORDED_BY_SHAPE`; torch_mesh.check_rank_kernels)."""
    for rec in recs:
        where = f"{path}/rank{rec['rank']}"
        D, r = rec["ranks"], rec["rank"]
        rest = rec["log_sizes"][len(cpu_logs):]
        if set(rest) & set(cpu_logs):
            raise RuntimeError(f"{where}: components at 2^{rest} beside "
                               f"the CPU components at 2^{list(cpu_logs)}")
        if rec["proof_blake2s"] != digest or not rec["ranks_agree"]:
            raise RuntimeError(f"{where}: the proof differs from the single "
                               f"process's")
        if not rec["verified"]:
            raise RuntimeError(f"{where}: the proof does not verify")
        check_mesh_windows(where, rec, cpu_logs, halo)
        check_path(where, rec["launches"], expected)
        ratio = None
        if single_peak is not None:
            ratio = rec["peak_bytes"] / single_peak
            if ratio > MESH_PEAK_RATIO[D]:
                raise RuntimeError(f"{where}: peak {rec['peak_bytes']} "
                                   f"bytes, {ratio:.3f} of the single "
                                   f"process's {single_peak} (at most "
                                   f"{MESH_PEAK_RATIO[D]})")
        wk = rec["window_kernels"]
        if kernels_held and r == 0 and (not wk or not all(
                wk.get(k) for k in (*RECORDED, *RECORDED_BY_SHAPE))):
            raise RuntimeError(f"{where}: a kernel wrapper not held at the "
                               f"rank's shapes: {wk}")
        s = min(cpu_logs) + 1
        emit({"phase": phase, "path": path, "n": n, **{
            k: rec[k] for k in ("rank", "ranks", "backend", "cpu_log_rows",
                                "segment_log", "log_sizes", "proof_blake2s",
                                "proof_bytes", "warm", "prove_s",
                                "prove_cold_s", "cold_phase_s", "verify_s",
                                "peak_bytes", "phase_peak_bytes",
                                "reserved_bytes", "phase_reserved_bytes",
                                "cold_peak_bytes", "cold_reserved_bytes",
                                "sharded", "streamed", "interaction_windows",
                                "phase_s", "launches", "window_kernels")},
              "single_process_peak_bytes": single_peak,
              "peak_ratio": ratio,
              "mesh_windows": [[role, s_, rows, cols]
                               for role, s_, rows, cols, _e, _c
                               in rec["mesh_windows"] if s_ >= s],
              "equal_to_single_process": True, "verified": True})


def commit_bound(C: int, log_n: int, ranks: int, gbps: dict) -> dict:
    """The least time of the windowed commit of (C, 2^log_n) on the
    2^(log_n + 1) domain by ``ranks`` gloo ranks sharing one card and
    its one host link: the K1 and K2 bounds (see `bound`) on the whole
    matrix, since the card runs every rank's share, plus the bytes the
    all_to_all moves through pinned host memory at the rates ``gbps``
    measured with no rank running: each rank's send buffer out (its
    share of ceil(C / ranks) columns' evaluations, the M/ranks rows of
    every window) and its received windows in (the same size), and the
    subtree roots.  gloo's exchange between the host buffers is left
    out: it has no rate to bound it by."""
    k = -(-C // ranks)
    N, M = 1 << log_n, 1 << (log_n + 1)

    def butterflies(c, n):
        return c * n * (1 << (n - 1))
    parts = {
        "circle_ifft": bound(8 * C * N + 4 * N, butterflies(C, log_n)
                             * (2 * ADD + MUL) + C * N * MUL),
        "circle_fft": bound(8 * C * M + 4 * M,
                            butterflies(C, log_n + 1) * (2 * ADD + MUL)),
        "blake2s_messages": bound(4 * C * M + 32 * M,
                                  M * -(-4 * C // 64) * COMPRESS),
        "blake2s_parents": bound(96 * M, M * COMPRESS)}
    share = 4 * k * M + 32
    out_bytes, in_bytes = ranks * share, ranks * (share + 32 * ranks)
    copy_ms = (out_bytes / gbps["d2h"] + in_bytes / gbps["h2d"]) / 1e6
    return {"bound_ms": sum(ms for ms, _by in parts.values()) + copy_ms,
            "kernel_bounds_ms": {k_: ms for k_, (ms, _by) in parts.items()},
            "host_copy_ms": copy_ms, "host_copy_bytes": out_bytes + in_bytes,
            "copy_gbps": gbps, "transport": "gloo through host memory"}


def _single_proof(tm, src: str, n: int, segment_log: int | None = None,
                  timeout: float = 300) -> dict:
    """The fib guest at ``n`` (in 2^segment_log-step segments, when
    given) proved by one process alone on the card, a fresh one as each
    mesh rank is, through the ranks' own program (``mesh_machine_rank``
    on the local mesh: a cold proof, then the warm one whose seconds and
    peak device memory it reports)."""
    from nexus_zkvm_tpu_torch.sdk import encode_u32s
    rec, = tm.spawn(tm.mesh_machine_rank, 1, src, encode_u32s(n), "cuda",
                    None, True, False, False, segment_log, device="cuda",
                    timeout=timeout)
    if not rec["verified"]:
        raise RuntimeError(f"the single process's proof at n = {n} does "
                           f"not verify")
    return rec


def phase_parallel(fib_digest: str, m2_digest: str, m2_expected) -> None:
    """The prover over a mesh (``nexus_zkvm_tpu_torch.parallel``), its
    ranks processes sharing the card over gloo (NCCL refuses two ranks on
    one card; NCCL across cards is ``--mesh-nccl``'s, `mesh_nccl`).
    Each rank holds its row window of every group that splits
    (``prover/pcs.py``) and runs every phase on it:

    - the windowed LDE + Merkle commit at the interaction's shape of the
      fib 2^20 proof, (244, 2^20) -> 2^21, on 4 ranks: the root equals
      the single process's; per rank the steps' ms against the one
      bound of the shape (`commit_bound`, at host-copy rates the parent
      measures before any rank starts) and the single process's ms (its
      second, warm commit); the same from each rank's natural row window
      (step 0 first, as the interaction is committed): the root and ms;
      a sum, a sharded hash_rows and the
      all_to_all, disjoint sum and broadcast across the ranks; the
      synthetic slice at 2^10 proved under the mesh equal to the single
      process's proof;
    - the fib guest at a 2^19-row CPU component on the same 4 ranks,
      and at a 2^20-row one on 2 ranks (a cold proof, then a warm one,
      timed, its peak device memory a rank): on every rank the proof
      bytes equal the single process's, verify, nothing streamed, its
      trees committed in windows and its peak within MESH_PEAK_RATIO of
      the warm proof of the same n by one fresh process alone, measured
      here (`_single_proof`);
      every kernel of the resident path was launched on every rank;
      rank 0's kernel calls of its cold proof equal their plain versions
      at its shapes (`_check_mesh_machine`); each rank's peak by phase;
    - on the same 2 ranks, the fib guest at n = FIB_N through
      ``machine2.prove_machine2`` (a cold proof, then a warm one): on
      every rank the bytes of phase ``machine2``'s proof
      (``m2_digest``), verified, in windows as above (its ex_alu family
      at 2^20 rows in place of the CPU component), the kernels of
      ``m2_expected`` launched, rank 0's calls of its cold proof equal
      to their plain versions (phases prefixed "mesh_m2_"), its peak a
      rank and by phase reported;
    - on the same 2 ranks (their first proof), the fib guest at n =
      FIB_N in four 2^MESH_SEGMENT_LOG-step segments
      (``machine.prove_machine(...,
      segment_log=)``, four CPU components; a cold proof, then a warm
      one): on every rank the bytes of one fresh process's proof of the
      same, verified, every CPU segment in windows as above, the
      resident kernels launched, the peak within MESH_PEAK_RATIO of that
      process's, rank 0's calls of its cold proof equal to their plain
      versions (phases prefixed "mesh_seg_")."""
    import gc
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.air.tape import gen_tape
    from nexus_zkvm_tpu_torch.machine2 import EXEC_FAMILIES
    from nexus_zkvm_tpu_torch.prover import pcs
    from nexus_zkvm_tpu_torch.sdk import encode_u32s
    tm = mesh_helpers()
    # the rows around its own that the gen tape of each proof's largest
    # component reads (the CPU component, machine2's ex_alu family)
    comps, rel = fib_tapes(machine2=True)
    halo_v1, halo_m2 = (gen_tape(comps[i], PARITY_LOG, rel).halo() for i in
                        (0, len(comps) - len(EXEC_FAMILIES)))
    del comps, rel
    # the single process's results, on the card, freed before the ranks
    device = "cuda"
    C, log_n = MESH_COMMIT
    spec = (C, log_n, MESH_SEED)
    cols = tm.mesh_columns(spec, device)
    root = pcs.commit_blocks("t", [cols], [log_n], 1,
                             device).trees[log_n + 1].root()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcs.commit_blocks("t", [cols], [log_n], 1, device)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    del cols
    comps, cfg = make_components(K_SQUARES), T.PcsConfig()
    slice_proof = T.prove(comps, [PARITY_LOG, TABLE_LOG],
                          make_traces(PARITY_LOG, K_SQUARES),
                          T.Blake2sChannel(), cfg, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    src = (ROOT / "examples" / "guests" / "fib.s").read_text()
    single = {n: _single_proof(tm, src, n) for n in (FIB_MESH4_N, FIB_N)}
    if single[FIB_N]["proof_blake2s"] != fib_digest:
        raise RuntimeError("the fib 2^20 proof differs from phase machine's")
    digest19 = single[FIB_MESH4_N]["proof_blake2s"]
    single_seg = _single_proof(tm, src, FIB_N, MESH_SEGMENT_LOG)
    emit({"phase": "parallel_single", **{
        key: {"n": n, "segment_log": rec["segment_log"],
              "log_sizes": rec["log_sizes"], **{k: rec[k] for k in (
                  "peak_bytes", "phase_peak_bytes", "reserved_bytes",
                  "prove_s", "prove_cold_s", "phase_s", "proof_blake2s")}}
        for key, n, rec in [(f"2^{r['cpu_log_rows']}", n, r)
                            for n, r in single.items()]
        + [(f"2^{MESH_SEGMENT_LOG} x {SEGMENTS}", FIB_N, single_seg)]}})
    cbound = commit_bound(C, log_n, MESH_RANKS, host_copy_gbps(device))
    torch.cuda.empty_cache()
    expected = set(kernels.launch_counts()) - set(MEMORY_MODE)

    t0 = time.perf_counter()
    recs = tm.spawn(tm.checks_rank, MESH_RANKS, [
        (tm.mesh_commit_rank, (spec, log_n, 1)),
        (tm.mesh_collectives_rank, ()),
        (tm.mesh_slice_rank, (K_SQUARES, PARITY_LOG, cfg, device)),
        (tm.mesh_machine_rank, (src, encode_u32s(FIB_MESH4_N), device, None,
                                True, True))], backend="gloo", device=device,
                    timeout=300)
    wall = time.perf_counter() - t0
    for commit, coll, sl, _m in recs:
        where = f"parallel_commit/rank{commit['rank']}"
        if not np.array_equal(commit["root"], root) or \
                not commit["window_root_equal"] or \
                not commit["windows_root_equal"]:
            raise RuntimeError(f"{where}: the sharded root differs")
        if not all(commit["launches"][k] for k in tm.K1K2):
            raise RuntimeError(f"{where}: K1 or K2 not launched: "
                               f"{commit['launches']}")
        if not all(coll[k] for k in ("all_to_all_equal", "all_reduce_equal",
                                     "broadcast_equal", "hash_rows_equal")):
            raise RuntimeError(f"{where}: a collective is wrong: {coll}")
        if not sl["verified"] or not sl["sharded"] or sl["streamed"] or \
                not tree_eq(sl["proof"], slice_proof):
            raise RuntimeError(f"{where}: the 2^10 slice under the mesh "
                               f"differs from the single process's")
        emit({"phase": "parallel_commit", "rank": commit["rank"],
              "ranks": commit["ranks"], "backend": commit["backend"],
              "shape": commit["shape"], "root_equal": True,
              "ms": commit["ms"], "single_process_ms": single_ms,
              "step_ms": commit["step_ms"],
              "windows_ms": commit["windows_ms"],
              "windows_step_ms": commit["windows_step_ms"],
              "launches": commit["launches"], **cbound,
              "collectives": coll, "slice_equal": True,
              "slice_sharded": sl["sharded"], "spawn_wall_s": wall})
    _check_mesh_machine(f"parallel/gloo{MESH_RANKS}", FIB_MESH4_N,
                        [m for *_r, m in recs], digest19, [MESH4_LOG],
                        expected, single[FIB_MESH4_N]["peak_bytes"], halo_v1)
    del recs, commit, coll, sl

    # the segmented proof first: a rank keeps the device constants of
    # the proofs it made before, and its peak is held to a fresh
    # process's with the least margin (0.457 of 0.467, PERF.md §6)
    t0 = time.perf_counter()
    recs = tm.spawn(tm.checks_rank, 2, [
        (tm.mesh_machine_rank, (src, encode_u32s(FIB_N), device, None,
                                True, True, False, MESH_SEGMENT_LOG)),
        (tm.mesh_machine_rank, (src, encode_u32s(FIB_N), device, None, True,
                                True)),
        (tm.mesh_machine_rank, (src, encode_u32s(FIB_N), device, None,
                                True, True, True))],
                    backend="gloo", device=device, timeout=600)
    emit({"phase": "parallel_gloo2", "spawn_wall_s":
          time.perf_counter() - t0})
    _check_mesh_machine("parallel/gloo2/segments", FIB_N,
                        [seg for seg, _v1, _m2 in recs],
                        single_seg["proof_blake2s"],
                        [MESH_SEGMENT_LOG] * SEGMENTS, expected,
                        single_seg["peak_bytes"], halo_v1,
                        "parallel_segments")
    _check_mesh_machine("parallel/gloo2", FIB_N,
                        [v1 for _seg, v1, _m2 in recs], fib_digest,
                        [FULL_LOG], expected, single[FIB_N]["peak_bytes"],
                        halo_v1)
    # no single process's machine2 peak to hold a rank's to: reported
    _check_mesh_machine("parallel/gloo2/machine2", FIB_N,
                        [m2 for _seg, _v1, m2 in recs], m2_digest,
                        [FULL_LOG], m2_expected, None, halo_m2,
                        "parallel_machine2")


def fib_tapes(machine2: bool = False, segments: int = 1):
    """The fib guest's machine components (n = FIB_PARITY_N: the
    components, their tapes and so K7's sources are the same at every
    trace size; ``segments`` CPU components), with ``machine2`` the
    components of its machine2 proof after them (the 12 families; the
    others are machine v1's), and relations drawn from a fresh
    channel."""
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    view, _t = LocalProver(fib_guest(), device="cpu").trace(
        public_input=encode_u32s(FIB_PARITY_N))
    comps = build_components(view, segments)[0]
    if machine2:
        # (imported here: `--time-machine` may run a checkout without it)
        from nexus_zkvm_tpu_torch.machine2 import EXEC_FAMILIES, \
            build_components2
        comps = comps + build_components2(view)[0][:len(EXEC_FAMILIES)]
    return comps, draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))


def build_k7() -> None:
    """K7's generated pieces for both tapes of every component of the fib
    guest's machine v1 and machine2 proofs, built in one batch (one nvcc
    a piece, as many at once as the machine has CPUs, the longest
    first): the seconds, the slowest piece, the CPU seconds of every nvcc, and
    each piece's row operations, table words, nvcc wall and CPU seconds,
    registers and spill bytes (ptxas).  The batch holds the CPU
    component's later segments too (phase machine_segments'), whose
    tapes share the CPU component's sources: ``segment_sources`` counts
    the pieces they would add (none), so no proof builds one."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.air import tape as tp, tape_cuda
    comps, rel = fib_tapes(machine2=True, segments=SEGMENTS)
    t0 = time.perf_counter()
    rec = tp.build_kernels(comps, [PARITY_LOG] * len(comps), rel)
    secs = time.perf_counter() - t0

    def libs(cs):
        return {p.lib for c in cs for fn in (tp.domain_tape, tp.gen_tape)
                for p in tape_cuda.pieces(fn(c, PARITY_LOG, rel))}
    extra = libs(comps[1:SEGMENTS]) - libs(comps[:1])
    pieces = []
    for c in comps[:1] + comps[SEGMENTS:]:
        for kind, fn in (("domain", tp.domain_tape), ("gen", tp.gen_tape)):
            tape = fn(c, PARITY_LOG, rel)
            for i, p in enumerate(tape_cuda.pieces(tape) if tape else []):
                lib = p.lib
                pieces.append({"tape": f"{c.name}/{kind}", "piece": i,
                               "ops": p.n_ops, "live": p.live,
                               "table_words": len(p.table),
                               "nvcc": rec["pieces"].get(lib.name),
                               **kernels.ptxas_summary(lib)})
    emit({"phase": "k7_build", "seconds": secs, "built": rec["built"],
          "slowest_piece_s": rec["slowest_s"], "nvcc_cpu_s": rec["cpu_s"],
          "cpu_count": os.cpu_count(), "segment_sources": len(extra),
          "pieces": pieces})


def time_k7(reps: int = 5) -> None:
    """K7 with the package on the path, on random rows at the fib 2^20
    proof's shapes: the CPU component's composition over its 2^22-row 4x
    domain (the one window [0, N)) and its LogUp operands over 2^20 rows,
    ms each by CUDA events.  It calls the tape module's public functions
    only, so two checkouts' K7 compare in one call."""
    import torch
    from nexus_zkvm_tpu_torch.air import tape as tp
    from nexus_zkvm_tpu_torch.air.component import (component_info,
                                                    domain_halo)
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    comps, rel = fib_tapes()
    cpu = comps[0]
    info = component_info(cpu)
    rng = np.random.default_rng(2030)

    def rand(shape):
        return from_u32(rng.integers(0, P31, shape, dtype=np.uint32),
                        "cuda") if shape[0] else None

    def felt():
        return rng.integers(0, P31, 4).astype(np.uint64)
    dom = tp.domain_tape(cpu, FULL_LOG, rel)
    hneg, hpos = domain_halo(info)
    N = 1 << (FULL_LOG + 2)
    W = N + hneg + hpos
    mats = {tp.MAIN: rand((info.n_main, W)), tp.PRE: rand((info.n_pre, W)),
            tp.INTER: rand((4 * info.n_logup_cols, W)), tp.ISF: rand((1, W))}
    uni, alpha, shift = dom.uniforms(rel, felt()), felt(), felt()
    invv, bucket = rand((N,)), rand((N, 4))
    comp_ms = cuda_ms(lambda: tp.air_eval_composition(
        dom, mats, uni, 0, N, hneg, alpha, shift, invv, bucket), reps)
    del mats, invv, bucket
    gen = tp.gen_tape(cpu, FULL_LOG, rel)
    M = 1 << FULL_LOG
    gmats = {tp.MAIN: rand((info.n_main, M)), tp.PRE: rand((info.n_pre, M)),
             tp.ISF: rand((1, M))}
    guni = gen.uniforms(rel, None)
    ops_ms = cuda_ms(lambda: tp.air_eval_operands(gen, gmats, guni, M), reps)
    del gmats
    torch.cuda.empty_cache()
    emit({"phase": "time_k7", "package": str(Path(tp.__file__).resolve()
                                             .parents[1]),
          "composition_ms": comp_ms, "composition_rows": N,
          "operands_ms": ops_ms, "operand_rows": M})


def time_proofs(phase: str, n: int, runs: int = 3, memory=None):
    """Warm fib proofs at n through LocalProver with the package on the
    path, after a cold one: per run, an unprofiled proof's seconds and
    peak device memory, then a profiled proof's phase times, printed as
    ``phase``.  ``memory``: MemoryConfig fields, None for the package's
    default.  Returns the cold proof's machine components and log
    sizes."""
    import torch
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    kernels.build()
    prover = LocalProver(fib_guest(), memory=memory and T.MemoryConfig(
        **memory))
    public = encode_u32s(n)
    view, proof = prover.prove_with_input(public_input=public)
    comps, log_sizes = build_components(view, 1)[0], proof.stark.log_sizes
    del view, proof
    for i in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prover.prove_with_input(public_input=public)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with profiled() as prof:
            prover.prove_with_input(public_input=public)
        emit({"phase": phase, "package": str(Path(T.__file__)
                                             .resolve().parent),
              "run": i, "n": n, "prove_s": prove_s, "peak_bytes": peak,
              "phase_s": prof.times})
    del prover
    torch.cuda.empty_cache()
    return comps, log_sizes


# `--time-memory`'s routes: resident (no tree streamed), the interaction
# tree streamed alone, or the main and interaction trees streamed, each
# with its CPU component composed in _p passes, chunks of the card's
# memory / 64; and STREAM_FORCED's thresholds (2, 4 and 8 passes at 2^21,
# 2^22 and 2^23)
MEMORY_ROUTES = ("resident_p1", "resident_p2", "resident_p4", "inter_p1",
                 "inter_p2", "streamed_p1", "streamed_p2", "streamed_p4",
                 "stream_forced")


def route_segments(name: str) -> tuple:
    """(route, segment log or None) of a `--time-memory` route name: a
    name ending in ``_s<k>`` proves the execution in 2^k-step segments
    (``default_s22``: the default route, 2^22-step segments)."""
    base, sep, k = name.rpartition("_s")
    return (base, int(k)) if sep and k.isdigit() else (name, None)


def memory_route(name: str, info, log: int, total: int):
    """The MemoryConfig fields of route ``name`` for the fib guest's CPU
    component (``info``) at 2^log rows on a card of ``total`` bytes; None
    for ``default`` (`MemoryConfig.for_device`)."""
    from nexus_zkvm_tpu_torch.prover.stark import _natural_rows
    if name == "default":
        return None
    if name == "stream_forced":
        return dict(STREAM_FORCED)
    kind, passes = name.rsplit("_p", 1)
    main = info.n_main * (4 << (log + 1))
    nat = _natural_rows(info) * (4 << (log + 2))
    return {"stream_commit_bytes": {"resident": 1 << 62, "inter": main,
                                    "streamed": main - 1}[kind],
            "stream_chunk_bytes": total // 64,
            "comp_nat_budget": nat // int(passes)}


def time_memory_route(log: int, name: str, warm: int = 5) -> None:
    """One route of `time_memory` in this process alone: the fib guest at
    2^log steps (a 2^log-row CPU component) through LocalProver under
    route ``name`` (`memory_route`); a name ending in ``_s<k>``
    (`route_segments`) proves it in 2^k-step segments, each its own CPU
    component, through ``machine.prove_machine(..., segment_log=k)``
    after ``LocalProver.trace`` (emulation timed in each proof, as
    ``prove_with_input`` has it); a name starting ``m2_`` proves the
    fib guest at the same n through ``machine2.prove_machine2`` after
    ``LocalProver.trace`` (its largest family, ex_alu, at 2^log rows;
    ``m2_default`` the card's default route, ``m2_stream_forced``
    `machine2_forced`'s, ``m2_p<k>`` `machine2_passes`'; at most 3 warm
    proofs): a cold proof, ``warm``
    warm ones and a profiled one (with each phase's allocated and
    reserved peaks, and the timeline of both at every scope's entry and
    exit), which is then verified; seconds, phase times, the route the
    prover noted, the allocated and reserved peaks of all of them, and
    whether the card ran out of memory (then the proof is not tried
    again)."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.machine import prove_machine
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.machine2 import prove_machine2, verify_machine2
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from nexus_zkvm_tpu_torch.utils.profile import profiled, scope
    kernels.build()
    total = torch.cuda.get_device_properties(0).total_memory
    view, _t = LocalProver(fib_guest(), device="cpu").trace(
        public_input=encode_u32s(FIB_PARITY_N))
    machine2 = name.startswith("m2_")
    if machine2:
        route, seg, warm = name[3:], None, min(warm, 3)
        fields = (None if route == "default" else
                  machine2_passes(view, log, total, int(route[1:]))
                  if route.startswith("p") else machine2_forced(view, log))
    else:
        info = component_info(build_components(view, 1)[0][0])
        route, seg = route_segments(name)
        fields = memory_route(route, info, min(log, seg or log), total)
    prover = LocalProver(fib_guest(),
                         memory=fields and MemoryConfig(**fields))
    public = encode_u32s(FIB_MEMORY_N[log])

    def prove_once():
        if seg is None and not machine2:
            return prover.prove_with_input(public_input=public)
        with scope("emulate"):
            view, trace = prover.trace(public_input=public)
        rec["steps"] = trace.n_steps
        if machine2:
            return view, prove_machine2(view, trace, prover.config,
                                        memory=prover.memory)
        return view, prove_machine(view, trace, prover.config,
                                   segment_log=seg, memory=prover.memory)

    def verify(view, proof):
        if machine2:
            return verify_machine2(view, proof, prover.config)
        return prover.verify(view, proof)
    rec = {"phase": "time_memory", "log_rows": log, "n": FIB_MEMORY_N[log],
           "machine": "machine2" if machine2 else "v1",
           "route": name, "segment_log": seg, "fields": fields,
           "total_memory": total}
    secs, stage, peaks = [], "cold", [0, 0]
    torch.cuda.reset_peak_memory_stats()
    prof = None
    try:
        for i in range(1 + warm):
            stage = "cold" if i == 0 else f"warm {i}"
            t0 = time.perf_counter()
            prove_once()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        stage = "profiled"
        peaks = [torch.cuda.max_memory_allocated(),
                 torch.cuda.max_memory_reserved()]
        with profiled(memory=True) as prof:
            view, proof = prove_once()
            torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        rec.update(oom=True, oom_in=stage, error=str(e).splitlines()[0])
    else:
        notes = prof.notes
        rec.update(
            oom=False, prove_cold_s=secs[0],
            prove_s=float(np.median(secs[1:])), prove_warm_s=secs[1:],
            memory=notes["memory"], streamed=notes["streamed"],
            composition_passes=max(notes["composition_passes"]),
            cache_released=notes.get("cache_released"),
            unsplit_blocks=notes.get("unsplit_blocks"),
            log_sizes=proof.stark.log_sizes,
            cpu_components=None if machine2 else len(proof.stark.log_sizes)
            - len(build_components(view, 1)[0]) + 1,
            proof_blake2s=proof_digest(proof_to_bytes(proof)),
            phase_s=prof.times)
    # the profiled proof resets the peaks at each phase
    rec.update(
        peak_bytes=max(peaks[0], torch.cuda.max_memory_allocated(),
                       *(prof.peaks.values() if prof else [])),
        peak_reserved_bytes=max(peaks[1], torch.cuda.max_memory_reserved(),
                                *(prof.reserved.values() if prof else [])),
        phase_peak_bytes=prof and prof.peaks,
        phase_reserved_bytes=prof and prof.reserved,
        # the profiled proof's scope boundaries: (scope, edge, GB
        # allocated and reserved then, the most of each since the last)
        memory_events_gb=prof and [
            (path, edge, *(round(b / 1e9, 3) for b in v))
            for path, edge, *v in getattr(prof, "events", ())])
    rec["reserved_share"] = rec["peak_reserved_bytes"] / total
    if not rec["oom"]:
        rec["verified"] = bool(verify(view, proof))
    import resource
    rec["host_peak_rss_bytes"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    emit(rec)


# `--time-memory`'s segmented runs: fib at 2^24 steps in 2^21-, 2^22- and
# 2^23-step segments by the default route and STREAM_FORCED's, and at
# 2^25 steps in 2^22-step segments by the default route
SEGMENTED_ROUTES = tuple((24, f"{r}_s{k}") for k in (21, 22, 23)
                         for r in ("default", "stream_forced")) + (
                             (25, "default_s22"),)
# `--time-memory`'s machine2 runs: the fib guest with its largest family,
# ex_alu, at 2^21-2^23 rows by the card's default route and
# `machine2_forced`'s, and at 16,777,200 steps (ex_alu at 2^24) in one
# proof by the default route
MACHINE2_ROUTES = tuple((log, f"m2_{r}") for log in (21, 22, 23)
                        for r in ("default", "stream_forced")) + (
                            (24, "m2_default"),)


def _default_route(name: str) -> bool:
    """Whether a `--time-memory` route is the card's default one."""
    return route_segments(name)[0] in ("default", "m2_default")


def time_memory(runs=None, logs=(21, 22, 23), largest: int = 24,
                opts: dict = None) -> int:
    """The memory mode's routes measured on this card: for each 2^log-row
    CPU component of the fib guest, every route of MEMORY_ROUTES, each in
    a fresh process (`time_memory_route`: cold and warm seconds, c:lde,
    quotients, openings, the allocated and reserved peaks, out of memory
    or not); 2^largest rows by the default route; then the segmented
    runs of SEGMENTED_ROUTES.  The proofs of one (size, segment log)
    must be byte-equal.  Then the fastest route at each size whose
    reserved peak stays within FIT_SHARE of the card's memory, the
    largest size proved as one component and the largest proved in
    segments (``time_memory_fit``); then machine2's runs of
    MACHINE2_ROUTES (kept apart: their own digests, fits and largest
    size).  ``runs``: only these (log, route) pairs, in order; ``opts``:
    ``package``, another checkout's package measured in this one's
    place, and ``warm``, the warm proofs a route.  Returns 1 when a
    default route proved but reserved more than FIT_SHARE of the card
    (``time_memory_over_fit``), else 0."""
    from nexus_zkvm_tpu_torch import kernels
    kernels.build()
    build_k7()
    fits, digests, proved, by_segments = {}, {}, set(), set()
    over = []
    extra = [a for k, v in (opts or {}).items() for a in (f"--{k}", v)]

    def run(log, name):
        try:
            r = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--time-memory-route", *extra, str(log), name],
                capture_output=True, text=True, timeout=900, cwd=ROOT)
        except subprocess.TimeoutExpired:
            emit({"phase": "time_memory", "log_rows": log, "route": name,
                  "timeout_s": 900})
            return None
        recs = [json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith("{")]
        if r.returncode or not recs:
            emit({"phase": "time_memory", "log_rows": log, "route": name,
                  "rc": r.returncode, "stderr": r.stderr[-3000:]})
            return None
        print(json.dumps(recs[-1]), flush=True)
        return recs[-1]
    m2_proved = set()
    for log, name in runs or [(log, name) for log in logs
                              for name in MEMORY_ROUTES] + [
                                  (largest, "default"),
                                  *SEGMENTED_ROUTES, *MACHINE2_ROUTES]:
        rec = run(log, name)
        if rec is None or rec["oom"]:
            continue
        m2 = name.startswith("m2_")
        seg = None if m2 else route_segments(name)[1]
        digests.setdefault((m2, log, seg), set()).add(rec["proof_blake2s"])
        if not rec["verified"]:
            raise RuntimeError(f"2^{log} {name}: the proof does not "
                               f"verify")
        if m2:
            m2_proved.add(log)
        elif seg is None:
            proved.add(log)
        else:
            by_segments.add(rec["steps"])
        key = f"m2_{log}" if m2 else log if seg is None else \
            f"{log}_s{seg}"
        if rec["reserved_share"] <= FIT_SHARE and (
                key not in fits or rec["prove_s"] < fits[key][1]):
            fits[key] = (name, rec["prove_s"], rec["reserved_share"])
        if rec["reserved_share"] > FIT_SHARE and _default_route(name):
            over.append((log, name, rec["reserved_share"]))
    emit({"phase": "time_memory_fit", "fit_share": FIT_SHARE,
          "fastest_fitting": {str(k): v for k, v in fits.items()},
          "largest_log_rows_proved": max(proved) if proved else None,
          "largest_steps_proved_by_segments":
          max(by_segments) if by_segments else None,
          "largest_machine2_log_rows_proved":
          max(m2_proved) if m2_proved else None})
    bad = [k for k, d in digests.items() if len(d) > 1]
    if bad:
        raise RuntimeError(f"routes gave different proofs at (machine2, "
                           f"2^log, segment log) {bad}")
    if over:
        # a default route must hold its reserved peak within the fit
        emit({"phase": "time_memory_over_fit", "fit_share": FIT_SHARE,
              "routes": over})
        return 1
    return 0


def time_stream_kernels(comps, log_sizes, reps: int = 20) -> None:
    """K10 and K11 with the package on the path, on random inputs at the
    2^22 proof's shapes (a 16-column chunk of 2^23 rows; K11 with that
    size group's coefficients), each launched in place on one buffer, ms
    by CUDA events.  It calls the ops modules' public functions only, so
    two checkouts' kernels compare in one call."""
    import torch
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.ops import blake2s, quotients
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    rng = np.random.default_rng(2031)
    k11 = stream_k11_inputs(comps, log_sizes, rng)
    M, c, C = 1 << k11["s"], 16, component_info(comps[0]).n_main
    gcs = np.ascontiguousarray(k11["prep"]["gcs"][:, k11["k0"]:k11["k0"] + c])
    S = len(gcs)
    chunk = from_u32(rng.integers(0, P31, (c, M), dtype=np.uint32), "cuda")
    state = from_u32(rng.integers(0, 1 << 32, (M, 8), dtype=np.uint32),
                     "cuda")
    k10_ms = cuda_ms(lambda: blake2s.leaves_stream(state, chunk, c, C, False),
                     reps)
    del state
    acc = from_u32(rng.integers(0, P31, (S, M, 4), dtype=np.uint32), "cuda")
    g = from_u32(gcs, "cuda")
    k11_ms = cuda_ms(lambda: quotients.colsum_fold(acc, chunk, g, True), reps)
    del acc, chunk
    torch.cuda.empty_cache()
    emit({"phase": "time_stream_kernels",
          "package": str(Path(blake2s.__file__).resolve().parents[1]),
          "blake2s_leaves_stream_ms": k10_ms, "k10_shape": [c, M],
          "quotient_colsums_ms": k11_ms, "k11_shape": [S, c, M]})


def record_timing_calls(n: int, memory=None) -> dict:
    """One fib proof at n with the package on the path, keeping the
    calls of K6 (`logup_columns`), K8 (whichever entry that package's
    prover calls: ``oods_dot_groups``, or ``oods_dot`` a gathered
    group), K3 (`accumulate_blocks`), K12 (`colsum_finalize`) and K9
    (`decommit_many_fused`, and the first `gather_columns` call of the
    memory mode's streamed chunks, with their count): {"logup", "oods",
    "quotients", "finalize", "openings", "chunks": [args], "k8": entry,
    "n_chunks": count}.  ``memory`` as for `time_proofs`."""
    from nexus_zkvm_tpu_torch.air import tape
    from nexus_zkvm_tpu_torch.ops import merkle, quotients
    from nexus_zkvm_tpu_torch.prover import MemoryConfig, stark
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    k8 = "oods_dot_groups" if hasattr(stark, "oods_dot_groups") else \
        "oods_dot"
    calls = {"logup": [], "oods": [], "quotients": [], "finalize": [],
             "openings": [], "chunks": [], "k8": k8, "n_chunks": 0}
    saved = [(mod, fn, key, getattr(mod, fn)) for mod, fn, key in (
        (tape, "logup_columns", "logup"), (stark, k8, "oods"),
        (quotients, "accumulate_blocks", "quotients"),
        (quotients, "colsum_finalize", "finalize"),
        (merkle, "decommit_many_fused", "openings"),
        (merkle, "gather_columns", "chunks"))]
    for mod, fn, key, orig in saved:
        def wrapped(*args, _orig=orig, _key=key):
            # one chunk's (16, 2^23) evaluations kept, not all of them
            if _key != "chunks" or not calls[_key]:
                calls[_key].append(args)
            calls["n_chunks"] += _key == "chunks"
            return _orig(*args)
        setattr(mod, fn, wrapped)
    try:
        LocalProver(fib_guest(), memory=memory and MemoryConfig(
            **memory)).prove_with_input(public_input=encode_u32s(n))
    finally:
        for mod, fn, _key, orig in saved:
            setattr(mod, fn, orig)
    return calls


def time_k6_k8(calls: dict, n: int, reps: int = 5) -> None:
    """K6 and K8 with the package on the path, on the calls of one fib
    proof at n (`record_timing_calls`): the largest LogUp launch and all
    of the proof's in turn; the largest OODS group and every group of
    the proof, as that package issues them (one launch of
    ``oods_dot_groups``, or one ``oods_dot`` a gathered group).  ms by
    CUDA events; the calls' inputs are the proof's own."""
    from nexus_zkvm_tpu_torch.air import tape
    from nexus_zkvm_tpu_torch.prover import stark
    lg = sorted(calls["logup"], key=lambda a: -a[2])
    k6 = tape.logup_columns
    rec = {"phase": "time_k6_k8", "package": str(Path(stark.__file__)
                                                .resolve().parents[1]),
           "n": n, "logup_shape": [int(lg[0][1].shape[1]), lg[0][2]],
           "logup_ms": cuda_ms(lambda: k6(*lg[0]), reps),
           "logup_launches": len(lg),
           "logup_all_ms": cuda_ms(lambda: [k6(*a) for a in lg], reps)}
    if calls["k8"] == "oods_dot_groups":
        (groups,), = calls["oods"]
        big = max(groups, key=lambda g: (g[0].shape[0] if g[1] is None
                                         else len(g[1])) * g[0].shape[1])
        rec.update(oods_shape=[int(big[0].shape[0]) if big[1] is None
                               else len(big[1]), int(big[0].shape[1])],
                   oods_ms=cuda_ms(lambda: stark.oods_dot_groups([big]),
                                   reps),
                   oods_groups=len(groups),
                   oods_all_ms=cuda_ms(lambda: stark.oods_dot_groups(groups),
                                       reps))
    else:
        groups = calls["oods"]
        big = max(groups, key=lambda g: g[0].numel())
        rec.update(oods_shape=list(big[0].shape),
                   oods_ms=cuda_ms(lambda: stark.oods_dot(*big), reps),
                   oods_groups=len(groups),
                   oods_all_ms=cuda_ms(lambda: [stark.oods_dot(*g)
                                                for g in groups], reps))
    emit(rec)


def time_k3_k12(calls: dict, n: int, reps: int = 5) -> None:
    """K3 and K12 with the package on the path, on the calls of one fib
    proof at n (`record_timing_calls`): K3 on the largest size group and
    on all of the proof's groups in turn, K12 on the proof's own calls
    (the memory mode's streamed groups; none in a resident proof).  ms
    by CUDA events."""
    from nexus_zkvm_tpu_torch.ops import quotients
    qs = sorted(calls["quotients"],
                key=lambda a: -int(a[4].shape[1]) * int(a[1].shape[0]))
    k3 = quotients.accumulate_blocks
    rec = {"phase": "time_k3_k12", "package": str(Path(quotients.__file__)
                                                 .resolve().parents[1]),
           "n": n, "quotients_shape": [int(x) for x in (
               qs[0][4].shape[0], qs[0][4].shape[1], qs[0][1].shape[0])],
           "quotients_ms": cuda_ms(lambda: k3(*qs[0]), reps),
           "quotients_launches": len(qs),
           "quotients_all_ms": cuda_ms(lambda: [k3(*a) for a in qs], reps),
           "finalize": [{"shape": list(a[0].shape[:2]), "ms": cuda_ms(
               lambda: quotients.colsum_finalize(*a), reps)}
               for a in calls["finalize"]]}
    emit(rec)


def time_k9(calls: dict, n: int, reps: int = 20) -> None:
    """K9 with the package on the path, on the calls of one fib proof at
    n (`record_timing_calls`): the proof's one opening gather, its
    tables built once and the launch timed queued (the card's time);
    the host ms (median of ``reps``, each synchronized) of building
    those tables and of the whole `decommit_many_fused` call as the
    prover makes it; in the memory mode the first streamed chunk's
    gather, queued and not, and the count of such calls.  Both
    checkouts' wrappers take these calls: two can be compared in one
    call."""
    import torch
    from nexus_zkvm_tpu_torch.ops import merkle
    (args,) = calls["openings"]
    items = args[0]
    pieces = [p for item in items for part in merkle._pieces(*item)
              for p in part]
    if hasattr(merkle, "place"):     # pieces carry their own offsets
        merkle.place(pieces)
    tables = merkle.gather_tables(pieces)

    def median_ms(fn):
        return float(np.median([host_ms(fn) for _ in range(reps)]))
    rec = {"phase": "time_k9", "package": str(Path(merkle.__file__)
                                             .resolve().parents[1]),
           "n": n, "pieces": len(pieces),
           "words": sum(p.words for p in pieces),
           "launch_ms": cuda_ms(lambda: merkle.gather_launch(*tables), reps,
                                True),
           "tables_host_ms": median_ms(lambda: merkle.gather_tables(pieces)),
           "decommit_host_ms": median_ms(
               lambda: merkle.decommit_many_fused(items)),
           "chunk_calls": calls["n_chunks"]}
    if calls["chunks"]:
        (chunk,) = calls["chunks"]
        rec.update(chunk_shape=[*map(int, chunk[0].shape), len(chunk[1])],
                   chunk_ms=cuda_ms(lambda: merkle.gather_columns(*chunk),
                                    reps, True),
                   chunk_host_ms=cuda_ms(
                       lambda: merkle.gather_columns(*chunk), reps))
    emit(rec)


def time_mesh() -> None:
    """Phase 8's gloo mesh proofs with the package on the path, through
    the rank programs of its own checkout (tests/torch_mesh.py): the fib
    guest at a 2^20-row CPU component on 2 ranks sharing the card and
    at a 2^19-row one on MESH_RANKS (each rank a cold proof, then the
    warm one timed, no kernel checks): every rank's cold and warm
    seconds and peak device memory, in all and by phase, rank 0's
    phases (of the cold proof too) and the proof's digest (what the
    checkout's rank program does not report is null)."""
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.sdk import encode_u32s
    kernels.build()
    checkout = Path(T.__file__).resolve().parents[1]
    tm = mesh_helpers(checkout)
    src = (ROOT / "examples" / "guests" / "fib.s").read_text()
    _single_proof(tm, src, FIB_PARITY_N)     # K7's pieces, built once
    for ranks, n in ((2, FIB_N), (MESH_RANKS, FIB_MESH4_N)):
        recs = tm.spawn(tm.mesh_machine_rank, ranks, src, encode_u32s(n),
                        "cuda", None, True, False, backend="gloo",
                        device="cuda", timeout=300)
        emit({"phase": "time_mesh", "package": str(checkout),
              "ranks": ranks, "n": n,
              **{k: [r.get(k) for r in recs] for k in (
                  "prove_cold_s", "prove_s", "peak_bytes",
                  "phase_peak_bytes")},
              "proof_blake2s": recs[0]["proof_blake2s"],
              "phase_s": recs[0]["phase_s"],
              "cold_phase_s": recs[0].get("cold_phase_s")})


def _check_fit(where: str, recs, total: int) -> list:
    """Each rank's reserved peak, of its cold and its warm proof, within
    FIT_SHARE of its card's ``total`` bytes; returns the shares."""
    shares = []
    for rec in recs:
        reserved = max(rec["reserved_bytes"], rec["cold_reserved_bytes"])
        shares.append(reserved / total)
        if reserved > FIT_SHARE * total:
            raise RuntimeError(f"{where}/rank{rec['rank']}: reserved "
                               f"{reserved} bytes, over {FIT_SHARE} of the "
                               f"card's {total}")
    return shares


def mesh_nccl() -> None:
    """The prover over NCCL, a rank a card.  The fib guest at a 2^20-row
    CPU component on 4 ranks (with four cards or more) and then on 2:
    every rank's proof byte-equal to one fresh process's
    (`_single_proof`, which sets the peak each rank is held to),
    verified, nothing streamed, its trees in windows, every kernel of
    the resident path launched, rank 0's kernel calls equal to their
    plain versions at its shapes (`_check_mesh_machine`).  Then, with
    four cards, the JAX package's 2^24 mesh configuration, fib at
    FIB_SEGMENTS_N (16,777,200 steps) on 4 ranks, each a cold proof and
    a warm one, every rank's reserved peak within FIT_SHARE of its card:
    (i) in four 2^SEGMENT_LOG-step segments, byte-equal to one fresh
    process's proof of the same on one card (what phase
    ``machine_segments`` proves), its prove seconds beside the ranks';
    (ii) as one 2^24-row CPU component, which one card cannot hold: no
    single proof to compare with, so every rank verifies, the ranks'
    digests agree, a tampered opening and another program's claim are
    rejected, and each rank holds its window of 2^25/4 rows of the main
    group.  The one NCCL check of the script: the default run, on one
    card, has no NCCL mesh."""
    import torch
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.air.tape import gen_tape
    from nexus_zkvm_tpu_torch.sdk import encode_u32s
    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"{cards} card: NCCL needs a card for each rank")
    kernels.build()
    tm = mesh_helpers()
    comps, rel = fib_tapes()
    halo = gen_tape(comps[0], PARITY_LOG, rel).halo()
    del comps, rel
    src = (ROOT / "examples" / "guests" / "fib.s").read_text()
    single = _single_proof(tm, src, FIB_N)
    emit({"phase": "parallel_single", "2^20": {k: single[k] for k in (
        "peak_bytes", "prove_s", "prove_cold_s", "proof_blake2s")}})
    expected = set(kernels.launch_counts()) - set(MEMORY_MODE)
    for ranks in ([4, 2] if cards >= 4 else [2]):
        recs = tm.spawn(tm.mesh_machine_rank, ranks, src, encode_u32s(FIB_N),
                        "cuda", None, True, True, backend="nccl",
                        device="cuda", timeout=300)
        _check_mesh_machine(f"parallel/nccl{ranks}", FIB_N, recs,
                            single["proof_blake2s"], [FULL_LOG], expected,
                            single["peak_bytes"], halo)
    if cards < 4:
        emit({"phase": "parallel_nccl_2^24", "cards": cards,
              "skipped": "the 2^24 configuration needs four cards"})
        return
    total = torch.cuda.get_device_properties(0).total_memory
    public = encode_u32s(FIB_SEGMENTS_N)
    seg = _single_proof(tm, src, FIB_SEGMENTS_N, SEGMENT_LOG, timeout=900)
    _check_fit("parallel_single/segments", [seg], total)
    emit({"phase": "parallel_single", "segments": {
        "n": FIB_SEGMENTS_N, "segment_log": SEGMENT_LOG, **{
            k: seg[k] for k in ("log_sizes", "peak_bytes", "reserved_bytes",
                                "cold_peak_bytes", "cold_reserved_bytes",
                                "phase_peak_bytes", "phase_reserved_bytes",
                                "prove_s", "prove_cold_s", "phase_s",
                                "verify_s", "proof_blake2s")}}})
    for name, segment_log, digest in (("segments", SEGMENT_LOG,
                                       seg["proof_blake2s"]),
                                      ("rows", None, None)):
        t0 = time.perf_counter()
        recs = tm.spawn(tm.mesh_machine_rank, 4, src, public, "cuda", None,
                        True, False, False, segment_log, segment_log is None,
                        backend="nccl", device="cuda", timeout=900)
        wall = time.perf_counter() - t0
        path = f"parallel/nccl4/2^24-{name}"
        if digest is None:
            # one card cannot hold the proof: the ranks agree, verify,
            # and reject a tampered opening and another claim
            digest = recs[0]["proof_blake2s"]
        shares = _check_fit(path, recs, total)
        cpu_logs = ([SEGMENT_LOG] * SEGMENTS if segment_log else
                    [SEGMENT_LOG + 2])
        _check_mesh_machine(path, FIB_SEGMENTS_N, recs, digest, cpu_logs,
                            expected, None, halo, "parallel_nccl_2^24",
                            kernels_held=False)
        emit({"phase": "parallel_nccl_2^24", "path": path,
              "proof_blake2s": digest, "spawn_wall_s": wall,
              "reserved_share": shares, "total_memory": total,
              "single_process": ({k: seg[k] for k in (
                  "prove_s", "prove_cold_s", "peak_bytes",
                  "reserved_bytes")} if segment_log else None),
              "tampered_rejected": segment_log is None})


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
    timing = sys.argv[1] if sys.argv[1:2] in (
        ["--time-machine"], ["--time-stream"], ["--time-mesh"]) else None
    if timing and len(sys.argv) > 2:
        # another checkout's package, imported in its place
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    memory_opts = {}
    if sys.argv[1:2] in (["--time-memory"], ["--time-memory-route"]):
        # --package DIR: that checkout's package in this one's place;
        # --warm K: K warm proofs a route
        args = sys.argv[2:]
        while args[:1] in (["--package"], ["--warm"]):
            memory_opts[args[0][2:]] = args[1]
            args = args[2:]
        sys.argv[2:] = args
        if "package" in memory_opts:
            sys.path.insert(0, str(Path(memory_opts["package"]).resolve()))
    try:
        from nexus_zkvm_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    card = gpu_name_and_limit()
    print(card, flush=True)
    if sys.argv[1:2] == ["--segments-cpu"]:
        segments_cpu(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--time-memory-route"]:
        time_memory_route(int(sys.argv[2]), sys.argv[3],
                          int(memory_opts.get("warm", 5)))
        return 0
    if sys.argv[1:2] == ["--time-memory"]:
        # optional LOG:ROUTE arguments: only those runs
        return time_memory([(int(a.split(":")[0]), a.split(":")[1])
                            for a in sys.argv[2:]] or None,
                           opts=memory_opts)
    if sys.argv[1:] == ["--mesh-nccl"]:
        mesh_nccl()
        return 0
    if timing == "--time-mesh":
        time_mesh()
        return 0
    if timing == "--time-machine":
        # fib 2^20 (resident), then K7 at that proof's shapes
        time_proofs("time_machine", FIB_N)
        time_k7()
        n, memory = FIB_N, None
    elif timing == "--time-stream":
        # fib 2^22 in the forced memory mode (the package of a checkout
        # without `MemoryConfig.for_device` too), then K10 and K11 at its
        # shapes
        memory = STREAM_FORCED
        time_stream_kernels(*time_proofs("time_stream", FIB_STREAM_N,
                                         memory=memory))
        n = FIB_STREAM_N
    if timing:
        # then K6, K8, K3, K12 and K9 on one more proof's own calls
        calls = record_timing_calls(n, memory)
        time_k6_k8(calls, n)
        time_k3_k12(calls, n)
        time_k9(calls, n)
        return 0
    t0 = time.perf_counter()

    def wall(after: str) -> None:
        # the script's seconds so far, against its 1200 s limit
        emit({"phase": "wall", "after": after,
              "s": time.perf_counter() - t0})
    kernels.build()
    ptxas = {}
    for src in sorted({s for s, _f, _a in kernels.KERNELS.values()}):
        f = kernels._lib_path(src).with_suffix(".ptxas.txt")
        ptxas[src] = [ln.strip() for ln in f.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "gpu": card, "ptxas": ptxas})
    build_k7()
    wall("k7_build")

    timed = check_kernels(full=True)
    comps = make_components()
    phase_parity(comps)
    phase_slice(comps)
    wall("slice")
    launches, fib_digest, machine_rec = phase_machine()
    wall("machine")
    phase_machine_parity()
    phase_keccak_parity()
    phase_selftest()
    wall("selftest")
    m2_launches, m2_digest = phase_machine2(machine_rec)
    m2_expected = {k for k, v in m2_launches.items() if v} - \
        set(MEMORY_MODE)
    wall("machine2")
    phase_machine2_parity()
    wall("machine2_parity")
    m2_large = phase_machine2_large()
    wall("machine2_large")
    phase_cli()
    wall("cli")
    stream_launches, stream_comps, stream_logs, stream_digest = \
        phase_machine_stream()
    phase_machine_large(stream_digest)
    wall("machine_large")
    seg_launches = phase_machine_segments()
    wall("machine_segments")
    phase_stream_parity()
    timed.update(check_stream_kernels(stream_comps, stream_logs))
    del stream_comps
    wall("stream")
    phase_parallel(fib_digest, m2_digest, m2_expected)
    wall("parallel")

    names = list(kernels.launch_counts())
    unused = [k for k in names if not launches[k] and not stream_launches[k]]
    if unused:
        raise RuntimeError(f"kernels launched on no path: {unused}")
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"nexus_zkvm_tpu_torch/csrc/{REPLACES[name][0]}",
        "replaces": REPLACES[name][1],
        "launches": (stream_launches if name in MEMORY_MODE
                     else launches)[name],
        "path": "machine_stream" if name in MEMORY_MODE else "machine",
        "machine2_launches": m2_launches[name],
        "machine2_large_launches": m2_large["default"][name],
        "machine2_forced_launches": m2_large["forced"][name],
        "segments_launches": seg_launches[name],
        "max_abs_err": timed[name]["max_abs_err"], "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": timed[name].get("library_ms"),
        "shape": timed[name]["shape"],
        **{k: timed[name][k] for k in ("library_note", "units")
           if k in timed[name]},
        **({"extend": {k: timed["circle_fft_extend"][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}} if name == "circle_fft" else {}),
        **({"all_groups": {k: timed["oods_dot_all"][k] for k in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}} if name == "oods_dot" else {}),
        **({"streamed_chunk": {
            "launches": stream_launches[name], "path": "machine_stream",
            **{k: timed["gather_openings_stream"][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_call", "host_ms",
                "library_host_ms", "calls_checked")}}}
           if name == "gather_openings" else {})}
        for name in names]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
