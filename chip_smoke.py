#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. build   — compile every CUDA source of ``nexus_zkvm_tpu_torch/csrc``
             with nvcc for sm_90a; print the card's name and power limit.
2. kernel  — every kernel against its plain PyTorch version on the same
             CUDA tensors (uint32 equality), with its time, the plain
             version's time and the bound the card sets for the work.
3. parity  — a proof at 2^10 rows on the CPU (plain path) and on the
             card (kernels) must be equal field by field.
4. slice   — the prover core at the size of a fib 2^20 proof: one
             component of 64 squares (192 main columns, 128 constraints,
             64 LogUp fractions) at 2^20 rows and its lookup table at 2^4,
             default PcsConfig; prove, verify, reject a tampered proof;
             every kernel must have been launched.
5. kernels — one JSON line with every kernel's numbers.

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

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
MUL, ADD = 6, 3
COMPRESS = 80 * 12 + 8
QM31_MUL = 16 * MUL + 14 * ADD
QM31_INV = 57 * MUL + 20 * ADD

K_SQUARES = 64
FULL_LOG = 20
TABLE_LOG = 4
PARITY_LOG = 10


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
}


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
    err = max_abs_err(got, want)
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"{name} {shape}: kernel and plain version "
                           f"differ (max abs err {err})")
    rec = {"phase": "kernel", "name": name, "shape": shape, "equal": True,
           "max_abs_err": err}
    if timed:
        b_ms, b_by = bound(nbytes, ops)
        rec.update(ms=cuda_ms(kernel_fn, reps),
                   plain_ms=cuda_ms(plain_fn, plain_reps),
                   bound_ms=b_ms, bound_by=b_by)
    emit(rec)
    return rec


def check_kernels(full: bool = True) -> dict:
    """Every kernel at small shapes and (``full``) at the shapes of the
    2^20 slice.  Returns {kernel name: timed record}."""
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

    def keep(rec):
        if "ms" in rec:
            timed[rec["name"]] = rec

    # K1 --------------------------------------------------------------------
    for n in (4, 10, 21) if full else (4, 10):
        for C in (1, 192):
            x = rand((C, 1 << n))
            main_shape = full and n == 21 and C == 192
            butterflies = C * n * (1 << (n - 1))
            nbytes = 2 * 4 * C * (1 << n) + 4 * (1 << n)
            keep(check("circle_ifft", [C, 1 << n],
                       lambda: cfft.interpolate(x),
                       lambda: cfft.interpolate_plain(x), nbytes,
                       butterflies * (2 * ADD + MUL) + C * (1 << n) * MUL,
                       main_shape))
            keep(check("circle_fft", [C, 1 << n], lambda: cfft.evaluate(x),
                       lambda: cfft.evaluate_plain(x), nbytes,
                       butterflies * (2 * ADD + MUL), main_shape))
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
    keep(check("blake2s_messages", [R, 192],
               lambda: blake2s.hash_rows(mat.t()),
               lambda: blake2s.hash_rows_plain(mat.t()),
               4 * 192 * R + 32 * R, R * 12 * COMPRESS, full, reps=5))
    del mat
    keep(check("blake2s_parents", [R, 8], lambda: blake2s.hash_parents(leaves),
               lambda: blake2s.hash_rows_plain(leaves.reshape(-1, 16)),
               32 * R + 16 * R, (R // 2) * COMPRESS, full))
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
    nnz = int((gcs.reshape(3, K, 4) != 0).any(axis=2).sum())
    keep(check("deep_quotients", [K, M],
               lambda: quotients.accumulate_blocks(blocks, xs, ys, consts,
                                                   gcs_t),
               lambda: quotients.accumulate_blocks_plain(blocks, xs, ys,
                                                         consts, gcs_t),
               4 * K * M + 8 * M + 16 * M,
               M * (nnz * 4 * (MUL + 2) + 3 * (3 * QM31_MUL + QM31_INV)),
               full, reps=5))
    del blocks
    # K4: the first circle fold of the slice (2^23 -> 2^22) and a landing
    # fold with injection -------------------------------------------------------
    s0 = 23 if full else 9
    v = rand((1 << s0, 4))
    tw = fri.dev_circle_fold_twiddles(s0, dev)
    alpha = rng.integers(0, P, 4).astype(np.uint64)
    L = 1 << (s0 - 1)
    keep(check("fri_fold", [1 << s0, 4], lambda: fri.fold(v, alpha, tw),
               lambda: fri.fold_plain(v, alpha, tw), L * 52,
               L * (QM31_MUL + 4 * MUL + 12 * ADD), full))
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
    return timed


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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    emit({"phase": "slice", "log_rows": log_n, "main_columns": 3 * K_SQUARES,
          "constraints": 2 * K_SQUARES, "lookup_fractions": K_SQUARES,
          "verified": True, "tampered_rejected": True,
          "prove_s": prove_s, "prove_cold_s": cold_s, "verify_s": verify_s,
          "rows_per_s": (1 << log_n) / prove_s, "peak_bytes": peak,
          "phase_s": prof.times, "launches": launches})
    return launches


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
    launches = phase_slice(comps)

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
