"""Ranks of one machine as processes, and the programs they run.

    results = spawn(fn, nprocs, *args, backend="gloo", device="cpu")

starts ``nprocs`` processes with ``torch.multiprocessing`` (the spawn
method), joins each to a process group through the port's environment
contract (``NZT_COORDINATOR`` on a free localhost port,
``NZT_NUM_PROCESSES``, ``NZT_PROCESS_ID``; ``init_distributed``) and
returns ``fn(make_mesh(), *args)`` of every rank, in rank order (one
rank alone joins no group: its mesh is the local mesh).  ``fn``
and its arguments must be picklable; results travel pickled.  A rank
that raises ends the call with its traceback, and the other ranks are
stopped.  CPU ranks run one thread each.

The rank programs below are the mesh checks of
tests/test_torch_parallel.py, tests/test_torch_cuda.py and
chip_smoke.py's ``parallel`` phase; nothing here imports JAX.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

P31 = (1 << 31) - 1
K1K2 = ("circle_ifft", "circle_fft", "blake2s_messages", "blake2s_parents")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs: int, *args, backend: str | None = None,
          device="cuda", timeout: float = 900.0) -> list:
    env = {"NZT_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "NZT_NUM_PROCESSES": str(nprocs)}
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank, (env, backend, str(device), results, fn,
                                     args), nprocs=nprocs, join=False,
                             start_method="spawn")
    got, deadline = {}, time.monotonic() + timeout
    try:
        while True:
            done = ctx.join(timeout=0.1)   # raises when a rank failed
            while not results.empty():     # a rank blocks until it is read
                r, blob = results.get()
                got[r] = pickle.loads(blob)
            if done:
                return [got[r] for r in range(nprocs)]
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {nprocs} ranks passed "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _rank(r: int, env: dict, backend, device: str, results, fn, args):
    from nexus_zkvm_tpu_torch.parallel import init_distributed, make_mesh
    os.environ.update(env, NZT_PROCESS_ID=str(r))
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(backend=backend, device=device)
    out = fn(make_mesh(), *args)
    results.put((r, pickle.dumps(out)))
    if dist.is_initialized():          # one rank alone joins no group
        dist.destroy_process_group()


def checks_rank(mesh, checks) -> list:
    """Run ``checks``, [(rank program, its arguments)], in one process:
    their results in order."""
    return [fn(mesh, *args) for fn, args in checks]


def proof_digest(blob: bytes) -> str:
    return hashlib.blake2s(blob).hexdigest()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_columns(spec, device):
    """Columns that are the same on every rank: a numpy (C, N) uint32
    array as it is, or for (C, log N, seed) draws from the seed on
    ``device``."""
    from nexus_zkvm_tpu_torch.utils.device import from_u32
    if isinstance(spec, np.ndarray):
        return from_u32(spec, device)
    C, log_n, seed = spec
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, P31, (C, 1 << log_n), generator=gen,
                         device=device, dtype=torch.int32)


def mesh_commit_rank(mesh, spec, trace_log: int, log_blowup: int,
                     keep_evals: bool = False) -> dict:
    """``sharded_commit_columns`` on this rank (the whole evaluations and
    the root), then the prover's windowed commit of the same columns
    (``parallel.commit.commit_group``, when the rows split): one
    untimed run, then a profiled one with its launch counts (set to 0
    just before it) and its steps' ms: the local K1 LDE, the exchange
    (the all_to_all and the subtree roots' gather), the K2 leaves and
    the K2 climb.  Then, when the natural rows split too, the same
    from the rank's natural row window (``commit_windows``, as the
    interaction is committed: step 0's all_to_all first, timed as
    ``mesh_exchange/mesh_share``): its root, ms and steps' ms
    (``windows_*``).  ``keep_evals``: the committed evaluations, and
    those of ``sharded_lde``, come back too."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.parallel import sharded_commit_columns
    from nexus_zkvm_tpu_torch.parallel import commit as pcommit
    from nexus_zkvm_tpu_torch.parallel.commit import sharded_lde
    from nexus_zkvm_tpu_torch.utils.device import to_u32
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    cols = mesh_columns(spec, mesh.device)
    s = trace_log + log_blowup
    ev, root = sharded_commit_columns(mesh, cols, trace_log, log_blowup)

    def windowed():
        return pcommit.commit_group(mesh, cols, trace_log, s)
    run = windowed if pcommit.shards_rows(mesh, 1 << s) else \
        (lambda: sharded_commit_columns(mesh, cols, trace_log, log_blowup))
    run()
    _sync(cols.device)
    kernels.reset_launches()
    with profiled() as prof:
        t0 = time.perf_counter()
        got = run()
        _sync(cols.device)
        ms = (time.perf_counter() - t0) * 1e3
    window_root_equal = bool(np.array_equal(
        (got[2].root() if run is windowed else got[1]), root))
    launches = kernels.launch_counts()
    del got
    win = {}
    if pcommit.shards_rows(mesh, 1 << trace_log):
        lo, hi = pcommit.window(mesh, 1 << trace_log)

        def from_window():
            return pcommit.commit_windows(
                mesh, [cols[:, lo:hi].contiguous()], trace_log, s)
        from_window()
        _sync(cols.device)
        with profiled() as wprof:
            t0 = time.perf_counter()
            got = from_window()
            _sync(cols.device)
            win_ms = (time.perf_counter() - t0) * 1e3
        win = {"windows_root_equal": bool(np.array_equal(got[2].root(),
                                                         root)),
               "windows_ms": win_ms,
               "windows_step_ms": {k: v * 1e3
                                   for k, v in wprof.times.items()}}
        del got
    out = {"rank": mesh.rank, "ranks": mesh.size, "backend": mesh.backend,
           "device": str(cols.device),
           "shape": [int(cols.shape[0]), 1 << trace_log], "root": root,
           "window_root_equal": window_root_equal,
           "ms": ms, "step_ms": {k: v * 1e3 for k, v in prof.times.items()},
           "launches": {k: launches[k] for k in K1K2}, **win}
    if keep_evals:
        out["evals"] = to_u32(ev)
        out["lde"] = to_u32(sharded_lde(mesh, cols, trace_log, s))
    return out


def mesh_step0_rank(mesh, C: int, log_n: int, seed: int) -> dict:
    """Step 0 of the windowed commit: the (C, 2^log_n) columns drawn
    from ``seed``, each rank given only its natural row window, committed
    through ``commit_windows`` on the 2^(log_n + 1) domain: whether the
    root equals the single-process commit of the whole matrix, and what
    the rank holds (its coefficients' and evaluations' shapes)."""
    from nexus_zkvm_tpu_torch.parallel import commit as pcommit
    from nexus_zkvm_tpu_torch.prover import pcs
    cols = mesh_columns((C, log_n, seed), mesh.device)
    root = pcs.commit_blocks("t", [cols.clone()], [log_n], 1, mesh.device,
                             keep_natural=False).trees[log_n + 1].root()
    lo, hi = pcommit.window(mesh, 1 << log_n)
    cf, ev, tree = pcommit.commit_windows(
        mesh, [cols[:, lo:hi].contiguous()], log_n, log_n + 1)
    return {"rank": mesh.rank, "C": C, "root_equal": bool(np.array_equal(
                tree.root(), root)),
            "coeffs": tuple(cf.shape), "evals": tuple(ev.shape)}


def mesh_collectives_rank(mesh) -> dict:
    """A sum across the ranks and a hash_rows sharded by rows (each rank
    hashes its share of 16 messages; the digests are gathered): both
    must equal the host's, as tests/test_distributed.py checks the JAX
    package's runtime.  Then the prover's other collectives at a piece
    of 5 words, so every message goes in several pieces: an all_to_all
    of (D, 13) words, a disjoint sum and a broadcast from the last rank,
    each against the values every rank can compute."""
    from nexus_zkvm_tpu_torch.ops.blake2s import (hash_rows,
                                                  np_batch_blake2s_words)
    from nexus_zkvm_tpu_torch.parallel import mesh as pmesh
    from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
    msgs = np.arange(16 * 8, dtype=np.uint32).reshape(16, 8)
    w = len(msgs) // mesh.size
    mine = from_u32(msgs[mesh.rank * w:(mesh.rank + 1) * w], mesh.device)
    total = int(mesh.all_gather(mine.to(torch.int64).sum().reshape(1)).sum())
    digests = to_u32(mesh.all_gather(hash_rows(mine)))
    if total != int(msgs.astype(np.uint64).sum()) or \
            not np.array_equal(digests, np_batch_blake2s_words(msgs)):
        raise RuntimeError("mesh collectives disagree with the host")
    D, r = mesh.size, mesh.rank
    word = np.arange(13)
    piece, pmesh._PIECE = pmesh._PIECE, 5
    try:
        sent = np.stack([r * 1000 + j * 100 + word for j in range(D)])
        got = to_u32(mesh.all_to_all(from_u32(sent.astype(np.uint32),
                                              mesh.device)))
        want = np.stack([q * 1000 + r * 100 + word for q in range(D)])
        part = np.zeros((D, 7), np.uint32)
        part[r] = r + 1 + np.arange(7)
        summed = to_u32(mesh.all_reduce(from_u32(part, mesh.device)))
        sums = np.stack([q + 1 + np.arange(7) for q in range(D)])
        b = from_u32(np.full(23, 7 + r, np.uint32), mesh.device)
        cast = to_u32(mesh.broadcast(b, D - 1))
    finally:
        pmesh._PIECE = piece
    return {"sum": total, "hash_rows_equal": True,
            "all_to_all_equal": bool(np.array_equal(got, want)),
            "all_reduce_equal": bool(np.array_equal(summed, sums)),
            "broadcast_equal": bool((cast == 7 + D - 1).all())}


def check_rank_kernels(prove_fn, timed: bool = False,
                       path: str = "mesh_") -> tuple:
    """Run ``prove_fn()`` with chip_smoke's kernel wrappers recorded
    (``record_calls``: every call of K3, K4 and K6-K9, one call of each
    shape of K1 and K2), then hold each kept call to its plain version
    (``check_recorded``, its phases prefixed ``path``; with ``timed`` the
    largest call of each kernel timed at the rank's shapes).  Returns
    (what ``prove_fn`` returned, {wrapper: calls held})."""
    import chip_smoke as cs
    out, calls = cs.record_calls(prove_fn, (*cs.RECORDED,
                                            *cs.RECORDED_BY_SHAPE))
    cs.check_recorded(calls, timed_run=timed, path=path)
    return out, {name: len(args) for name, args in calls.items()}


def mesh_slice_rank(mesh, k_squares: int, log_n: int, cfg,
                    device="cuda", check_kernels: bool = False) -> dict:
    """chip_smoke's synthetic fixture (``make_components``; one square is
    tests/test_stark_e2e.py's) proved under the mesh: the proof, the
    sharded trees and the windows the prover noted, and whether it
    verifies; with ``check_kernels``, rank 0 holds the proof's kernel
    calls at its shapes to their plain versions (`check_rank_kernels`)."""
    import chip_smoke as cs
    import nexus_zkvm_tpu_torch as T
    from nexus_zkvm_tpu_torch.parallel import use_mesh
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    comps = cs.make_components(k_squares)

    def prove():
        return T.prove(comps, [log_n, cs.TABLE_LOG],
                       cs.make_traces(log_n, k_squares), T.Blake2sChannel(),
                       cfg, device=device)
    window_kernels = None
    with use_mesh(mesh), profiled() as prof:
        if check_kernels and mesh.rank == 0:
            proof, window_kernels = check_rank_kernels(prove)
        else:
            proof = prove()
    return {"proof": proof, "sharded": prof.notes["sharded"],
            "window_kernels": window_kernels,
            "streamed": prof.notes["streamed"],
            "mesh_windows": prof.notes["mesh_windows"],
            "interaction_windows": prof.notes["interaction_windows"],
            "natural_windows": prof.notes["natural_windows"],
            "log_sizes": list(proof.log_sizes),
            "verified": T.verify(comps, proof, T.Blake2sChannel(), cfg,
                                 device=device)}


def mesh_machine_rank(mesh, src: str, public: bytes, device="cuda",
                      config=None, warm: bool = True,
                      check_kernels: bool = False,
                      machine2: bool = False) -> dict:
    """The guest of assembly ``src`` on ``public`` through LocalProver
    under the mesh (``machine2``: its trace through
    ``machine2.prove_machine2``): a cold proof (``warm``; its phases'
    seconds; with ``check_kernels``, rank 0 holds its kernel calls at
    its shapes to their plain versions, `check_rank_kernels`, phases
    prefixed "mesh_" or "mesh_m2_"), then a profiled one with its launch
    counts (set to 0 just before it), its peak device memory, in all
    and by top-level phase, and what the rank holds of
    each group (``mesh_windows``), of the interaction
    (``interaction_windows``) and of the natural values
    (``natural_windows``); verify; the proof digests of every rank,
    gathered, must agree.  With ``warm`` False the one proof is the
    profiled one."""
    from nexus_zkvm_tpu_torch import kernels
    from nexus_zkvm_tpu_torch.machine2 import prove_machine2, verify_machine2
    from nexus_zkvm_tpu_torch.parallel import use_mesh
    from nexus_zkvm_tpu_torch.prover import PcsConfig
    from nexus_zkvm_tpu_torch.sdk import Guest, LocalProver, proof_to_bytes
    from nexus_zkvm_tpu_torch.utils.device import to_u32
    from nexus_zkvm_tpu_torch.utils.profile import profiled
    cuda = torch.device(device).type == "cuda"
    prover = LocalProver(Guest.from_asm(src), config, device=device)
    if machine2:
        view2, trace2 = prover.trace(public_input=public)
        cfg = config or PcsConfig()

        def prove():
            return view2, prove_machine2(view2, trace2, cfg, device=device)

        def verify(view, proof):
            return verify_machine2(view, proof, cfg, device=device)
    else:
        def prove():
            return prover.prove_with_input(public_input=public)
        verify = prover.verify
    cold_s, cold_phases, window_kernels = None, None, None
    with use_mesh(mesh):
        if warm:
            def cold():
                nonlocal cold_s, cold_phases
                with profiled() as cprof:
                    t0 = time.perf_counter()
                    prove()
                    _sync(device)
                    cold_s = time.perf_counter() - t0
                cold_phases = cprof.times
            if check_kernels and mesh.rank == 0:
                # timed on the card on 2 ranks: rank 0's window shapes
                # of the fib 2^20 proof, PERF.md's mesh rows
                window_kernels = check_rank_kernels(
                    cold, cuda and mesh.size == 2 and not machine2,
                    "mesh_m2_" if machine2 else "mesh_")[1]
            else:
                cold()
            # every rank starts the measured proof together
            mesh.all_reduce(torch.zeros(1, dtype=torch.int32,
                                        device=mesh.device))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with profiled(memory=True) as prof:
            t0 = time.perf_counter()
            view, proof = prove()
            _sync(device)
            prove_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    peak = max([torch.cuda.max_memory_allocated(),
                *prof.peaks.values()]) if cuda else None
    t0 = time.perf_counter()
    ok = verify(view, proof)
    verify_s = time.perf_counter() - t0
    blob = proof_to_bytes(proof)
    digest = proof_digest(blob)
    words = torch.from_numpy(np.frombuffer(bytes.fromhex(digest), np.int32)
                             .copy()).to(mesh.device)
    every = {bytes(to_u32(d)).hex()
             for d in mesh.all_gather(words[None]).unbind(0)}
    return {"rank": mesh.rank, "ranks": mesh.size, "backend": mesh.backend,
            "machine2": machine2, "cpu_log_rows": proof.stark.log_sizes[0],
            "log_sizes": list(proof.stark.log_sizes),
            "proof_blake2s": digest, "proof_bytes": len(blob),
            "ranks_agree": every == {digest}, "verified": ok, "warm": warm,
            "prove_s": prove_s, "prove_cold_s": cold_s, "verify_s": verify_s,
            "peak_bytes": peak, "phase_peak_bytes": prof.peaks,
            "sharded": prof.notes["sharded"],
            "streamed": prof.notes["streamed"],
            "mesh_windows": prof.notes["mesh_windows"],
            "interaction_windows": prof.notes["interaction_windows"],
            "natural_windows": prof.notes["natural_windows"],
            "window_kernels": window_kernels, "phase_s": prof.times,
            "cold_phase_s": cold_phases,
            "launches": launches}
