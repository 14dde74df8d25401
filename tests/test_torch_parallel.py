"""The port's meshes (``nexus_zkvm_tpu_torch.parallel``) against the JAX
package's ``parallel/``.

Ranks are processes (``torch_mesh.spawn``, gloo on the CPU, one thread
each), started once per mesh size; each runs all of that size's checks
(the rank programs of tests/torch_mesh.py, which the card's
``parallel`` phase runs too):

- the sharded commit and LDE at D = 2, 4 and 8 (C = 16 columns of 2^8
  rows, as tests/test_parallel.py; C = 13, which no D divides; C = 5 <
  D = 8) equal the port's single-process ``pcs`` commit and the JAX
  ``sharded_commit_columns`` / ``sharded_lde`` on its 8-device CPU mesh
  (or, where the JAX mesh needs C divisible by D, the JAX ``pcs``
  commit); D = 1 is the local mesh;
- two processes joined through the NZT_* environment sum across ranks
  and hash rows sharded by rows, as tests/test_distributed.py checks
  the JAX runtime; the all_to_all, disjoint sum and broadcast of the
  prover's mesh are right at a piece of 5 words (D = 2, 4, 8);
- the e2e fixture of tests/test_stark_e2e.py proved on 2, 4 and 8
  ranks equals the JAX package's proof field by field on every rank;
- the fib n = 10 machine proof on 2 and 4 ranks has the reference's
  digest on every rank, and so has the machine2 proof of
  tests/test_torch_machine2_proof.py's fib program on 2;
- under the mesh nothing streams, and each rank holds of every size
  group exactly its row window and column share when the rows split
  (``mesh_windows``), the whole group when they do not;
- each rank generates the interaction only for its natural row window
  of every component whose rows split, the whole for the rest
  (``interaction_windows``), and keeps of the natural main and
  preprocessed values only that window and the halo its gen tapes read
  (``natural_windows``);
- step 0 of the windowed commit (each rank given only its natural row
  window, ``commit_windows``) gives the whole matrix's root at C = 244,
  5 and 1 (and at the sharded commit's widths).

Every comparison is exact: uint32 equality, equal proof fields, equal
proof bytes.
"""

import numpy as np
import pytest
import torch

from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.parallel import (make_mesh as rmake_mesh,
                                     sharded_commit_columns as rsharded)
from nexus_zkvm_tpu.parallel import commit as rcommit
from nexus_zkvm_tpu.parallel import distributed as rdist
from nexus_zkvm_tpu.prover import pcs as rpcs, prove as rprove
from nexus_zkvm_tpu_torch import parallel as par
from nexus_zkvm_tpu_torch.parallel import commit as pcommit
from nexus_zkvm_tpu_torch.parallel import distributed as tdist
from nexus_zkvm_tpu_torch.parallel.commit import sharded_lde
from nexus_zkvm_tpu_torch.prover import pcs
from nexus_zkvm_tpu_torch.utils.device import to_u32
import test_stark_e2e as E
import test_torch_machine as tmach
import test_torch_machine2_proof as tm2
import test_torch_stark as tstark
import torch_mesh as tm
import torch_cpu  # noqa: F401  (one torch thread a test process)

LOG, BLOWUP = 8, 1
S = LOG + BLOWUP
WIDTHS = {1: (16, 13), 2: (16, 13), 4: (16, 13), 8: (16, 13, 5)}
CASES = [(d, c) for d, cs in WIDTHS.items() for c in cs]
# step 0 of the windowed commit: the interaction's width at fib 2^20, a
# width no D divides, and one column (the other ranks' shares empty)
STEP0 = (244, 5, 1)


def _columns(C):
    rng = np.random.default_rng(0)
    return rng.integers(0, (1 << 31) - 1, (16, 1 << LOG)).astype(
        np.uint32)[:C]


def _commits(d):
    return [(tm.mesh_commit_rank, (_columns(c), LOG, BLOWUP, True))
            for c in WIDTHS[d]] + \
        [(tm.mesh_step0_rank, (c, LOG, 7)) for c in STEP0]


def _spawn(d, checks):
    return tm.spawn(tm.checks_rank, d, checks, backend="gloo", device="cpu",
                    timeout=600)


@pytest.fixture
def cpu_process(monkeypatch):
    """This process as a rank of its own on the CPU: no process group
    (the environment holds none), meshes on the CPU."""
    for name in ("NZT_COORDINATOR", "JAX_COORDINATOR", "MASTER_ADDR",
                 "MASTER_PORT", "NZT_NUM_PROCESSES", "JAX_NUM_PROCESSES",
                 "WORLD_SIZE", "NZT_PROCESS_ID", "JAX_PROCESS_ID", "RANK"):
        monkeypatch.delenv(name, raising=False)
    return par.init_distributed(device="cpu")


EXTRA = {2: ("collectives", "e2e", "fib10", "machine2"),
         4: ("collectives", "e2e", "fib10"), 8: ("collectives", "e2e")}
CHECKS = {"collectives": (tm.mesh_collectives_rank, ()),
          # at D = 2 rank 0 also holds the proof's kernel calls at its
          # shapes to their plain versions, as the card's parallel phase
          # does
          "e2e": (tm.mesh_slice_rank, (1, E.LOG_SQ, tstark.TCFG, "cpu",
                                       True)),
          "fib10": (tm.mesh_machine_rank, (tmach.FIB10_SRC, b"", "cpu",
                                           tmach.TCFG, False)),
          "machine2": (tm.mesh_machine_rank, (tm2.FIB_SRC, b"", "cpu",
                                              tm2.TCFG, False, False, True))}


@pytest.fixture(scope="module")
def ranks():
    """{D: per rank, the results of its checks}: the commits of every
    width and step 0's, then those of EXTRA[D] (by name:
    ``ranks[d][r][name]``)."""
    out = {}
    for d in (2, 4, 8):
        got = _spawn(d, _commits(d) + [CHECKS[name] for name in EXTRA[d]])
        k, k0 = len(WIDTHS[d]), len(WIDTHS[d]) + len(STEP0)
        out[d] = [dict(zip(EXTRA[d], rec[k0:]), commits=rec[:k],
                       step0=rec[k:k0]) for rec in got]
    return out


@pytest.fixture(scope="module")
def e2e_reference():
    return tstark.to_port_proof(rprove(E.COMPONENTS, E.LOG_SIZES,
                                       E.make_traces(), RChannel(),
                                       tstark.RCFG))


@pytest.fixture(scope="module")
def references():
    """Per width: the JAX sharded commit on its 8-device mesh where 8
    divides C, else the JAX pcs commit; the port's single-process pcs
    commit; the JAX sharded LDE."""
    out = {}
    for c in (16, 13, 5):
        cols = _columns(c)
        if c % 8 == 0:
            ev, root = rsharded(rmake_mesh(8), cols, LOG, log_blowup=BLOWUP)
            lde = rcommit.sharded_lde(rmake_mesh(8), cols, LOG, S)
        else:
            rc = rpcs.commit_columns("t", list(cols), [LOG] * c, BLOWUP)
            ev, root, lde = rc.evals[S], rc.trees[S].root(), rc.evals[S]
        tc = pcs.commit_columns("t", list(cols), [LOG] * c, BLOWUP, "cpu")
        out[c] = {"jax": (np.asarray(ev, np.uint32),
                          np.asarray(root, np.uint32),
                          np.asarray(lde, np.uint32)),
                  "port": (to_u32(tc.evals[S]), tc.trees[S].root())}
    return out


def _rank_commits(ranks, d, c):
    if d == 1:
        mesh = par.local_mesh()
        ev, root = par.sharded_commit_columns(mesh, _columns(c), LOG, BLOWUP)
        lde = sharded_lde(mesh, _columns(c), LOG, S)
        return [{"evals": to_u32(ev), "root": root, "lde": to_u32(lde),
                 "rank": 0}]
    return [r["commits"][WIDTHS[d].index(c)] for r in ranks[d]]


@pytest.mark.parametrize("d,c", CASES, ids=[f"D{d}-C{c}" for d, c in CASES])
def test_sharded_commit_equals_reference(ranks, references, cpu_process,
                                         d, c):
    """Every rank's evaluations and root equal the JAX package's and the
    port's single process's; the sharded LDE equals the JAX one."""
    ev, root, lde = references[c]["jax"]
    pev, proot = references[c]["port"]
    assert np.array_equal(pev, ev) and np.array_equal(proot, root)
    recs = _rank_commits(ranks, d, c)
    assert [r["rank"] for r in recs] == list(range(d))
    for rec in recs:
        assert rec["evals"].shape == (c, 1 << S)
        assert np.array_equal(rec["evals"], ev), rec["rank"]
        assert np.array_equal(rec["root"], root), rec["rank"]
        assert np.array_equal(rec["lde"], lde), rec["rank"]
        assert rec.get("window_root_equal", True), rec["rank"]
        assert rec.get("windows_root_equal", True), rec["rank"]
    if d > 1:
        assert all("windows_root_equal" in r for r in recs)


def test_two_processes_through_the_environment(ranks):
    """Rank r of 2 joined through NZT_COORDINATOR / NZT_NUM_PROCESSES /
    NZT_PROCESS_ID: a sum across ranks and a row-sharded hash_rows equal
    the host's."""
    for r, rec in enumerate(ranks[2]):
        coll = rec["collectives"]
        assert coll["sum"] == int(np.arange(128).sum()), r
        assert coll["hash_rows_equal"], r
        assert rec["commits"][0]["ranks"] == 2
        assert rec["commits"][0]["backend"] == "gloo"


@pytest.mark.parametrize("d", [2, 4, 8])
def test_all_to_all_reduce_and_broadcast_in_small_pieces(ranks, d):
    """The mesh's all_to_all (rank r's piece j to rank j), disjoint sum
    and broadcast, each message cut into pieces of 5 words, give every
    rank the values it can compute itself."""
    for r, rec in enumerate(ranks[d]):
        coll = rec["collectives"]
        assert coll["all_to_all_equal"], r
        assert coll["all_reduce_equal"], r
        assert coll["broadcast_equal"], r


def test_machine_proof_on_two_ranks_has_reference_digest(ranks):
    """The fib n = 10 machine proof on a 2-rank mesh: on every rank the
    reference's proof bytes, verified, with the main trees committed
    over the mesh."""
    for r, rec in enumerate(ranks[2]):
        m = rec["fib10"]
        assert m["proof_blake2s"] == tmach.FIB10_PROOF_BLAKE2S, r
        assert m["ranks_agree"] and m["verified"], r
        assert ("main", m["cpu_log_rows"] + 1) in m["sharded"], m["sharded"]
        assert m["streamed"] == [], r


def test_window_kernel_calls_are_recorded_and_rerun(ranks):
    """Rank 0 of the 2-rank e2e proof kept the calls of every kernel
    wrapper of its path (chip_smoke's ``record_calls``: every call of
    K3, K4 and K6-K9, one of each shape of K1 and K2, at the rank's
    windows, shares and chunks) and ran each again through the wrapper
    and the plain version, equal (``check_recorded``; on the CPU both
    are the plain version; the card's parallel phase runs the same
    check against the kernels)."""
    import chip_smoke as cs
    wk = ranks[2][0]["e2e"]["window_kernels"]
    assert set(wk) == set(cs.RECORDED) | set(cs.RECORDED_BY_SHAPE)
    assert all(wk.values()), wk
    assert ranks[2][1]["e2e"]["window_kernels"] is None


def test_machine_proof_on_four_ranks_has_reference_digest(ranks):
    """The fib n = 10 machine proof on a 4-rank mesh: on every rank the
    reference's proof bytes, verified, nothing streamed."""
    for r, rec in enumerate(ranks[4]):
        m = rec["fib10"]
        assert m["proof_blake2s"] == tmach.FIB10_PROOF_BLAKE2S, r
        assert m["ranks_agree"] and m["verified"], r
        assert ("main", m["cpu_log_rows"] + 1) in m["sharded"], m["sharded"]
        assert m["streamed"] == [], r


def _e2e_equals(ranks, d, ref):
    for r, rec in enumerate(ranks[d]):
        sl = rec["e2e"]
        assert sl["verified"], r
        assert sl["sharded"], r
        assert sl["streamed"] == [], r
        assert tstark.tree_eq(ref, sl["proof"]), r


def test_e2e_proof_on_four_ranks_equals_reference(ranks, e2e_reference):
    """The e2e fixture proved on a 4-rank mesh equals the JAX package's
    proof field by field, on every rank, and verifies."""
    _e2e_equals(ranks, 4, e2e_reference)


@pytest.mark.parametrize("d", [2, 8])
def test_e2e_proof_on_two_and_eight_ranks_equals_reference(ranks,
                                                          e2e_reference, d):
    """The same on 2 ranks, and on 8, where the 2^7-row groups do not
    split and stay whole on every rank."""
    _e2e_equals(ranks, d, e2e_reference)


@pytest.mark.parametrize("d,proof", [(2, "e2e"), (4, "e2e"), (8, "e2e"),
                                     (2, "fib10"), (4, "fib10")])
def test_each_rank_holds_its_window_and_column_share(ranks, d, proof):
    """What every rank holds of each (role, size) group: its row window
    [r·M/D, (r+1)·M/D) of the evaluations and its share of ceil(C/D)
    columns of the coefficients where M/D reaches MIN_WINDOW rows, the
    whole (C, M) group and all C columns where it does not; the shapes
    are those of the tensors the rank keeps."""
    seen = set()
    for r, rec in enumerate(ranks[d]):
        got = rec[proof]["mesh_windows"]
        assert got, r
        for role, s, rows, cols, ev_shape, cf_shape in got:
            M, C = 1 << s, ev_shape[0]
            if M // d >= pcommit.MIN_WINDOW:
                w, k = M // d, -(-C // d)
                want_cols = (min(r * k, C), min(r * k + k, C))
                assert rows == (r * w, (r + 1) * w), (r, role, s)
                seen.add("split")
            else:
                w, want_cols = M, (0, C)
                assert rows == (0, M), (r, role, s)
                seen.add("whole")
            assert cols == want_cols, (r, role, s, cols)
            assert ev_shape == (C, w), (r, role, s)
            assert cf_shape == (cols[1] - cols[0], M // 2), (r, role, s)
    assert "split" in seen


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("c", STEP0)
def test_step0_commit_from_windows_equals_whole_root(ranks, d, c):
    """Each rank given only its natural row window of (C, 2^8) columns:
    one all_to_all to its share of the columns, then the windowed commit;
    the root is the single-process commit's of the whole matrix, and the
    rank holds its share's coefficients (none past C) and its row window
    of the evaluations."""
    k = -(-c // d)
    for r, rec in enumerate(ranks[d]):
        got = rec["step0"][STEP0.index(c)]
        assert (got["rank"], got["C"]) == (r, c)
        assert got["root_equal"], r
        share = min(r * k + k, c) - min(r * k, c)
        assert got["coeffs"] == (share, 1 << LOG), r
        assert got["evals"] == (c, (1 << S) // d), r


def _gen_halos(proof, d):
    """n -> (hneg, hpos) of the components the proof's ranks ran."""
    if proof == "e2e":
        import chip_smoke as cs
        comps = cs.make_components(1)
        logs = [E.LOG_SQ, cs.TABLE_LOG]
    else:
        from nexus_zkvm_tpu_torch.sdk import Guest, LocalProver
        from nexus_zkvm_tpu_torch.machine.driver import build_machine_traces
        from nexus_zkvm_tpu_torch.machine2 import build_machine2_traces
        src = {"fib10": tmach.FIB10_SRC, "machine2": tm2.FIB_SRC}[proof]
        view, trace = LocalProver(Guest.from_asm(src), device="cpu").trace()
        comps, logs, _tr = (build_machine2_traces if proof == "machine2"
                            else build_machine_traces)(view, trace,
                                                       device="cpu")
    from nexus_zkvm_tpu_torch.prover.stark import _gen_halos as halos
    from nexus_zkvm_tpu_torch.air.component import component_info
    return halos(comps, [component_info(c) for c in comps], logs)


# whether the proof has a component whose rows split (the e2e fixture's
# 2^6 rows do not on 4 or 8 ranks)
MESH_PROOFS = {(2, "e2e"): True, (4, "e2e"): False, (8, "e2e"): False,
               (2, "fib10"): True, (4, "fib10"): True, (2, "machine2"): True}


@pytest.mark.parametrize("d,proof", list(MESH_PROOFS))
def test_each_rank_generates_its_interaction_window(ranks, d, proof):
    """Every component with lookups, on every rank: rows [r·M/D,
    (r+1)·M/D) of its interaction where the mesh splits its M rows
    (M/D at least MIN_WINDOW), all M rows where it does not; and the
    natural main and preprocessed values the rank kept are that window
    and the halo its gen tapes read, or the whole group."""
    halos = _gen_halos(proof, d)
    seen = set()
    for r, rec in enumerate(ranks[d]):
        got = rec[proof]
        logs = got["log_sizes"]
        assert got["interaction_windows"], r
        for c, lo, hi in got["interaction_windows"]:
            M = 1 << logs[c]
            if M // d >= pcommit.MIN_WINDOW:
                assert (lo, hi) == (r * M // d, (r + 1) * M // d), (r, c)
                seen.add("split")
            else:
                assert (lo, hi) == (0, M), (r, c)
        for role, n, (lo, L, hneg), shape in got["natural_windows"]:
            M = 1 << n
            if M // d >= pcommit.MIN_WINDOW:
                hn, hp = halos.get(n, (0, 0))
                assert (lo, L, hneg) == (r * M // d, M // d, hn), (r, role, n)
                assert shape[1] == hn + M // d + hp, (r, role, n, shape)
            else:
                assert (lo, L, hneg) == (0, M, 0) and shape[1] == M
    assert ("split" in seen) == MESH_PROOFS[(d, proof)]


def test_machine2_proof_on_two_ranks_has_reference_digest(ranks):
    """tests/test_torch_machine2_proof.py's fib program through
    ``prove_machine2`` on a 2-rank mesh: on every rank the reference's
    proof bytes, verified, nothing streamed."""
    for r, rec in enumerate(ranks[2]):
        m = rec["machine2"]
        assert m["proof_blake2s"] == tm2.FIB_M2_PROOF_BLAKE2S, r
        assert m["ranks_agree"] and m["verified"], r
        assert m["sharded"] and m["streamed"] == [], r


def test_one_rank_alone_joins_no_group():
    """A spawn of one rank (as the card's parallel phase measures one
    process alone): no process group, the local mesh, whose collectives
    are the identity."""
    rec, = tm.spawn(tm.mesh_collectives_rank, 1, backend="gloo",
                    device="cpu", timeout=120)
    assert rec["sum"] == int(np.arange(128).sum())
    assert all(rec[k] for k in ("hash_rows_equal", "all_to_all_equal",
                                "all_reduce_equal", "broadcast_equal"))


def test_local_mesh_is_degenerate(cpu_process):
    """A mesh of one on the device init_distributed was given: no process
    group, the gather is the identity."""
    mesh = par.local_mesh()
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    assert mesh.device == torch.device("cpu")
    t = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    assert mesh.all_gather(t) is t
    assert par.make_mesh().size == 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        par.make_mesh(2)


def test_init_distributed_without_environment_is_a_no_op(cpu_process):
    info = cpu_process
    assert info == {"process_id": 0, "n_processes": 1, "local_devices": 1,
                    "global_devices": 1}
    assert set(info) == set(rdist.process_info())
    assert not par.is_distributed()
    assert not torch.distributed.is_initialized()
    assert tdist.device() == torch.device("cpu")


def test_use_mesh_scoping(cpu_process):
    assert par.active_mesh() is None
    mesh = par.local_mesh()
    with par.use_mesh(mesh):
        assert par.active_mesh() is mesh
    assert par.active_mesh() is None
    par.set_mesh(mesh)
    try:
        assert par.active_mesh() is mesh
    finally:
        par.set_mesh(None)


@pytest.mark.parametrize("shape,rank,window", [
    ((3, 8), 1, slice(2, 4)), ((8,), 3, slice(6, 8)), ((3, 6), 0, None),
    ((), 0, None)])
def test_shard_rows_takes_the_rank_window_or_nothing(cpu_process, shape,
                                                    rank, window):
    """The rank's window of the last axis when 4 divides it; the tensor
    itself otherwise, and with no mesh or a mesh of one."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    assert par.shard_rows(t) is t
    mesh = par.mesh.Mesh(size=4, rank=rank, device=torch.device("cpu"),
                         backend="gloo")
    with par.use_mesh(mesh):
        got = par.shard_rows(t)
    if window is None:
        assert got is t
    else:
        assert torch.equal(got, t[..., window])
    with par.use_mesh(par.local_mesh()):
        assert par.shard_rows(t) is t

