"""Segmented machine proofs over the mesh against the JAX package's.

`machine.prove_machine(view, trace, segment_log=k)` under
`parallel.use_mesh`, on 2 and 4 gloo CPU ranks (tests/torch_mesh.py's
`mesh_machine_rank(..., segment_log=k)`, one spawn a mesh size): every
rank emulates and fills every segment, as the JAX package's
multi-controller does, and holds its row window of every segment's CPU
component.  Every comparison is exact:

* `chip_smoke.MIXED_SRC` (449 steps) in 2^7-step segments, four CPU
  components of 2^7 rows whose rows split over 2 and 4 ranks: on every
  rank the bytes of the JAX package's `prove_machine(...,
  segment_log=7)` proof (a digest recorded on XLA:CPU; the `slow` test
  recomputes it) and of the port's one-process proof, verified, a
  tampered opening and another program's claim rejected;
* each rank's interaction of every CPU segment is its natural window,
  and what it holds passes `chip_smoke.check_mesh_windows`, the card's
  check of the same records (which catches another rank's window);
* `FIB10_SRC` in 2^5-step segments on 2 ranks: two CPU components too
  small to split (16 rows a rank, under `MIN_WINDOW`), held whole by
  both ranks, with the JAX package's digest.
"""

import copy
import hashlib

import pytest

import chip_smoke
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.sdk import Guest as RGuest, LocalProver as RLocalProver
from nexus_zkvm_tpu.sdk.serialize import proof_to_bytes as rproof_to_bytes
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.parallel.commit import MIN_WINDOW
from nexus_zkvm_tpu_torch.prover.stark import _gen_halos
from nexus_zkvm_tpu_torch.sdk import Guest, LocalProver, proof_to_bytes

import test_torch_machine as tmach
import test_torch_segments as tseg
import torch_mesh as tm
import torch_cpu  # noqa: F401  (one torch thread a test process)

MIXED_SEG_LOG = 7
MIXED_SEGMENTS = 4
# blake2s of the JAX package's `prove_machine(view, trace, RCFG,
# segment_log=7)` proof of chip_smoke.MIXED_SRC (four CPU components of
# 2^7 rows, the last of 65 steps; 821,156 bytes) through
# `sdk.serialize.proof_to_bytes`, recorded on XLA:CPU (the execution
# emulated by the SDK's `LocalProver.trace`, as the ranks do); the slow
# test recomputes it
MIXED_SEG7_PROOF_BLAKE2S = \
    "b34a8982f0ab1c605ef548a98b62576254fea11c49bd6b4367ae947fda7c5eae"


def _mixed_rank():
    return (tm.mesh_machine_rank, (chip_smoke.MIXED_SRC, b"", "cpu",
                                   tmach.TCFG, False, False, False,
                                   MIXED_SEG_LOG, True))


def _fib10_rank():
    return (tm.mesh_machine_rank, (tmach.FIB10_SRC, b"", "cpu", tmach.TCFG,
                                   False, False, False, tseg.FIB10_SEG_LOG))


@pytest.fixture(scope="module")
def ranks():
    """{D: per rank, {"mixed": its record, ("fib10" on 2 ranks)}}."""
    out = {}
    for d, checks in ((2, {"mixed": _mixed_rank(), "fib10": _fib10_rank()}),
                      (4, {"mixed": _mixed_rank()})):
        got = tm.spawn(tm.checks_rank, d, list(checks.values()),
                       backend="gloo", device="cpu", timeout=600)
        out[d] = [dict(zip(checks, rec)) for rec in got]
    return out


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process proof of the execution the ranks prove,
    emulated as their `LocalProver.trace` does (its memory layout, which
    the transcript binds, is the SDK guest's): its digest and the
    components' halos by size."""
    tv, tt = LocalProver(Guest.from_asm(chip_smoke.MIXED_SRC),
                         device="cpu").trace()
    proof = tdriver.prove_machine(tv, tt, tmach.TCFG,
                                  segment_log=MIXED_SEG_LOG, device="cpu")
    comps, logs, _tr = tdriver.build_machine_traces(
        tv, tt, segment_log=MIXED_SEG_LOG, device="cpu")
    halos = _gen_halos(comps, [component_info(c) for c in comps], logs)
    return hashlib.blake2s(proof_to_bytes(proof)).hexdigest(), halos


@pytest.mark.parametrize("d", [2, 4])
def test_segmented_mesh_proof_equals_reference_digest(ranks, d):
    """On every rank the JAX package's proof bytes, the same on all
    ranks, verified, four CPU components of 2^7 rows first."""
    for r, rec in enumerate(ranks[d]):
        m = rec["mixed"]
        assert (m["rank"], m["ranks"], m["segment_log"]) == (r, d, 7)
        assert m["proof_blake2s"] == MIXED_SEG7_PROOF_BLAKE2S, r
        assert m["ranks_agree"] and m["verified"], r
        assert m["log_sizes"][:MIXED_SEGMENTS + 1] == \
            [MIXED_SEG_LOG] * MIXED_SEGMENTS + [5], r
        assert m["streamed"] == [], r


@pytest.mark.parametrize("d", [2, 4])
def test_segmented_mesh_proof_equals_one_process(ranks, one_process, d):
    digest, _halos = one_process
    assert digest == MIXED_SEG7_PROOF_BLAKE2S
    assert {rec["mixed"]["proof_blake2s"] for rec in ranks[d]} == {digest}


@pytest.mark.parametrize("d", [2, 4])
def test_segmented_mesh_proof_rejects_tampering(ranks, d):
    """Every rank ran chip_smoke's `rejects_tampering` on its proof (a
    tampered main opening and another program's claim, each of which
    must fail `verify_machine`; it raises otherwise)."""
    assert all(rec["mixed"]["tampered_rejected"] for rec in ranks[d])


@pytest.mark.parametrize("d", [2, 4])
def test_each_rank_interacts_on_its_window_of_every_segment(ranks, d):
    """Every CPU segment's interaction rows are the rank's natural window
    [r·2^7/D, (r+1)·2^7/D), the same for all four."""
    w = (1 << MIXED_SEG_LOG) // d
    assert w >= MIN_WINDOW
    for r, rec in enumerate(ranks[d]):
        got = {c: (lo, hi)
               for c, lo, hi in rec["mixed"]["interaction_windows"]}
        for c in range(MIXED_SEGMENTS):
            assert got[c] == (r * w, (r + 1) * w), (r, c)


@pytest.mark.parametrize("d", [2, 4])
def test_card_window_check_passes_on_cpu_ranks(ranks, one_process, d):
    """`chip_smoke.check_mesh_windows`, which the card's `parallel`
    phase and `--mesh-nccl` run on their ranks' records, passes on
    these: the trees in windows, every segment's window of the main
    group, interaction and natural values with the halo at 2^7."""
    _digest, halos = one_process
    for rec in ranks[d]:
        chip_smoke.check_mesh_windows(
            f"mixed/rank{rec['mixed']['rank']}", rec["mixed"],
            [MIXED_SEG_LOG] * MIXED_SEGMENTS, halos[MIXED_SEG_LOG])


@pytest.mark.parametrize("how", ["interaction", "main", "first"])
def test_card_window_check_rejects_another_ranks_window(ranks, one_process,
                                                       how):
    """The same check on rank 1's record of 2 ranks with one thing of
    rank 0's in it: a segment's interaction window, the main group's
    window, or the CPU components' sizes claimed one segment more."""
    _digest, halos = one_process
    rec = copy.deepcopy(ranks[2][1]["mixed"])
    cpu_logs = [MIXED_SEG_LOG] * MIXED_SEGMENTS
    if how == "interaction":
        wins = rec["interaction_windows"]
        wins[2] = (2, 0, (1 << MIXED_SEG_LOG) // 2)
    elif how == "main":
        i = next(i for i, g in enumerate(rec["mesh_windows"])
                 if tuple(g[:2]) == ("main", MIXED_SEG_LOG + 1))
        g = list(rec["mesh_windows"][i])
        g[2] = (0, (1 << (MIXED_SEG_LOG + 1)) // 2)
        rec["mesh_windows"][i] = tuple(g)
    else:
        cpu_logs = cpu_logs + [MIXED_SEG_LOG]
    with pytest.raises(RuntimeError):
        chip_smoke.check_mesh_windows("rank1", rec, cpu_logs,
                                      halos[MIXED_SEG_LOG])


def test_small_segments_held_whole_on_two_ranks(ranks):
    """FIB10_SRC in 2^5-step segments on 2 ranks: the JAX package's
    digest (tests/test_torch_segments.py's) on both ranks, verified; the
    two CPU components' 16 rows a rank are under MIN_WINDOW, so each
    rank interacts on all 32 rows and keeps their natural values whole,
    while the main group's 2^6-row domain splits."""
    for r, rec in enumerate(ranks[2]):
        m = rec["fib10"]
        assert m["proof_blake2s"] == tseg.FIB10_SEG5_PROOF_BLAKE2S, r
        assert m["ranks_agree"] and m["verified"], r
        assert m["log_sizes"][:2] == [tseg.FIB10_SEG_LOG] * 2
        inter = {c: (lo, hi) for c, lo, hi in m["interaction_windows"]}
        assert inter[0] == inter[1] == (0, 32), r
        chip_smoke.check_mesh_windows(f"fib10/rank{r}", m,
                                      [tseg.FIB10_SEG_LOG] * 2, (0, 0))


@pytest.mark.slow
def test_segmented_proof_equals_reference_live(one_process):
    rv, rt = RLocalProver(RGuest.from_asm(chip_smoke.MIXED_SRC)).trace()
    ref = rdriver.prove_machine(rv, rt, tmach.RCFG, segment_log=MIXED_SEG_LOG)
    want = hashlib.blake2s(rproof_to_bytes(ref)).hexdigest()
    assert want == MIXED_SEG7_PROOF_BLAKE2S == one_process[0]
