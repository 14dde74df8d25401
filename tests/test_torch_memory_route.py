"""The memory mode's thresholds by device (`MemoryConfig.for_device`).

On the CPU the thresholds are the class defaults, the ones the CPU tests
compare with the JAX package's routes.  On a card they are fractions of
its memory M (`prover.config.CARD_FRACTIONS`), shared among the mesh
ranks on that card; the routes they give the fib guest's CPU component
at 2^20 to 2^23 rows are the ones `chip_smoke.py --time-memory` measured
fastest within 0.85 M on an H100 80GB HBM3.  A proof's thresholds are
then fitted to its shapes (`stark._fitted`): where what it holds while
it composes would not fit 0.6 M, more of its trees stream.  Pure
functions of the shapes, and the fib n = 10 fixture's proofs.
"""

import contextlib
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.air.component import component_info
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.parallel import mesh as tmesh
from nexus_zkvm_tpu_torch.prover import config as tconfig
from nexus_zkvm_tpu_torch.prover import stark
from nexus_zkvm_tpu_torch.sdk import proof_to_bytes
from nexus_zkvm_tpu_torch.utils.profile import profiled
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace

import test_torch_machine as tmach
import torch_cpu  # noqa: F401  (one torch thread a test process)

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100
# 80GB HBM3 (chip_smoke.py --time-memory)
H100_80GB = 85_017_493_504


@pytest.fixture(scope="module")
def fib_infos():
    """The fib guest's machine components, the CPU component first: 193
    main columns, 61 LogUp batches (244 interaction columns), 438
    natural 4x-domain columns (column counts are the same at every trace
    size)."""
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    return [component_info(c) for c in tdriver.build_components(view, 1)[0]]


@pytest.fixture(scope="module")
def fib_info(fib_infos):
    return fib_infos[0]


# the log sizes of the fib guest's other machine components in its proofs
# on the card from 2^20 steps up (chip_smoke.py --time-memory's records)
FIB_OTHER_LOGS = [4, 5, 8, 11, 8, 3, 5, 3, 8, 7, 6, 3, 8, 8, 12, 11]


def card_route(memory: T.MemoryConfig, infos, logs, trees=None) -> tuple:
    """(the streamed (role, eval size) trees, each component's passes,
    the bytes the proof holds while it composes beside its largest pass)
    of a proof of ``infos`` at 2^logs rows under ``memory`` fitted to it,
    as `prove` fits it (`stark._fitted`); ``trees``: its
    `stark._tree_bytes`, which do not depend on ``memory``."""
    evals, fixed = trees or stark._tree_bytes(
        stark.build_plan(logs, infos, tmach.TCFG), logs, 1)
    passes = [stark._comp_passes(memory, i, n, None)
              for i, n in zip(infos, logs)]
    fitted = memory.fitted(evals.values(), fixed,
                           stark._pass_bytes(memory, infos, logs, passes))
    streamed = {t for t, e in evals.items() if fitted.streams(e)}
    held = fixed + sum(e for e in evals.values() if not fitted.streams(e)) + \
        stark._pass_bytes(memory, infos, logs, passes)
    return streamed, passes, held


def fib_route(memory: T.MemoryConfig, infos, cpu_log: int) -> tuple:
    """(streamed roles, composition passes) of the fib CPU component at
    2^cpu_log rows under ``memory``, fitted to the whole proof."""
    streamed, passes, _held = card_route(memory, infos,
                                         [cpu_log] + FIB_OTHER_LOGS)
    return tuple(role for role in ("main", "inter")
                 if (role, cpu_log + 1) in streamed), passes[0]


# the route the card's defaults give at each CPU component size: the
# fastest route of `--time-memory` whose reserved peak stays within
# 0.85 M (PERF.md section 6)
CARD_ROUTES = {20: ((), 1), 21: ((), 1), 22: ((), 2),
               23: (("main", "inter"), 4)}


def test_for_device_on_the_cpu_is_the_class_default():
    assert T.MemoryConfig.for_device("cpu") == T.MemoryConfig()
    assert T.MemoryConfig.for_device(torch.device("cpu")) == \
        T.MemoryConfig()
    mesh = tmesh.Mesh(size=4, rank=1, device=torch.device("cpu"),
                      backend="gloo", per_card=4)
    assert T.MemoryConfig.for_device("cpu", mesh) == T.MemoryConfig()


def test_for_bytes_is_the_card_fractions():
    m = T.MemoryConfig.for_bytes(H100_80GB)
    assert dataclasses.asdict(m) == {
        k: int(H100_80GB * f) for k, f in tconfig.CARD_FRACTIONS.items()}
    assert set(tconfig.CARD_FRACTIONS) == {
        f.name for f in dataclasses.fields(T.MemoryConfig)}


@pytest.mark.parametrize("cpu_log", sorted(CARD_ROUTES))
def test_card_route_by_size(fib_infos, cpu_log):
    """An 80 GB card's thresholds give the fib component the measured
    fastest route that fits at every size."""
    m = T.MemoryConfig.for_bytes(H100_80GB)
    assert fib_route(m, fib_infos, cpu_log) == CARD_ROUTES[cpu_log]


@pytest.mark.parametrize("share,cpu_log,route", [
    # half a card: 2^21 like the whole card's 2^22
    (2, 20, ((), 1)), (2, 21, ((), 2)), (2, 22, (("main", "inter"), 4)),
    # a quarter
    (4, 20, ((), 2)), (4, 21, (("main", "inter"), 4)),
    (4, 22, (("main", "inter"), 8))])
def test_card_route_at_a_share_of_the_card(fib_infos, share, cpu_log,
                                           route):
    """A half and a quarter of the card (ranks sharing it): a size takes
    the route that the whole card gives a size share times larger."""
    m = T.MemoryConfig.for_bytes(H100_80GB // share)
    assert fib_route(m, fib_infos, cpu_log) == route


def _never_more_as_memory_grows(infos, logs_at) -> None:
    """From 1 GB to 1 TB of card memory: at every size 2^16..2^25 the
    streamed trees and the passes of a proof of ``infos`` at
    ``logs_at(size)`` never grow as M grows."""
    for log in range(16, 26):
        logs = logs_at(log)
        trees = stark._tree_bytes(stark.build_plan(logs, infos, tmach.TCFG),
                                  logs, 1)
        last = None
        for gb in range(1, 1001):
            streamed, passes, _held = card_route(
                T.MemoryConfig.for_bytes(gb * 10 ** 9), infos, logs, trees)
            if last is not None:
                assert streamed <= last[0] and max(passes) <= last[1], \
                    (log, gb)
            last = (streamed, max(passes))


def test_routes_never_stream_more_as_memory_grows(fib_infos):
    """From 1 GB to 1 TB of card memory: at every size of the fib CPU
    component the streamed trees and the passes never grow as M grows,
    the trees the proof's held bytes stream (`MemoryConfig.fitted`)
    included."""
    _never_more_as_memory_grows(fib_infos, lambda log: [log] + FIB_OTHER_LOGS)


def test_machine2_routes_never_stream_more_as_memory_grows(m2_infos):
    """The same for machine2's fib proof at every size of ex_alu."""
    _never_more_as_memory_grows(m2_infos, m2_logs)


@pytest.fixture(scope="module")
def m2_infos():
    """machine2's fib components, its largest family ex_alu first: 51
    main columns, 21 LogUp batches (84 interaction columns), 136
    natural columns."""
    from nexus_zkvm_tpu_torch.machine2 import build_components2
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    comps = build_components2(view)[0]
    assert comps[0].name == "ex_alu"
    return [component_info(c) for c in comps]


@pytest.fixture(scope="module")
def ex_alu_info(m2_infos):
    return m2_infos[0]


def m2_logs(log: int) -> list:
    """The log sizes of machine2's fib components with ex_alu at 2^log
    rows, as its proofs on the card have them (chip_smoke.py
    --time-memory's record at 16,777,200 steps: ex_alu at 2^24, the
    fifth family at 2^22, the rest at the sizes the program and its
    tables give)."""
    return [log, 3, 3, 3, log - 2, 3, 3, 3, 3, 3, 3, 3] + FIB_OTHER_LOGS


def test_fit_streams_machine2s_main_tree_at_ex_alu_2_24(m2_infos):
    """machine2's fib proof at 16,777,200 steps (ex_alu at 2^24 rows) on
    an 80 GB card: the thresholds alone stream its interaction tree and
    compose ex_alu in 2 passes, which holds more than 0.6 M beside a
    pass (that proof reserved 0.886 of the card); fitted, its main tree
    of 2^25 leaves streams too, and what it holds fits."""
    m = T.MemoryConfig.for_bytes(H100_80GB)
    logs = m2_logs(24)
    assert logs == [24, 3, 3, 3, 22, 3, 3, 3, 3, 3, 3, 3, 4, 5, 8, 11, 8,
                    3, 5, 3, 8, 7, 6, 3, 8, 8, 12, 11]
    streamed, passes, held = card_route(m, m2_infos, logs)
    assert streamed == {("main", 25), ("inter", 25)}
    assert max(passes) == 2 and held <= m.fit_bytes
    unfitted = T.MemoryConfig(**{**dataclasses.asdict(m),
                                 "fit_bytes": None})
    streamed, passes, held = card_route(unfitted, m2_infos, logs)
    assert streamed == {("inter", 25)}
    assert max(passes) == 2 and held > m.fit_bytes


@pytest.mark.parametrize("segment_log,passes", [(21, 1), (22, 2), (23, 4)])
def test_fit_keeps_the_segmented_routes(fib_infos, segment_log, passes):
    """fib at 2^24 steps in 2^21-, 2^22- and 2^23-step segments on an 80
    GB card: both trees stream by the thresholds alone, nothing more by
    the fit, in the measured passes, and what the proof holds beside its
    largest pass fits."""
    m = T.MemoryConfig.for_bytes(H100_80GB)
    k = 1 << (24 - segment_log)
    infos = fib_infos[:1] * k + fib_infos[1:]
    logs = [segment_log] * k + FIB_OTHER_LOGS
    streamed, got, held = card_route(m, infos, logs)
    assert {t for t in streamed if t[1] > 12} == {
        ("main", segment_log + 1), ("inter", segment_log + 1)}
    assert max(got) == passes and held <= m.fit_bytes
    plan = stark.build_plan(logs, infos, tmach.TCFG)
    assert stark._fitted(m, plan, infos, logs, 1, None, got) == m


def test_fit_leaves_the_cpu_and_the_mesh_as_they_are(fib_infos):
    """No fit bound on the CPU, and none under a mesh: their routes are
    the thresholds' alone."""
    logs = [20] + FIB_OTHER_LOGS
    plan = stark.build_plan(logs, fib_infos, tmach.TCFG)
    cpu = T.MemoryConfig()
    assert cpu.fit_bytes is None and cpu.fitted([1 << 40], 1 << 40, 0) == cpu
    card = T.MemoryConfig(stream_commit_bytes=3 << 30,
                          stream_chunk_bytes=1 << 26,
                          comp_nat_budget=1 << 33, fit_bytes=1)
    mesh = tmesh.Mesh(size=2, rank=0, device=torch.device("cpu"),
                      backend="gloo", per_card=2)
    assert stark._fitted(card, plan, fib_infos, logs, 1, mesh,
                         [1] * len(logs)) == card
    # without a mesh a bound that nothing meets streams every tree above
    # half the threshold: the CPU component's main (1.6 GB) and
    # interaction (2.0 GB) trees of 2^21 leaves
    fitted = stark._fitted(card, plan, fib_infos, logs, 1, None,
                           [1] * len(logs))
    evals, _fixed = stark._tree_bytes(plan, logs, 1)
    assert fitted.stream_commit_bytes == evals[("main", 21)] - 1
    assert [t for t, e in evals.items() if fitted.streams(e)] == [
        ("main", 21), ("inter", 21)]


# whether an 80 GB card's one-pass composition evaluates each role's LDE
# at once (`MemoryConfig.lde_whole`): fib's CPU component to 2^20 rows
# (at 2^21 whole it reserved 0.680 of the card, in chunks 0.508), and
# machine2's ex_alu to 2^22 (at 2^23 whole 0.962, in chunks 0.749)
@pytest.mark.parametrize("family,log,whole", [
    ("cpu", 20, True), ("cpu", 21, False),
    ("ex_alu", 22, True), ("ex_alu", 23, False)])
def test_one_pass_lde_at_once_by_size(fib_info, ex_alu_info, family, log,
                                      whole):
    info = {"cpu": fib_info, "ex_alu": ex_alu_info}[family]
    m = T.MemoryConfig.for_bytes(H100_80GB)
    nat = stark._natural_rows(info)
    assert m.comp_passes(nat, log + 2) == 1
    assert m.lde_whole(nat, stark._widest_role(info), log + 2) is whole


def test_one_pass_lde_in_chunks_keeps_the_proof():
    """A budget that holds every fib n = 10 component in one pass but
    not the keccak component's natural columns beside its widest role's
    whole LDE: keccak's LDE runs in column chunks, the proof is the
    reference's."""
    view, trace = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    memory = T.MemoryConfig(comp_nat_budget=2_300_000)
    comps, logs, _tr = tdriver.build_machine_traces(view, trace,
                                                    device="cpu")
    chunked = [c.name for c, n in zip(comps, logs) if not memory.lde_whole(
        stark._natural_rows(component_info(c)),
        stark._widest_role(component_info(c)), n + 2)]
    assert chunked == ["keccak"]
    with profiled() as prof:
        proof = tdriver.prove_machine(view, trace, tmach.TCFG, device="cpu",
                                      memory=memory)
    assert set(prof.notes["composition_passes"]) == {1}
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        tmach.FIB10_PROOF_BLAKE2S


def test_for_device_divides_the_card_among_its_ranks(monkeypatch):
    """On a card: total_memory over the mesh's ranks on that card."""
    props = type("Props", (), {"total_memory": H100_80GB})()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: props)
    assert T.MemoryConfig.for_device("cuda") == \
        T.MemoryConfig.for_bytes(H100_80GB)
    for per_card in (1, 2, 4):
        mesh = tmesh.Mesh(size=4, rank=0, device=torch.device("cuda", 0),
                          backend="gloo", per_card=per_card)
        assert T.MemoryConfig.for_device("cuda:0", mesh) == \
            T.MemoryConfig.for_bytes(H100_80GB // per_card)


@pytest.mark.parametrize("backend,where,per_card", [
    ("nccl", [("h", 0), ("h", 1)], 1),
    ("gloo", [("h", 0), ("h", 0), ("h", 1), ("h", 0)], 3),
    ("gloo", [("h", 0), ("g", 0)], 1)])
def test_mesh_counts_the_ranks_on_a_card(monkeypatch, backend, where,
                                         per_card):
    """NCCL takes a card a rank; gloo ranks count those on the same
    host and card."""
    monkeypatch.setattr(tmesh.socket, "gethostname", lambda: "h")

    def gather(out, obj, group=None):
        assert obj == ("h", 0)
        out[:] = where
    monkeypatch.setattr(tmesh.dist, "all_gather_object", gather)
    assert tmesh._per_card(torch.device("cuda", 0), backend, None,
                           len(where)) == per_card
    assert tmesh._per_card(torch.device("cpu"), "gloo", None, 4) == 1


def test_default_memory_resolves_per_device():
    """``memory=None`` on the CPU: the class defaults, noted on the
    profile with the route (nothing streamed, one pass), and the
    reference's fib n = 10 proof."""
    view, trace = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    with profiled() as prof:
        proof = tdriver.prove_machine(view, trace, tmach.TCFG, device="cpu")
    assert prof.notes["memory"] == dataclasses.asdict(T.MemoryConfig())
    assert prof.notes["cache_released"] is False
    assert prof.notes["streamed"] == []
    assert set(prof.notes["composition_passes"]) == {1}
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == \
        tmach.FIB10_PROOF_BLAKE2S


def test_split_limit_sets_and_restores_the_allocator(monkeypatch):
    """`utils.device.split_limit`: None leaves the caching allocator as
    it is; a size sets ``max_split_size_mb`` for the block and gives the
    process's own setting back after it, an error included."""
    from nexus_zkvm_tpu_torch.utils import device as tdevice
    calls = []
    monkeypatch.setattr(tdevice, "_allocator_setting", calls.append)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    with tdevice.split_limit(None):
        pass
    assert calls == []
    with tdevice.split_limit(H100_80GB // 64):
        assert calls == ["max_split_size_mb:1266"]
    assert calls[1:] == [f"max_split_size_mb:{(1 << 31) - 1}"]
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF",
                       "expandable_segments:False, max_split_size_mb:512")
    with pytest.raises(RuntimeError):
        with tdevice.split_limit(1 << 20):
            raise RuntimeError("out of memory")
    assert calls[2:] == ["max_split_size_mb:21", "max_split_size_mb:512"]
    # nested: the smaller limit inside, the outer one back after it
    del calls[:]
    with tdevice.split_limit(1 << 30):
        with tdevice.split_limit(1 << 32):
            pass
        with tdevice.split_limit(100 << 20):
            pass
    assert calls == ["max_split_size_mb:1024", "max_split_size_mb:1024",
                     "max_split_size_mb:1024", "max_split_size_mb:100",
                     "max_split_size_mb:1024", "max_split_size_mb:512"]


def test_device_constants_take_blocks_of_their_size(monkeypatch):
    """`utils.device.dev_const` uploads a constant to a card under a
    split limit of twice its bytes (never on the CPU), so a constant kept
    for the process's life pins no freed block of a trace's size."""
    from nexus_zkvm_tpu_torch.utils import device as tdevice
    seen = []

    @contextlib.contextmanager
    def limit(nbytes):
        seen.append(nbytes)
        yield
    monkeypatch.setattr(tdevice, "split_limit", limit)
    monkeypatch.setattr(tdevice, "_CACHE", {})
    got = tdevice.dev_const("test.words", 20, "cpu",
                            lambda: np.arange(1 << 20, dtype=np.uint32))
    assert got.dtype == torch.int32 and seen == [None]
    # a card's upload, the copy itself faked
    monkeypatch.setattr(torch.Tensor, "to", lambda self, device: self)
    tdevice.dev_const("test.index", 18, "cuda:0",
                      lambda: np.arange(1 << 18, dtype=np.int64))
    assert seen == [None, 2 * 8 << 18]
