"""The memory mode's thresholds by device (`MemoryConfig.for_device`).

On the CPU the thresholds are the class defaults, the ones the CPU tests
compare with the JAX package's routes.  On a card they are fractions of
its memory M (`prover.config.CARD_FRACTIONS`), shared among the mesh
ranks on that card; the routes they give the fib guest's CPU component
at 2^20 to 2^23 rows are the ones `chip_smoke.py --time-memory` measured
fastest within 0.85 M on an H100 80GB HBM3.  Pure functions and the
fib n = 10 fixture only.
"""

import dataclasses
import hashlib

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

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100
# 80GB HBM3 (chip_smoke.py --time-memory)
H100_80GB = 85_017_493_504


@pytest.fixture(scope="module")
def fib_info():
    """The fib guest's CPU component: 193 main columns, 61 LogUp
    batches (244 interaction columns), 438 natural 4x-domain columns
    (its column counts are the same at every trace size)."""
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    return component_info(tdriver.build_components(view, 1)[0][0])


def fib_route(memory: T.MemoryConfig, info, cpu_log: int) -> tuple:
    """(streamed roles, composition passes) of the fib CPU component at
    2^cpu_log rows under ``memory``."""
    s = cpu_log + 1
    streamed = tuple(role for role, cols in (
        ("main", info.n_main), ("inter", 4 * info.n_logup_cols))
        if memory.streams(cols * (4 << s)))
    return streamed, memory.comp_passes(stark._natural_rows(info),
                                        cpu_log + 2)


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
def test_card_route_by_size(fib_info, cpu_log):
    """An 80 GB card's thresholds give the fib component the measured
    fastest route that fits at every size."""
    m = T.MemoryConfig.for_bytes(H100_80GB)
    assert fib_route(m, fib_info, cpu_log) == CARD_ROUTES[cpu_log]


@pytest.mark.parametrize("share,cpu_log,route", [
    # half a card: 2^21 like the whole card's 2^22
    (2, 20, ((), 1)), (2, 21, ((), 2)), (2, 22, (("main", "inter"), 4)),
    # a quarter
    (4, 20, ((), 2)), (4, 21, (("main", "inter"), 4)),
    (4, 22, (("main", "inter"), 8))])
def test_card_route_at_a_share_of_the_card(fib_info, share, cpu_log, route):
    """A half and a quarter of the card (ranks sharing it): a size takes
    the route that the whole card gives a size share times larger."""
    m = T.MemoryConfig.for_bytes(H100_80GB // share)
    assert fib_route(m, fib_info, cpu_log) == route


def test_routes_never_stream_more_as_memory_grows(fib_info):
    """From 1 GB to 1 TB of card memory: at every size the streamed
    roles and the passes never grow as M grows."""
    for cpu_log in range(16, 26):
        last = None
        for gb in range(1, 1001):
            streamed, passes = fib_route(
                T.MemoryConfig.for_bytes(gb * 10 ** 9), fib_info, cpu_log)
            if last is not None:
                assert set(streamed) <= set(last[0]) and passes <= last[1]
            last = (streamed, passes)


@pytest.fixture(scope="module")
def ex_alu_info():
    """machine2's largest family, ex_alu: 51 main columns, 21 LogUp
    batches (84 interaction columns), 136 natural columns."""
    from nexus_zkvm_tpu_torch.machine2 import build_components2
    view, _t = tk_trace(tasm.assemble(tmach.FIB10_SRC), backend="python")
    return component_info(next(c for c in build_components2(view)[0]
                               if c.name == "ex_alu"))


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
