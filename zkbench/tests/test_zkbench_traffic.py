"""Every seeded job lands on its rung, and the seed changes the order
and the values, not the work."""

import numpy as np
import pytest

from harness import spec

fib = spec.load_module("traffic", "fib")
SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 31 + 12_345, 3_000_000_011, 2 ** 40 + 3]
MIX = spec.load_cell("fib-v1.ladder").traffic


def test_octaves_by_hand():
    assert fib.n_band(12) == (408, 817)          # 2050 .. 4095 steps
    assert fib.n_band(19) == (52_427, 104_855)   # 262,145 .. 524,285
    for k in MIX["rungs"]:
        lo, hi = fib.n_band(k)
        assert fib.steps(lo - 1) <= 2 ** (k - 1) < fib.steps(lo)
        assert fib.steps(hi) <= 2 ** k < fib.steps(hi + 1)
        assert fib.rung_of(lo) == fib.rung_of(hi) == k


@pytest.mark.parametrize("seed", SEEDS)
def test_every_n_lands_on_a_rung_of_the_mix(seed):
    warm, ns = fib.schedule(seed, MIX)
    rungs = MIX["rungs"]
    assert sorted(fib.rung_of(n) for n in warm) == sorted(rungs * 2)
    block = len(rungs)
    for b in range(len(ns) // block):
        assert sorted(fib.rung_of(n) for n in ns[b * block:(b + 1) * block]) \
            == sorted(rungs)
    assert len(set(ns)) > len(ns) // 2
    assert fib.schedule(seed, MIX) == (warm, ns)


def test_seeds_change_the_order_not_the_work():
    """After every ``strata`` blocks each rung has drawn once from each
    slice of its octave, so the guest steps of any seed agree."""
    blocks = len(MIX["rungs"]) * MIX["strata"]
    for m in (1, 2, 4):
        works = [sum(fib.steps(n) for n in fib.schedule(s, MIX)[1]
                     [:m * blocks]) for s in SEEDS]
        assert (max(works) - min(works)) / np.mean(works) < 0.02
    orders = {tuple(fib.schedule(s, MIX)[1][:8]) for s in SEEDS}
    assert len(orders) == len(SEEDS)


def test_the_sample_holds_each_rung_and_the_longest():
    _warm, ns = fib.schedule(5, MIX)
    ns = ns[:100]
    picked = fib.sample(5, MIX, ns)
    assert picked == fib.sample(5, MIX, ns)
    rungs = [fib.rung_of(ns[i]) for i in picked]
    per = MIX["checked_per_rung"]
    assert all(rungs.count(k) == per for k in MIX["rungs"])
    assert max(range(len(ns)), key=lambda i: ns[i]) in picked
    assert fib.sample(5, MIX, []) == []


def test_steps_are_the_emulators():
    from nexus_zkvm_tpu_torch.sdk import LocalProver
    prover = LocalProver(fib.guest(), device="cpu")
    for n in (0, 1, 10, 408, 817):
        _view, trace = prover.trace(public_input=fib.public_input(n))
        assert trace.n_steps == fib.steps(n)


def test_a_block_is_one_job_a_rung():
    assert fib.block(MIX) == len(MIX["rungs"])
