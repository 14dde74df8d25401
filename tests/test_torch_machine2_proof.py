"""A machine2 proof on the port against the JAX package's.

The fib program of `tests/test_machine2.py` proved by the port's
`prove_machine2` on the CPU at that file's `CFG`: its bytes
(`sdk.serialize.proof_to_bytes`) equal the reference `prove_machine2`
proof's, held as a recorded digest (the reference takes about 15
minutes on XLA:CPU; the `slow` test recomputes it), it verifies, and it
is rejected for another claim, a flipped exit code, a tampered opening
and by machine v1's `verify_machine`.  Proved again with every size
group streamed and a component composed in row passes, its bytes are the
same.  The `slow` tests pin the keccak guest's and the `mext` program's
machine2 proofs to digests recorded from the JAX package (15 to 80 s of
one CPU process each, by the host's load).
"""

import copy
import hashlib

import numpy as np
import pytest

import chip_smoke
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch.machine import verify_machine
from nexus_zkvm_tpu_torch.machine2 import prove_machine2, verify_machine2
from nexus_zkvm_tpu_torch.sdk import bundle_from_bytes, bundle_to_bytes
from nexus_zkvm_tpu_torch.sdk.serialize import proof_to_bytes
from nexus_zkvm_tpu_torch.utils.profile import profiled
from nexus_zkvm_tpu_torch.vm import asm, k_trace
from test_torch_machine2 import EXIT, PROGRAMS
import torch_cpu  # noqa: F401  (one torch thread a test process)

FIB_SRC = PROGRAMS["fib"] + EXIT
TCFG = T.PcsConfig(pow_bits=2, fri=T.FriConfig(log_blowup=1,
                                               log_last_layer=0, n_queries=8))
# blake2s of the reference `machine2.prove_machine2(view, trace, CFG)`
# proof of FIB_SRC through `sdk.serialize.proof_to_bytes` (836,908
# bytes), recorded from the JAX package on XLA:CPU
FIB_M2_PROOF_BLAKE2S = \
    "cb0c718688e94c5a306080fca4579949693712050c1397a3e893df8178d8ebbc"
# every size group streamed (the main and interaction trees of the
# largest size too) in 16-column chunks, and the keccak component, the
# one with the most natural bytes, composed in 2 row passes
STREAM_PASSES = T.MemoryConfig(stream_commit_bytes=4096,
                               stream_chunk_bytes=1,
                               comp_nat_budget=1_200_000)
# blake2s of the reference `machine2.prove_machine2(view, trace, CFG)`
# proofs of chip_smoke.KECCAK_SRC (792,404 bytes) and of
# PROGRAMS["mext"] + EXIT (759,380 bytes), recorded the same way
KECCAK_M2_PROOF_BLAKE2S = \
    "abd3a047235aa6db30e9c932e37fea79d3369f6fc0d35bd905bcff53137d2d91"
MEXT_M2_PROOF_BLAKE2S = \
    "740e682aaddb4b4da7157c73da4b8c51682a650bedeaedd48c5f04123171cade"


@pytest.fixture(scope="module")
def fib_proof():
    view, trace = k_trace(asm.assemble(FIB_SRC), backend="python")
    return view, prove_machine2(view, trace, TCFG, device="cpu")


def test_machine2_proof_equals_reference_digest(fib_proof):
    _view, proof = fib_proof
    blob = proof_to_bytes(proof)
    assert len(blob) == 836_908
    assert hashlib.blake2s(blob).hexdigest() == FIB_M2_PROOF_BLAKE2S


def test_machine2_proof_verifies_through_a_bundle(fib_proof):
    view, proof = fib_proof
    view2, proof2 = bundle_from_bytes(bundle_to_bytes(view, proof))
    assert verify_machine2(view2, proof2, TCFG, device="cpu")


def test_machine2_proof_rejects_other_claims(fib_proof):
    view, proof = fib_proof
    other, _t = k_trace(asm.assemble(chip_smoke.OTHER_SRC))
    assert not verify_machine2(other, proof, TCFG, device="cpu")
    bad_view = copy.deepcopy(view)
    bad_view.exit_code = 1
    assert not verify_machine2(bad_view, proof, TCFG, device="cpu")


def test_machine2_proof_rejects_a_tampered_opening(fib_proof):
    view, proof = fib_proof
    bad = copy.deepcopy(proof)
    dec = bad.stark.openings["main"][0][1]
    dec.column_values[0] = np.array(dec.column_values[0])
    dec.column_values[0][0] = (int(dec.column_values[0][0]) + 1) % \
        ((1 << 31) - 1)
    assert not verify_machine2(view, bad, TCFG, device="cpu")


def test_machine_v1_rejects_a_machine2_proof(fib_proof):
    view, proof = fib_proof
    assert not verify_machine(view, proof, TCFG, device="cpu")


def test_machine2_streamed_proof_in_passes_equals_reference_digest():
    view, trace = k_trace(asm.assemble(FIB_SRC), backend="python")
    with profiled() as prof:
        proof = prove_machine2(view, trace, TCFG, device="cpu",
                               memory=STREAM_PASSES)
    blob = proof_to_bytes(proof)
    assert hashlib.blake2s(blob).hexdigest() == FIB_M2_PROOF_BLAKE2S
    s = max(proof.stark.log_sizes) + TCFG.fri.log_blowup
    assert {("main", s), ("inter", s)} <= set(prof.notes["streamed"])
    assert max(prof.notes["composition_passes"]) >= 2
    assert verify_machine2(view, proof, TCFG, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("guest", ["keccak", "mext"])
def test_machine2_guest_proof_equals_reference_digest(guest):
    src, want = {"keccak": (chip_smoke.KECCAK_SRC, KECCAK_M2_PROOF_BLAKE2S),
                 "mext": (PROGRAMS["mext"] + EXIT,
                          MEXT_M2_PROOF_BLAKE2S)}[guest]
    view, trace = k_trace(asm.assemble(src), backend="python")
    proof = prove_machine2(view, trace, TCFG, device="cpu")
    assert hashlib.blake2s(proof_to_bytes(proof)).hexdigest() == want
    assert verify_machine2(view, proof, TCFG, device="cpu")


@pytest.mark.slow
def test_machine2_proof_equals_reference_live(fib_proof):
    from nexus_zkvm_tpu.machine2 import prove_machine2 as rprove
    from nexus_zkvm_tpu.ops.fri import FriConfig as RFriConfig
    from nexus_zkvm_tpu.prover import PcsConfig as RPcsConfig
    from nexus_zkvm_tpu.sdk.serialize import proof_to_bytes as rbytes
    from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
    rcfg = RPcsConfig(pow_bits=2, fri=RFriConfig(
        log_blowup=1, log_last_layer=0, n_queries=8))
    view, trace = rk_trace(rasm.assemble(FIB_SRC), backend="python")
    want = rbytes(rprove(view, trace, rcfg))
    assert hashlib.blake2s(want).hexdigest() == FIB_M2_PROOF_BLAKE2S
    assert proof_to_bytes(fib_proof[1]) == want
