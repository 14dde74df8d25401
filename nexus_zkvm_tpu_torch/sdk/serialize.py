"""Proof (de)serialization: a compact explicit binary codec.

Counterpart of the reference's serde/postcard proof round-trip
(`nexus-zkvm/prover/src/machine.rs:93-98`, exercised by
`test_serialize_proofs`, `tests/testing-framework/src/lib.rs:721`).
Explicit field walking (no pickle) so the format is stable and safe to
deserialize from untrusted sources.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..machine import MachineProof
from ..ops import fri, merkle
from ..prover.stark import Proof, ROLE_ORDER

__all__ = ["proof_to_bytes", "proof_from_bytes",
           "view_to_bytes", "view_from_bytes",
           "bundle_to_bytes", "bundle_from_bytes"]

_MAGIC = b"NZTP"
_VERSION = 1
_VIEW_MAGIC = b"NZTV"
_BUNDLE_MAGIC = b"NZTB"


def _w_u32(b, v):
    b.write(struct.pack("<I", int(v)))


def _w_u64(b, v):
    b.write(struct.pack("<Q", int(v)))


def _w_arr(b, a, dtype):
    a = np.ascontiguousarray(np.asarray(a, dtype))
    _w_u32(b, a.ndim)
    for d in a.shape:
        _w_u32(b, d)
    b.write(a.tobytes())


def _r_u32(b):
    return struct.unpack("<I", b.read(4))[0]


def _r_u64(b):
    return struct.unpack("<Q", b.read(8))[0]


def _r_arr(b, dtype):
    nd = _r_u32(b)
    shape = tuple(_r_u32(b) for _ in range(nd))
    n = int(np.prod(shape)) if shape else 1
    itemsize = np.dtype(dtype).itemsize
    data = b.read(n * itemsize)
    return np.frombuffer(data, dtype).reshape(shape).copy()


def _w_dec(b, d: merkle.MerkleDecommitment):
    _w_u32(b, len(d.column_values))
    for v in d.column_values:
        _w_arr(b, v, "<u4")
    _w_u32(b, len(d.sibling_hashes))
    for h in d.sibling_hashes:
        _w_arr(b, h, "<u4")


def _r_dec(b) -> merkle.MerkleDecommitment:
    cols = [_r_arr(b, "<u4") for _ in range(_r_u32(b))]
    sibs = [_r_arr(b, "<u4") for _ in range(_r_u32(b))]
    return merkle.MerkleDecommitment(column_values=cols,
                                     sibling_hashes=sibs)


def proof_to_bytes(proof: MachineProof) -> bytes:
    p = proof.stark
    b = io.BytesIO()
    b.write(_MAGIC)
    _w_u32(b, _VERSION)
    _w_u32(b, len(p.log_sizes))
    for s in p.log_sizes:
        _w_u32(b, s)
    for role in ROLE_ORDER:
        entries = p.roots.get(role, [])
        _w_u32(b, len(entries))
        for s, root in entries:
            _w_u32(b, s)
            _w_arr(b, root, "<u4")
    _w_u32(b, len(p.claimed_sums))
    for cs in p.claimed_sums:
        _w_arr(b, cs, "<u8")
    _w_u32(b, len(p.sampled))
    for s in p.sampled:
        _w_arr(b, s, "<u8")
    fp = p.fri_proof
    _w_u32(b, len(fp.inner_roots))
    for r in fp.inner_roots:
        _w_arr(b, r, "<u4")
    _w_u32(b, len(fp.inner_decommitments))
    for d in fp.inner_decommitments:
        _w_dec(b, d)
    _w_arr(b, fp.last_layer, "<u4")
    _w_u64(b, p.pow_nonce)
    for role in ROLE_ORDER:
        entries = p.openings.get(role, [])
        _w_u32(b, len(entries))
        for s, d in entries:
            _w_u32(b, s)
            _w_dec(b, d)
    return b.getvalue()


def proof_from_bytes(data: bytes) -> MachineProof:
    b = io.BytesIO(data)
    if b.read(4) != _MAGIC:
        raise ValueError("not a proof blob")
    if _r_u32(b) != _VERSION:
        raise ValueError("unsupported proof version")
    log_sizes = [_r_u32(b) for _ in range(_r_u32(b))]
    roots = {}
    for role in ROLE_ORDER:
        roots[role] = [(_r_u32(b), _r_arr(b, "<u4"))
                       for _ in range(_r_u32(b))]
    claimed = [_r_arr(b, "<u8") for _ in range(_r_u32(b))]
    sampled = [_r_arr(b, "<u8") for _ in range(_r_u32(b))]
    inner_roots = [_r_arr(b, "<u4") for _ in range(_r_u32(b))]
    inner_decs = [_r_dec(b) for _ in range(_r_u32(b))]
    last_layer = _r_arr(b, "<u4")
    fp = fri.FriProof(inner_roots=inner_roots,
                      inner_decommitments=inner_decs,
                      last_layer=last_layer)
    pow_nonce = _r_u64(b)
    openings = {}
    for role in ROLE_ORDER:
        openings[role] = [(_r_u32(b), _r_dec(b))
                          for _ in range(_r_u32(b))]
    return MachineProof(stark=Proof(
        log_sizes=log_sizes, roots=roots, claimed_sums=claimed,
        sampled=sampled, fri_proof=fp, pow_nonce=pow_nonce,
        openings=openings))


# ---------------------------------------------------------------------------
# View serialization (the public claim)
# ---------------------------------------------------------------------------
# The reference ships the View with the proof so a third party can
# verify without re-executing the guest
# (`nexus-zkvm/sdk/src/stwo/seq.rs:141-147`).

def _w_bytes(b, data: bytes):
    _w_u32(b, len(data))
    b.write(bytes(data))


def _r_bytes(b) -> bytes:
    return b.read(_r_u32(b))


def view_to_bytes(view) -> bytes:
    lay = view.memory_layout
    b = io.BytesIO()
    b.write(_VIEW_MAGIC)
    _w_u32(b, _VERSION)
    for v in (lay.public_input, lay.exit_code, lay.public_output,
              lay.heap, lay.stack_bottom, lay.stack_top, lay.end):
        _w_u32(b, v)
    sr = lay.static_ram
    _w_u32(b, 1 if sr is not None else 0)
    if sr is not None:
        _w_u32(b, sr[0])
        _w_u32(b, sr[1])
    _w_u32(b, view.program_info.initial_pc)
    prog = view.program_info.program
    _w_u32(b, len(prog))
    _w_arr(b, np.asarray([pc for pc, _ in prog], np.uint32), "<u4")
    _w_arr(b, np.asarray([w for _, w in prog], np.uint32), "<u4")
    _w_bytes(b, view.public_input)
    _w_u32(b, int(view.exit_code) & 0xFFFFFFFF)
    _w_bytes(b, view.public_output)
    _w_bytes(b, view.associated_data)
    _w_u32(b, len(view.debug_logs))
    for log in view.debug_logs:
        _w_bytes(b, log)
    mem = view.initial_memory
    _w_u32(b, len(mem))
    _w_arr(b, np.asarray([a for a, _ in mem], np.uint32), "<u4")
    _w_arr(b, np.asarray([v for _, v in mem], np.uint8), "u1")
    return b.getvalue()


def view_from_bytes(data: bytes):
    from ..vm.memory import LinearMemoryLayout
    from ..vm.trace import View, ProgramInfo
    b = io.BytesIO(data)
    if b.read(4) != _VIEW_MAGIC:
        raise ValueError("not a view blob")
    if _r_u32(b) != _VERSION:
        raise ValueError("unsupported view version")
    (public_input, exit_code_a, public_output, heap, stack_bottom,
     stack_top, end) = (_r_u32(b) for _ in range(7))
    static_ram = None
    if _r_u32(b):
        static_ram = (_r_u32(b), _r_u32(b))
    lay = LinearMemoryLayout(
        public_input=public_input, exit_code=exit_code_a,
        public_output=public_output, heap=heap,
        stack_bottom=stack_bottom, stack_top=stack_top, end=end,
        static_ram=static_ram)
    lay.validate()
    initial_pc = _r_u32(b)
    n = _r_u32(b)
    pcs = _r_arr(b, "<u4")
    ws = _r_arr(b, "<u4")
    if len(pcs) != n or len(ws) != n:
        raise ValueError("corrupt program table")
    program = [(int(p), int(w)) for p, w in zip(pcs, ws)]
    public_input_b = _r_bytes(b)
    exit_code = _r_u32(b)
    public_output_b = _r_bytes(b)
    ad = _r_bytes(b)
    logs = [_r_bytes(b) for _ in range(_r_u32(b))]
    m = _r_u32(b)
    addrs = _r_arr(b, "<u4")
    vals = _r_arr(b, "u1")
    if len(addrs) != m or len(vals) != m:
        raise ValueError("corrupt initial memory")
    initial_memory = [(int(a), int(v)) for a, v in zip(addrs, vals)]
    return View(memory_layout=lay,
                program_info=ProgramInfo(initial_pc=initial_pc,
                                         program=program),
                public_input=public_input_b, exit_code=exit_code,
                public_output=public_output_b, associated_data=ad,
                debug_logs=logs, initial_memory=initial_memory)


def bundle_to_bytes(view, proof: MachineProof) -> bytes:
    """(View, proof) as one portable blob — everything a third party
    needs to verify without re-running the guest."""
    b = io.BytesIO()
    b.write(_BUNDLE_MAGIC)
    _w_u32(b, _VERSION)
    _w_bytes(b, view_to_bytes(view))
    _w_bytes(b, proof_to_bytes(proof))
    return b.getvalue()


def bundle_from_bytes(data: bytes):
    b = io.BytesIO(data)
    if b.read(4) != _BUNDLE_MAGIC:
        raise ValueError("not a proof bundle")
    if _r_u32(b) != _VERSION:
        raise ValueError("unsupported bundle version")
    view = view_from_bytes(_r_bytes(b))
    proof = proof_from_bytes(_r_bytes(b))
    return view, proof
