"""Blake2s Fiat-Shamir channel (host, hashlib).

All prover and verifier randomness — lookup elements, the composition
alpha, the OODS point, FRI alphas, query positions — comes from this
transcript, so prover and verifier run the identical sequence of
``mix_*`` / ``draw_*`` calls.  The rules match the JAX package's
channel byte for byte:

* state: 32-byte digest, initially zero.
* ``mix_bytes(data)``  : digest = blake2s(digest || data)
* ``mix_u64(v)``       : mix_bytes(le64(v))
* ``mix_u32s(vs)``     : mix_bytes(concat le32(v))
* ``mix_felts(qm31s)`` : mix_bytes(concat le32 of the M31 coords)
* ``draw_*``           : block = blake2s(digest || le64(counter)),
  counter += 1 (reset when the digest changes).  M31s are drawn from
  each word by rejection (reject w >= 2p, then w mod p).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from .ops.field import P

__all__ = ["Blake2sChannel"]


class Blake2sChannel:
    def __init__(self):
        self.digest = b"\x00" * 32
        self._counter = 0

    def mix_bytes(self, data: bytes):
        self.digest = hashlib.blake2s(self.digest + bytes(data)).digest()
        self._counter = 0

    def mix_u64(self, v: int):
        self.mix_bytes(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def mix_u32s(self, vs):
        self.mix_bytes(np.asarray(vs, dtype="<u4").tobytes())

    def mix_felts(self, felts):
        """felts: array-like (..., 4) QM31s or (...,) M31s."""
        self.mix_bytes(np.asarray(felts, dtype="<u4").tobytes())

    def _next_block(self) -> bytes:
        out = hashlib.blake2s(
            self.digest + struct.pack("<Q", self._counter)).digest()
        self._counter += 1
        return out

    def draw_base_felts(self, n: int) -> np.ndarray:
        felts = []
        while len(felts) < n:
            for w in np.frombuffer(self._next_block(), dtype="<u4"):
                w = int(w)
                if w < 2 * P:
                    felts.append(w % P)
                if len(felts) == n:
                    break
        return np.asarray(felts, dtype=np.uint32)

    def draw_felt(self) -> np.ndarray:
        """One QM31 as a (4,) uint32 array."""
        return self.draw_base_felts(4)

    def draw_felts(self, n: int) -> np.ndarray:
        return self.draw_base_felts(4 * n).reshape(n, 4)

    def draw_queries(self, n: int, log_domain_size: int) -> list[int]:
        """n distinct sorted positions in [0, 2^log_domain_size)."""
        mask = (1 << log_domain_size) - 1
        seen = []
        while len(seen) < n:
            for w in np.frombuffer(self._next_block(), dtype="<u4"):
                q = int(w) & mask
                if q not in seen:
                    seen.append(q)
                if len(seen) == n:
                    break
        return sorted(seen)

    def check_pow_nonce(self, pow_bits: int, nonce: int) -> bool:
        h = hashlib.blake2s(self.digest + struct.pack("<Q", nonce)).digest()
        v = int.from_bytes(h[:8], "little")
        return (v & ((1 << pow_bits) - 1)) == 0 if pow_bits else True

    def grind_pow(self, pow_bits: int, max_iters: int = 1 << 32) -> int:
        """Find and mix the smallest nonce whose hash has pow_bits zero
        low bits, 2^16 candidates per numpy batch."""
        from .ops.blake2s import np_batch_blake2s_words
        if not pow_bits:
            self.mix_u64(0)
            return 0
        dw = np.frombuffer(self.digest, dtype="<u4")
        B = 1 << 16
        lo_mask = (1 << min(pow_bits, 32)) - 1
        hi_mask = (1 << max(pow_bits - 32, 0)) - 1
        base = 0
        while base < max_iters:
            n = np.arange(base, base + B, dtype=np.uint64)
            msgs = np.zeros((B, 10), np.uint32)
            msgs[:, :8] = dw
            msgs[:, 8] = (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            msgs[:, 9] = (n >> np.uint64(32)).astype(np.uint32)
            d = np_batch_blake2s_words(msgs)
            ok = (d[:, 0] & np.uint32(lo_mask)) == 0
            if hi_mask:
                ok &= (d[:, 1] & np.uint32(hi_mask)) == 0
            hits = np.flatnonzero(ok)
            if hits.size:
                nonce = base + int(hits[0])
                self.mix_u64(nonce)
                return nonce
            base += B
        raise RuntimeError("PoW grind exhausted")

    def mix_pow_nonce(self, pow_bits: int, nonce: int) -> bool:
        ok = self.check_pow_nonce(pow_bits, nonce)
        self.mix_u64(nonce)
        return ok
