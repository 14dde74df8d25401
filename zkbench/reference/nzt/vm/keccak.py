"""keccak-f[1600] permutation (host, for the custom instruction).

Counterpart of the reference's tiny-keccak-backed `KeccakFInstruction`
(`nexus-zkvm/vm/src/cpu/instructions/custom/keccakf.rs:10-80`):
the VM instruction reads a 25-lane u64 state as 50 u32 words at rs1,
permutes, and writes it back.
"""

from __future__ import annotations

__all__ = ["keccak_f1600", "keccak_f1600_words"]

M64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & M64


def keccak_f1600(lanes: list) -> list:
    """25 u64 lanes (row-major a[x][y] at index x + 5*y), permuted."""
    a = list(lanes)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y],
                                                        _ROT[x][y])
        # chi
        a = [b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & M64
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_words(words: list) -> list:
    """50 little-endian u32 words -> permuted 50 u32 words."""
    lanes = [(words[2 * i] | (words[2 * i + 1] << 32)) for i in range(25)]
    out = keccak_f1600(lanes)
    res = []
    for l in out:
        res.append(l & 0xFFFF_FFFF)
        res.append(l >> 32)
    return res
