"""Typed guest IO helpers.

Counterpart of the reference's postcard/COBS input encoding
(`nexus-zkvm/sdk/src/stwo/seq.rs:127-130`, guest-side typed reads
at `runtime/src/io.rs:14-70`): values are framed as little-endian u32
words; the VM exposes the tape to the guest length-prefixed at the
public-input sentinel (`vm/memory.py`).
"""

from __future__ import annotations

import struct

__all__ = ["encode_u32s", "decode_u32s", "encode_u64s", "decode_u64s",
           "encode_u128s", "decode_u128s", "encode_struct",
           "decode_struct", "encode_bytes", "decode_output"]


def encode_u32s(*values) -> bytes:
    return b"".join(struct.pack("<I", int(v) & 0xFFFFFFFF)
                    for v in values)


def decode_u32s(data: bytes, n: int | None = None):
    count = len(data) // 4 if n is None else n
    return list(struct.unpack(f"<{count}I", data[:4 * count]))


def encode_bytes(data: bytes) -> bytes:
    return bytes(data)


def decode_output(view, n_words: int | None = None):
    """Decode the guest's public output as u32 words."""
    return decode_u32s(view.public_output, n_words)


def encode_u64s(*values) -> bytes:
    """u64 scalars as two little-endian u32 words each (lo, hi) — the
    multi-word framing the reference round-trips via postcard
    (`nexus-zkvm/runtime/src/io.rs:14-70`, io_u64 tests)."""
    return b"".join(struct.pack("<Q", int(v) & (1 << 64) - 1)
                    for v in values)


def decode_u64s(data: bytes, n: int | None = None):
    count = len(data) // 8 if n is None else n
    return list(struct.unpack(f"<{count}Q", data[:8 * count]))


def encode_u128s(*values) -> bytes:
    """u128 scalars as four little-endian u32 words (least first)."""
    out = b""
    for v in values:
        v = int(v) & (1 << 128) - 1
        out += v.to_bytes(16, "little")
    return out


def decode_u128s(data: bytes, n: int | None = None):
    count = len(data) // 16 if n is None else n
    return [int.from_bytes(data[16 * i: 16 * (i + 1)], "little")
            for i in range(count)]


def encode_struct(fmt: str, *values) -> bytes:
    """Pack a fixed-layout struct (little-endian `struct` format
    codes, e.g. "IQB7s") and pad to a whole number of u32 words — the
    framing unit of the guest input tape."""
    raw = struct.pack("<" + fmt, *values)
    pad = (-len(raw)) % 4
    return raw + b"\x00" * pad


def decode_struct(fmt: str, data: bytes):
    """Unpack a struct encoded by `encode_struct` (ignores the word
    padding tail)."""
    return list(struct.unpack_from("<" + fmt, data, 0))
