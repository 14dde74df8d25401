"""Blake2s-256 over batches of word-aligned messages (kernel K2).

Every Merkle layer hashes many equal-length messages: a leaf is the
row of column values at one position, a parent the 16 words of its two
child digests.  Messages are whole little-endian uint32 words (the
Blake2s native order); a W-word message is zero-padded to 16-word
blocks, with the byte counter of the last block at 4·W.

Three kernel entry points share one device compression
(``csrc/blake2s.cu``):

* :func:`hash_rows` — one message per row of an (R, W) view with any
  strides, so a (C, N) column matrix is hashed leaf-wise through its
  transpose without a copy;
* :func:`hash_parents` — a Merkle parent layer (2R, 8) -> (R, 8);
* :func:`leaves_stream` (kernel K10) — the leaves of a matrix that
  arrives in column chunks, each chunk's words absorbed into a Blake2s
  state carried from one chunk to the next.

On a CPU tensor the plain PyTorch version runs (int64 working values,
every rotation masked to 32 bits).  The numpy mirror is the verifier's
and the proof-of-work grinder's hasher.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .circle import brev_tile_plan, dev_bit_reverse

__all__ = ["hash_rows", "hash_parents", "hash_rows_plain", "leaves_stream",
           "leaves_stream_plain", "np_batch_compress",
           "np_batch_blake2s_words", "initial_state"]

_IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

# parameter block word 0 of an unkeyed 32-byte digest
_PARAM0 = np.uint32(0x01010020)

_SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
], dtype=np.int64)

# the 8 G mixes of a round: (a, b, c, d) state indices
_G_IDX = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))

_M32 = 0xFFFFFFFF


def initial_state() -> np.ndarray:
    h = _IV.copy()
    h[0] ^= _PARAM0
    return h


# ---------------------------------------------------------------------------
# Plain PyTorch version (int64 words in [0, 2^32))
# ---------------------------------------------------------------------------

def _ror(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_plain(h, m, t: int, last: bool):
    """h: list of 8 (R,) int64 words; m: list of 16 (R,) int64 words."""
    v = list(h) + [int(w) for w in _IV]
    v[12] = v[12] ^ (t & _M32)
    v[13] = v[13] ^ ((t >> 32) & _M32)
    if last:
        v[14] = v[14] ^ _M32
    for r in range(10):
        s = _SIGMA[r]
        for g, (a, b, c, d) in enumerate(_G_IDX):
            x, y = m[s[2 * g]], m[s[2 * g + 1]]
            v[a] = (v[a] + v[b] + x) & _M32
            v[d] = _ror(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _ror(v[b] ^ v[c], 12)
            v[a] = (v[a] + v[b] + y) & _M32
            v[d] = _ror(v[d] ^ v[a], 8)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _ror(v[b] ^ v[c], 7)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_rows_plain(msgs: torch.Tensor) -> torch.Tensor:
    """(R, W) int32 words -> (R, 8) int32 digests."""
    R, W = msgs.shape
    words = msgs.to(torch.int64) & _M32
    zero = torch.zeros(R, dtype=torch.int64, device=msgs.device)
    nblocks = max(1, -(-W // 16))
    h = [torch.full((R,), int(w), dtype=torch.int64, device=msgs.device)
         for w in initial_state()]
    for i in range(nblocks):
        m = [words[:, 16 * i + j] if 16 * i + j < W else zero
             for j in range(16)]
        last = i == nblocks - 1
        h = _compress_plain(h, m, 4 * W if last else 64 * (i + 1), last)
    return _to_int32(torch.stack(h, dim=1))


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return ((words ^ 0x80000000) - 0x80000000).to(torch.int32)


def _stream_blocks(c: int, last: bool) -> int:
    return -(-c // 16) if last else c // 16


def leaves_stream_plain(state, chunk: torch.Tensor, done: int, total: int,
                        last: bool) -> torch.Tensor:
    """Absorb one column chunk into the leaf states of a streamed
    commitment.  chunk: (c, M) int32 evaluations in layout order (leaf m
    reads row brev(m)); state: the (M, 8) int32 states after ``done``
    columns, or None before the first chunk; total: the matrix's column
    count.  Whole 16-word blocks only, but for the last chunk, whose
    final (zero-padded) block carries the byte count 4·total and the
    final flag.  Returns the new (M, 8) states: after the last chunk,
    the digests of ``hash_rows`` on the whole committed-order rows."""
    c, M = (int(x) for x in chunk.shape)
    log_m = M.bit_length() - 1
    words = chunk[:, dev_bit_reverse(log_m, chunk.device)].t() \
        .to(torch.int64) & _M32
    if state is None:
        h = [torch.full((M,), int(w), dtype=torch.int64, device=chunk.device)
             for w in initial_state()]
    else:
        st = state.to(torch.int64) & _M32
        h = [st[:, i] for i in range(8)]
    zero = torch.zeros(M, dtype=torch.int64, device=chunk.device)
    nb = _stream_blocks(c, last)
    for b in range(nb):
        m = [words[:, 16 * b + j] if 16 * b + j < c else zero
             for j in range(16)]
        fin = last and b == nb - 1
        h = _compress_plain(h, m, 4 * total if fin else
                            4 * (done + 16 * (b + 1)), fin)
    return _to_int32(torch.stack(h, dim=1))


# ---------------------------------------------------------------------------
# CUDA kernel K2 and the public entry points
# ---------------------------------------------------------------------------

def hash_rows(msgs: torch.Tensor) -> torch.Tensor:
    """Blake2s-256 of every row of an (R, W) int32 word matrix.  On CUDA
    the rows may be any strided view (e.g. the transpose of a column
    matrix); the kernel reads element (r, w) at r·stride_r + w·stride_w."""
    if msgs.dim() != 2:
        raise ValueError(f"expected an (R, W) matrix, got {tuple(msgs.shape)}")
    if msgs.is_cuda:
        kernels.check_cuda_tensor(msgs, "messages", ndim=2, contiguous=False)
        R, W = msgs.shape
        sr, sw = msgs.stride()
        if W == 0 or min(sr, sw) < 0:
            raise ValueError("messages need W >= 1 and non-negative strides")
        out = torch.empty((R, 8), dtype=torch.int32, device=msgs.device)
        if R:
            kernels.launch("blake2s_messages", msgs.data_ptr(),
                           out.data_ptr(), R, W, sr, sw, device=out.device)
        return out
    if msgs.device.type == "cpu":
        return hash_rows_plain(msgs)
    raise ValueError(f"unsupported device {msgs.device}")


def leaves_stream(state, chunk: torch.Tensor, done: int, total: int,
                  last: bool) -> torch.Tensor:
    """:func:`leaves_stream_plain`'s function: launches kernel K10 on a
    CUDA ``chunk`` (updating ``state`` in place, or a new one on the
    first chunk), runs the plain version on a CPU one."""
    if chunk.dim() != 2:
        raise ValueError(f"expected a (c, M) chunk, got {tuple(chunk.shape)}")
    c, M = (int(x) for x in chunk.shape)
    log_m = M.bit_length() - 1
    if c == 0 or M != 1 << log_m or (not last and c % 16) or \
            done + c > total or (last and done + c != total) or \
            (state is None) != (done == 0):
        raise ValueError(f"bad chunk {c} x {M} at column {done} of {total}")
    if chunk.is_cuda:
        kernels.check_cuda_tensor(chunk, "chunk", ndim=2)
        first = state is None
        if first:
            state = torch.empty((M, 8), dtype=torch.int32,
                                device=chunk.device)
        kernels.check_cuda_tensor(state, "state", ndim=2)
        if tuple(state.shape) != (M, 8):
            raise ValueError("state must be (M, 8)")
        kernels.launch("blake2s_leaves_stream", state.data_ptr(),
                       chunk.data_ptr(), M, log_m, c, done, total,
                       int(first), int(last), *brev_tile_plan(log_m),
                       device=chunk.device)
        return state
    if chunk.device.type == "cpu":
        return leaves_stream_plain(state, chunk, done, total, last)
    raise ValueError(f"unsupported device {chunk.device}")


def hash_parents(layer: torch.Tensor) -> torch.Tensor:
    """Merkle parent layer: (2R, 8) child digests -> (R, 8)."""
    if layer.dim() != 2 or layer.shape[1] != 8 or layer.shape[0] % 2:
        raise ValueError(f"expected a (2R, 8) layer, got {tuple(layer.shape)}")
    if layer.is_cuda:
        kernels.check_cuda_tensor(layer, "layer", ndim=2)
        if layer.data_ptr() % 16:
            raise ValueError("layer must be 16-byte aligned")
        R = layer.shape[0] // 2
        out = torch.empty((R, 8), dtype=torch.int32, device=layer.device)
        kernels.launch("blake2s_parents", layer.data_ptr(), out.data_ptr(),
                       R, device=layer.device)
        return out
    if layer.device.type == "cpu":
        return hash_rows_plain(layer.reshape(-1, 16))
    raise ValueError(f"unsupported device {layer.device}")


# ---------------------------------------------------------------------------
# Host numpy mirror (verifier, proof-of-work grinding)
# ---------------------------------------------------------------------------

def np_batch_compress(h, m, t: int, last: bool) -> np.ndarray:
    """h (B, 8) uint32 states, m (B, 16) uint32 blocks, t = byte counter
    after this block."""
    h = np.asarray(h, np.uint32)
    m = np.ascontiguousarray(m, np.uint32)
    B = h.shape[0]
    v = np.empty((B, 16), np.uint32)
    v[:, :8] = h
    v[:, 8:] = _IV
    v[:, 12] ^= np.uint32(t & _M32)
    v[:, 13] ^= np.uint32((t >> 32) & _M32)
    if last:
        v[:, 14] ^= np.uint32(_M32)

    def ror(x, n):
        return (x >> np.uint32(n)) | (x << np.uint32(32 - n))

    cols = [v[:, i] for i in range(16)]
    for r in range(10):
        s = _SIGMA[r]
        for g, (a, b, c, d) in enumerate(_G_IDX):
            x, y = m[:, s[2 * g]], m[:, s[2 * g + 1]]
            cols[a] = cols[a] + cols[b] + x
            cols[d] = ror(cols[d] ^ cols[a], 16)
            cols[c] = cols[c] + cols[d]
            cols[b] = ror(cols[b] ^ cols[c], 12)
            cols[a] = cols[a] + cols[b] + y
            cols[d] = ror(cols[d] ^ cols[a], 8)
            cols[c] = cols[c] + cols[d]
            cols[b] = ror(cols[b] ^ cols[c], 7)
    out = np.empty((B, 8), np.uint32)
    for i in range(8):
        out[:, i] = h[:, i] ^ cols[i] ^ cols[i + 8]
    return out


def np_batch_blake2s_words(msgs: np.ndarray) -> np.ndarray:
    """(B, W) uint32 messages -> (B, 8) uint32 digests (host)."""
    msgs = np.ascontiguousarray(msgs, np.uint32)
    B, w = msgs.shape
    nblocks = max(1, -(-w // 16))
    pad = nblocks * 16 - w
    if pad:
        msgs = np.concatenate([msgs, np.zeros((B, pad), np.uint32)], axis=1)
    h = np.broadcast_to(initial_state(), (B, 8)).copy()
    for i in range(nblocks):
        last = i == nblocks - 1
        h = np_batch_compress(h, msgs[:, 16 * i:16 * (i + 1)],
                              4 * w if last else 64 * (i + 1), last)
    return h
