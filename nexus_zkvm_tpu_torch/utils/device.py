"""Device selection, numpy <-> tensor conversion and the device-constant cache.

Every entry point of the package takes ``device=`` (default ``"cuda"``)
and resolves it here.  A CUDA device that is not present raises: the
package never drops to the CPU on its own.  Pass ``device="cpu"`` to
run the plain PyTorch path.

Field values and Blake2s words are stored as ``torch.int32`` holding the
bit pattern of the ``uint32`` word; numpy sees them as ``uint32`` through
``.view``.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["resolve_device", "from_u32", "to_u32", "dev_const",
           "upload_i64", "split_limit"]


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_u32(arr, device) -> torch.Tensor:
    """numpy uint32 (or anything numpy can hold as uint32) -> int32 tensor."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 (same bits)."""
    assert t.dtype == torch.int32, t.dtype
    return t.detach().cpu().numpy().view(np.uint32)


_CACHE: dict = {}
_LOCK = threading.Lock()


def dev_const(name: str, log_size: int, device, build) -> torch.Tensor:
    """Device copy of ``build()`` cached under ``(name, log_size, device)``.

    ``build`` returns a numpy array: uint32 arrays become int32 tensors
    (same bits), integer index arrays become int64 tensors.  On a card
    the copy, kept for the process's life, takes a block of about its
    own size (`split_limit`): carved out of a freed block of a trace's
    size, it would keep the rest of that block from the card for good."""
    key = (name, int(log_size), str(torch.device(device)))
    with _LOCK:
        v = _CACHE.get(key)
    if v is None:
        arr = np.asarray(build())
        cuda = torch.device(device).type == "cuda"
        with split_limit(arr.nbytes * 2 if cuda else None):
            if arr.dtype == np.uint32:
                v = from_u32(arr, device)
            else:
                v = torch.from_numpy(np.ascontiguousarray(
                    arr, np.int64)).to(device)
        with _LOCK:
            _CACHE[key] = v
    return v


def upload_i64(arr, device) -> torch.Tensor:
    """An int64 array on ``device`` in one copy: to a CUDA device one
    non-blocking copy on the current stream from pinned memory, which
    PyTorch's caching host allocator hands out and reuses only once that
    copy is done; on the CPU the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)
                         .reshape(-1))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _allocator_setting(setting: str) -> None:
    put = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (put or torch.cuda.memory._set_allocator_settings)(setting)


def _own_split_mb() -> int:
    """The process's own ``max_split_size_mb`` (its
    ``PYTORCH_CUDA_ALLOC_CONF``), else one that splits any block (the
    most an int32 holds)."""
    for opt in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "").split(","):
        key, _sep, val = opt.partition(":")
        if key.strip() == "max_split_size_mb":
            return int(val)
    return (1 << 31) - 1


# the max_split_size_mb the innermost split_limit set (None: the
# process's own)
_SPLIT_MB = None


@contextmanager
def split_limit(nbytes):
    """The CUDA caching allocator's ``max_split_size`` for the enclosed
    block: a cached free block above ``nbytes`` (at least 21 MiB; within
    another such block, the smaller of the two) is never split to serve
    a smaller request, only one of about its size, so no long-lived
    small buffer pins it and an emptied cache gives it back to the card
    whole.  None: the allocator as it is.  The setting before comes back
    after."""
    global _SPLIT_MB
    if nbytes is None:
        yield
        return
    before = _SPLIT_MB
    _SPLIT_MB = max(21, nbytes >> 20)
    if before is not None:
        _SPLIT_MB = min(_SPLIT_MB, before)
    _allocator_setting(f"max_split_size_mb:{_SPLIT_MB}")
    try:
        yield
    finally:
        _SPLIT_MB = before
        _allocator_setting("max_split_size_mb:%d" % (
            _own_split_mb() if before is None else before))
