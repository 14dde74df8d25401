"""numpy <-> tensor conversion and the device-constant cache.

Field values and Blake2s words are stored as ``torch.int32`` holding the
bit pattern of the ``uint32`` word; numpy sees them as ``uint32`` through
``.view``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["from_u32", "to_u32", "dev_const"]


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
        if arr.dtype == np.uint32:
            v = from_u32(arr, device)
        else:
            v = torch.from_numpy(np.ascontiguousarray(
                arr, np.int64)).to(device)
        with _LOCK:
            _CACHE[key] = v
    return v

