"""Meshes over a ``torch.distributed`` process group.

The JAX package's mesh is a one-axis grid of devices (``AXIS``).  The
port's is a process group: each member (a rank) drives one device and
holds one shard of the sharded work.  Its collectives:

* :meth:`Mesh.all_gather` / :meth:`Mesh.gather_flat`: every rank's
  tensor, concatenated in rank order;
* :meth:`Mesh.all_to_all`: rank r's piece j goes to rank j (the row
  windows of a commit);
* :meth:`Mesh.all_reduce`: the int32 sum of tensors in which at most
  one rank holds a nonzero word at each place (a disjoint sum: the
  openings' buffer, the OODS samples), so the sum is exact;
* :meth:`Mesh.broadcast`: one rank's tensor to every rank (coefficient
  chunks of the composition).

Transport: on the NCCL backend the collectives run on the CUDA tensors.
On gloo with CUDA tensors they stage through the host on purpose: a copy
to pinned host memory, the collective there, a copy back to the device.
That is the route for several ranks sharing one card, where NCCL refuses
two ranks on one GPU.  Every message goes in pieces of at most
``_PIECE`` words a rank, under 2^31 bytes.  A collective that fails
raises; none falls back to another route.  A mesh of size 1 needs no
process group, and its collectives are the identity.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import distributed

__all__ = ["AXIS", "Mesh", "make_mesh", "local_mesh"]

AXIS = "shard"

# words a rank sends in one collective call: a large message goes in
# pieces, so no single message nears 2^31 bytes
_PIECE = 1 << 26


def _pieces(n: int, step: int):
    """[lo, hi) spans of at most ``step`` (at least 1) of n words."""
    step = max(1, step)
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


@dataclass(frozen=True)
class Mesh:
    size: int
    rank: int
    device: torch.device      # the device this rank drives
    backend: str | None       # "nccl" or "gloo"; None for a local mesh
    group: object = None      # None: the default (world) group
    per_card: int = 1         # ranks of the mesh on this rank's card

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend != "nccl"

    def _send(self, t: torch.Tensor, copy: bool = True) -> torch.Tensor:
        """``t`` where the transport reads it: a pinned host copy for
        gloo with a CUDA tensor (left unwritten without ``copy``: a
        buffer to receive into), else ``t`` made contiguous."""
        if not self._staged(t):
            return t.contiguous()
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if copy:
            src.copy_(t)
        return src

    def gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(n,) on every rank -> (size, n), row r from rank r, where the
        transport lands it: on the device for NCCL (and for CPU
        tensors), in host memory for gloo with a CUDA tensor."""
        if flat.dim() != 1:
            raise ValueError(f"expected a flat tensor, got {tuple(flat.shape)}")
        if self.size == 1:
            return flat[None]
        staged = self._staged(flat)
        src = self._send(flat)
        out = torch.empty((self.size, src.numel()), dtype=src.dtype,
                          device=src.device, pin_memory=staged)
        for lo, hi in _pieces(src.numel(), _PIECE):
            dist.all_gather([out[r, lo:hi] for r in range(self.size)],
                            src[lo:hi], group=self.group)
        return out

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """(size, n) on every rank -> (size, n) on ``send``'s device: row
        r of rank j's result is row j of rank r's ``send``."""
        if send.dim() != 2 or send.shape[0] != self.size:
            raise ValueError(f"expected ({self.size}, n), got "
                             f"{tuple(send.shape)}")
        if self.size == 1:
            return send
        src = self._send(send)
        out = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                          pin_memory=self._staged(send))
        spans = _pieces(int(src.shape[1]), _PIECE // self.size)
        for lo, hi in spans:
            a, b = ((src, out) if len(spans) == 1 else
                    (src[:, lo:hi].contiguous(),
                     torch.empty((self.size, hi - lo), dtype=src.dtype,
                                 device=src.device)))
            dist.all_to_all_single(b, a, group=self.group)
            if b is not out:
                out[:, lo:hi] = b
        return out.to(send.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of an int32 tensor over the ranks, on
        ``t``'s device.  Exact where at most one rank holds a nonzero
        word at each place (a disjoint sum); ``t`` is not modified."""
        if t.dtype != torch.int32:
            raise ValueError(f"a disjoint sum of int32, got {t.dtype}")
        if self.size == 1:
            return t
        src = self._send(t)
        if src is t:
            src = t.clone()
        flat = src.reshape(-1)
        for lo, hi in _pieces(flat.numel(), _PIECE):
            dist.all_reduce(flat[lo:hi], group=self.group)
        return src.to(t.device)

    def broadcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``t`` on every rank, on ``t``'s device (the
        other ranks pass a tensor of the same shape and dtype to fill)."""
        if self.size == 1:
            return t
        buf = self._send(t, copy=self.rank == root)
        flat = buf.reshape(-1)
        src = root if self.group is None else \
            dist.get_global_rank(self.group, root)
        for lo, hi in _pieces(flat.numel(), _PIECE):
            dist.broadcast(flat[lo:hi], src, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(k, ...) on every rank -> (size * k, ...) on ``t``'s device:
        the ranks' tensors concatenated along dim 0 in rank order."""
        if self.size == 1:
            return t
        out = self.gather_flat(t.reshape(-1)).to(t.device)
        return out.reshape((self.size * int(t.shape[0]),) + tuple(t.shape[1:]))


def make_mesh(n_devices: int | None = None) -> Mesh | None:
    """A mesh of the first ``n_devices`` ranks of the process group that
    :func:`init_distributed` joined (all of them by default), each rank
    on the device ``init_distributed`` gave it.  Every rank must call
    it; a rank outside the mesh gets None.  Without a process group
    only a mesh of one can be made."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} ranks needs "
                               "init_distributed() first")
        return local_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, have {world}")
    # new_group is collective: every rank creates it, members or not
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    if n == 1:
        return local_mesh()
    dev, backend = distributed.device(), dist.get_backend(group)
    return Mesh(size=n, rank=rank, device=dev, backend=backend, group=group,
                per_card=_per_card(dev, backend, group, n))


def _per_card(dev: torch.device, backend: str, group, n: int) -> int:
    """The mesh's ranks on ``dev``'s card (collective): one on NCCL,
    which takes a card a rank; on gloo the ranks whose (host, card) is
    this rank's."""
    if dev.type != "cuda" or backend == "nccl":
        return 1
    me = (socket.gethostname(), torch.cuda.current_device()
          if dev.index is None else dev.index)
    every = [None] * n
    dist.all_gather_object(every, me, group=group)
    return every.count(me)


def local_mesh() -> Mesh:
    """The mesh of this process alone (the degenerate case)."""
    return Mesh(size=1, rank=0, device=distributed.device(), backend=None)
