"""Meshes over a ``torch.distributed`` process group.

The JAX package's mesh is a one-axis grid of devices (``AXIS``).  The
port's is a process group: each member (a rank) drives one device and
holds one shard of the sharded work.  The slice needs one collective,
:meth:`Mesh.all_gather`, which concatenates every rank's tensor along
dim 0 in rank order.

Transport: on the NCCL backend the gather runs on the CUDA tensors.  On
gloo with CUDA tensors it stages through the host on purpose: a copy to
pinned host memory, the gather there, a copy back to the device.  That
is the route for several ranks sharing one card, where NCCL refuses two
ranks on one GPU.  A mesh of size 1 needs no process group, and its
gather is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import distributed

__all__ = ["AXIS", "Mesh", "make_mesh", "local_mesh"]

AXIS = "shard"

# words a rank sends in one collective call: a large gather goes in
# pieces, so no single message nears 2^31 bytes
_PIECE = 1 << 26


@dataclass(frozen=True)
class Mesh:
    size: int
    rank: int
    device: torch.device      # the device this rank drives
    backend: str | None       # "nccl" or "gloo"; None for a local mesh
    group: object = None      # None: the default (world) group

    def gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(n,) on every rank -> (size, n), row r from rank r, where the
        transport lands it: on the device for NCCL (and for CPU
        tensors), in host memory for gloo with a CUDA tensor."""
        if flat.dim() != 1:
            raise ValueError(f"expected a flat tensor, got {tuple(flat.shape)}")
        if self.size == 1:
            return flat[None]
        staged = flat.is_cuda and self.backend != "nccl"
        if staged:
            src = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            src.copy_(flat)
        else:
            src = flat.contiguous()
        out = torch.empty((self.size, src.numel()), dtype=src.dtype,
                          device=src.device, pin_memory=staged)
        for lo in range(0, src.numel(), _PIECE):
            hi = min(lo + _PIECE, src.numel())
            dist.all_gather([out[r, lo:hi] for r in range(self.size)],
                            src[lo:hi], group=self.group)
        return out

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
    return Mesh(size=n, rank=rank, device=distributed.device(),
                backend=dist.get_backend(group), group=group)


def local_mesh() -> Mesh:
    """The mesh of this process alone (the degenerate case)."""
    return Mesh(size=1, rank=0, device=distributed.device(), backend=None)
