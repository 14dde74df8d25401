"""Multi-process initialization: the ``torch.distributed`` process group.

The JAX package joins JAX's multi-controller runtime; the port joins a
``torch.distributed`` process group, one process (rank) per device, and
builds its mesh over it (``parallel/mesh.py``).  This module is the
thin, idempotent entry point:

    from nexus_zkvm_tpu_torch.parallel import (init_distributed,
                                               make_mesh, use_mesh)
    init_distributed()                  # no-op for a single process
    with use_mesh(make_mesh()):         # every rank
        proof = prove_machine(view, trace)

Environment contract (the JAX package's, and torchrun's):
  NZT_COORDINATOR / JAX_COORDINATOR, or MASTER_ADDR:MASTER_PORT
                                        address of rank 0 (host:port)
  NZT_NUM_PROCESSES / JAX_NUM_PROCESSES / WORLD_SIZE
  NZT_PROCESS_ID / JAX_PROCESS_ID / RANK
  LOCAL_RANK                            the card of this rank (NCCL);
                                        the process id modulo the
                                        card count without it

The backend is NCCL for a CUDA device and gloo for the CPU.  NCCL
refuses two ranks on one card, so ranks that share a card ask for gloo
(``backend="gloo"``): their kernels still run on the card and their
collectives pass through host memory.  A backend that fails to start
raises; there is no other backend to fall back to.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_distributed", "process_info", "device"]

_DEVICE: list = []        # the device init_distributed was given


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def device() -> torch.device:
    """This rank's device: the one :func:`init_distributed` set, else
    ``cuda``."""
    return _DEVICE[0] if _DEVICE else torch.device("cuda")


def is_distributed() -> bool:
    """True once a process group of more than one rank is active."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """The JAX package's keys.  Every rank drives one device (ranks that
    share a card count once each)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_id": dist.get_rank() if dist.is_initialized() else 0,
            "n_processes": world, "local_devices": 1,
            "global_devices": world}


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device="cuda") -> dict:
    """Idempotently join the process group; returns :func:`process_info`.

    Explicit arguments win over the environment.  With no coordinator,
    or one process, nothing is started.  On NCCL the rank's card
    becomes the current CUDA device, so kernels and collectives of the
    rank run there."""
    if dist.is_initialized():
        return process_info()
    dev = torch.device(device)
    if coordinator is None:
        coordinator = _env("NZT_COORDINATOR", "JAX_COORDINATOR")
        if coordinator is None and _env("MASTER_ADDR") and _env("MASTER_PORT"):
            coordinator = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    n = int(num_processes if num_processes is not None else
            _env("NZT_NUM_PROCESSES", "JAX_NUM_PROCESSES", "WORLD_SIZE",
                 default=1))
    _DEVICE[:] = [dev]
    if coordinator is None or n <= 1:
        return process_info()
    pid = process_id if process_id is not None else _env(
        "NZT_PROCESS_ID", "JAX_PROCESS_ID", "RANK")
    if pid is None:
        raise ValueError("a process group needs this process's id "
                         "(NZT_PROCESS_ID or RANK)")
    pid = int(pid)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain path")
        if backend == "nccl":
            local = int(_env("LOCAL_RANK",
                             default=pid % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        _DEVICE[:] = [dev]
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=n, rank=pid)
    return process_info()
