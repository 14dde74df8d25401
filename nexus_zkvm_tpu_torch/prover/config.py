"""Prover configuration: the frozen protocol constants and the memory mode.

Conjectured soundness is about n_queries·log_blowup + pow_bits bits.

:class:`MemoryConfig` decides only where the prover keeps its data, never
what it proves: the proof bytes are the same under any setting.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..ops.fri import FriConfig

__all__ = ["PcsConfig", "FriConfig", "MemoryConfig"]


@dataclass(frozen=True)
class PcsConfig:
    pow_bits: int = 16
    fri: FriConfig = field(default_factory=FriConfig)

    @property
    def security_bits(self) -> int:
        return self.pow_bits + self.fri.log_blowup * self.fri.n_queries


@dataclass(frozen=True)
class MemoryConfig:
    """The large-trace memory mode, chosen by size.

    * ``stream_commit_bytes``: a size group whose committed evaluations
      (C·2^s·4 bytes) exceed it is committed column-streamed: its
      evaluations are never kept, and the quotients and openings
      recompute them from the coefficients, ``stream_chunk_bytes`` of
      evaluations (at least 16 columns, a multiple of 16) at a time.  A
      natural-order group above it is interpolated in column chunks.
    * ``comp_nat_budget``: a component whose natural-order 4x-domain
      columns (main, preprocessed, interaction, is_first) exceed it is
      composed in row passes, each holding at most this many bytes (on
      a mesh rank: of its window's rows).

    Under a mesh nothing streams, as in the JAX package.

    The entry points take ``memory=None``, which is :meth:`for_device`.
    On the CPU that is the class defaults (2 GiB, 256 MiB, 8 GiB), the
    thresholds the CPU tests compare with the JAX package's routes.  On
    a CUDA card it is ``CARD_FRACTIONS`` of the card's memory M
    (``total_memory``, divided among the mesh ranks on the card): trees
    above M/8 stream, in chunks of M/64, and a composition runs in
    passes of at most M/4.  The fractions are the fastest routes that
    ``chip_smoke.py --time-memory`` measured within 0.85 M of reserved
    memory on an NVIDIA H100 80GB HBM3 at 700.00 W (M = 85,017,493,504
    bytes), for the fib guest's CPU component: resident in one pass at
    2^20 and 2^21 rows, resident in two passes at 2^22 (one pass runs
    out of memory), both trees streamed in four passes at 2^23 (the
    largest trace that card proves).  The route is a function of the
    shapes and M alone: no fallback after an out-of-memory error, no
    reading of what else the card holds.
    """
    stream_commit_bytes: int = 2 << 30
    stream_chunk_bytes: int = 1 << 28
    comp_nat_budget: int = 8 << 30

    @classmethod
    def for_bytes(cls, total: int) -> "MemoryConfig":
        """The thresholds for ``total`` bytes of card memory (one rank's
        share of a card)."""
        return cls(**{k: int(total * f) for k, f in CARD_FRACTIONS.items()})

    @classmethod
    def for_device(cls, device, mesh=None) -> "MemoryConfig":
        """The thresholds for ``device``: the class defaults on the CPU;
        on a CUDA card :meth:`for_bytes` of its ``total_memory`` over
        the ranks of ``mesh`` on that card (``Mesh.per_card``)."""
        dev = torch.device(device)
        if dev.type != "cuda":
            return cls()
        total = torch.cuda.get_device_properties(dev).total_memory
        return cls.for_bytes(total // (mesh.per_card if mesh else 1))

    def streams(self, nbytes: int) -> bool:
        return nbytes > self.stream_commit_bytes

    def chunk_cols(self, s: int) -> int:
        """Columns per streamed chunk of a 2^s domain."""
        return max(16, min(64, (self.stream_chunk_bytes // (4 << s)) & ~15))

    def comp_passes(self, n_cols: int, ev_log: int) -> int:
        """Row passes of a composition over n_cols natural columns of
        2^ev_log rows: the fewest powers of two within the budget."""
        passes = 1
        while n_cols * ((1 << ev_log) // passes) * 4 > self.comp_nat_budget \
                and passes < (1 << ev_log):
            passes *= 2
        return passes


# A card's thresholds, each field of MemoryConfig as a fraction of the
# card's memory (see MemoryConfig)
CARD_FRACTIONS = {"stream_commit_bytes": 1 / 8, "stream_chunk_bytes": 1 / 64,
                  "comp_nat_budget": 1 / 4}
