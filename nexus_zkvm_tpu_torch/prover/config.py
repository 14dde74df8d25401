"""Prover configuration: the frozen protocol constants and the memory mode.

Conjectured soundness is about n_queries·log_blowup + pow_bits bits.

:class:`MemoryConfig` decides only where the prover keeps its data, never
what it proves: the proof bytes are the same under any setting.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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

    The defaults stream at the JAX package's thresholds (2 GiB, 256 MiB),
    so both packages take the same route at every size.  The budget keeps
    the fib guest's 2^20-row CPU component (438 columns × 2^22 × 4 B =
    7.35 GB) in one pass and splits 2^21 into 2 and 2^22 into 4.
    """
    stream_commit_bytes: int = 2 << 30
    stream_chunk_bytes: int = 1 << 28
    comp_nat_budget: int = 8 << 30

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
