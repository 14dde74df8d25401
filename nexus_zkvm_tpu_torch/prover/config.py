"""Prover configuration: the frozen protocol constants.

Conjectured soundness is about n_queries·log_blowup + pow_bits bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.fri import FriConfig

__all__ = ["PcsConfig", "FriConfig"]


@dataclass(frozen=True)
class PcsConfig:
    pow_bits: int = 16
    fri: FriConfig = field(default_factory=FriConfig)

    @property
    def security_bits(self) -> int:
        return self.pow_bits + self.fri.log_blowup * self.fri.n_queries
