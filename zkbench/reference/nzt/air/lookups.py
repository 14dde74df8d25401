"""LogUp lookup relations: channel-drawn (z, alpha) per relation.

A tuple (v_0..v_{w-1}) of a relation combines to the LogUp denominator
sum_j alpha^j·v_j - z (QM31); every component emitting or consuming the
tuple adds mult / combine(v) to its LogUp columns, and the grand sum
over all components must be zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.field import np_qm31_mul, np_qm31
from .expr import Felt

__all__ = ["LookupElements", "draw_relations"]


@dataclass
class LookupElements:
    name: str
    width: int
    z: np.ndarray            # (4,) uint64
    alpha_pows: np.ndarray   # (width, 4) uint64: alpha^0 .. alpha^(w-1)

    @classmethod
    def _from(cls, name, width, z, alpha):
        pows = [np_qm31(np.uint64(1))]
        for _ in range(width - 1):
            pows.append(np_qm31_mul(pows[-1], alpha))
        return cls(name=name, width=width, z=z,
                   alpha_pows=np.stack(pows, axis=0))

    @classmethod
    def draw(cls, channel, name: str, width: int) -> "LookupElements":
        z = np.asarray(channel.draw_felt(), np.uint64)
        alpha = np.asarray(channel.draw_felt(), np.uint64)
        return cls._from(name, width, z, alpha)

    @classmethod
    def dummy(cls, name: str, width: int) -> "LookupElements":
        """Deterministic stand-in for shape-collection runs."""
        return cls._from(name, width,
                         np_qm31(np.uint64(2), np.uint64(3), np.uint64(5),
                                 np.uint64(7)),
                         np_qm31(np.uint64(11), np.uint64(13), np.uint64(17),
                                 np.uint64(19)))

    def combine(self, values, be) -> Felt:
        """values: list[Felt] (len <= width) -> QM31 denominator Felt."""
        assert len(values) <= self.width, \
            f"relation {self.name}: tuple wider than {self.width}"
        acc = None
        for j, v in enumerate(values):
            if not isinstance(v, Felt):
                v = Felt.const(int(v), be)
            term = v if j == 0 else Felt.qconst(self.alpha_pows[j], be) * v
            acc = term if acc is None else acc + term
        return acc - Felt.qconst(self.z, be)


def draw_relations(channel, widths: dict) -> dict:
    """Draw all relations in canonical (sorted-name) order."""
    return {name: LookupElements.draw(channel, name, widths[name])
            for name in sorted(widths)}
