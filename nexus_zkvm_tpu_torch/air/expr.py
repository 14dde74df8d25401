"""Felt: field-element expressions over M31/QM31 with a torch or numpy payload.

AIR constraints are written once against ``Felt`` operators and run
in two backends:

* :class:`TorchBackend` — interaction generation and composition over
  all rows (M31 payload (M,), QM31 (M, 4), int64 working values) on
  the backend's device;
* ``NP`` — the verifier's out-of-domain check on numpy scalars.

Mixed-kind arithmetic takes the cheap path (``qm31 * m31`` is four M31
products).  ``deg`` tracks the algebraic degree in committed columns so
that ``constraint()`` can enforce the composition degree bound.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field as F

__all__ = ["Felt", "TorchBackend", "NP"]


class TorchBackend:
    name = "torch"

    def __init__(self, device):
        self.device = torch.device(device)

    m31_add = staticmethod(F.m31_add)
    m31_sub = staticmethod(F.m31_sub)
    m31_mul = staticmethod(F.m31_mul)
    m31_neg = staticmethod(F.m31_neg)
    qm31_mul = staticmethod(F.qm31_mul)
    qm31_mul_m31 = staticmethod(F.qm31_mul_m31)
    embed = staticmethod(F.qm31_from_m31)

    def const(self, x):
        return torch.tensor(int(x) % F.P, dtype=torch.int64,
                            device=self.device)

    def qconst(self, x):
        return torch.as_tensor(np.asarray(x).astype(np.int64),
                               device=self.device)


class _NpBackend:
    name = "np"

    @staticmethod
    def m31_add(a, b):
        return F.np_m31_add(np.asarray(a, np.uint64), np.asarray(b, np.uint64))

    @staticmethod
    def m31_sub(a, b):
        return F.np_m31_sub(np.asarray(a, np.uint64), np.asarray(b, np.uint64))

    @staticmethod
    def m31_mul(a, b):
        return F.np_m31_mul(np.asarray(a, np.uint64), np.asarray(b, np.uint64))

    @staticmethod
    def m31_neg(a):
        return F.np_m31_neg(np.asarray(a, np.uint64))

    @staticmethod
    def qm31_mul(a, b):
        return F.np_qm31_mul(a, b)

    @staticmethod
    def qm31_mul_m31(q, m):
        return F.np_m31_mul(np.asarray(q, np.uint64),
                            np.asarray(m, np.uint64)[..., None])

    @staticmethod
    def embed(m):
        return F.np_qm31(np.asarray(m, np.uint64))

    @staticmethod
    def const(x):
        return np.uint64(int(x) % F.P)

    @staticmethod
    def qconst(x):
        return np.asarray(x, np.uint64)


NP = _NpBackend()


@dataclass
class Felt:
    v: object          # torch / numpy payload
    kind: str          # 'm31' | 'qm31'
    be: object         # TorchBackend or NP
    deg: int = 1       # algebraic degree in committed columns

    @staticmethod
    def const(x: int, be) -> "Felt":
        return Felt(be.const(x), "m31", be, deg=0)

    @staticmethod
    def qconst(x, be) -> "Felt":
        return Felt(be.qconst(x), "qm31", be, deg=0)

    def _coerce(self, o) -> "Felt":
        return o if isinstance(o, Felt) else Felt.const(int(o), self.be)

    def _addsub(self, o, fn):
        a, b = self, self._coerce(o)
        if a.kind == b.kind:
            return Felt(fn(a.v, b.v), a.kind, self.be, max(a.deg, b.deg))
        if a.kind == "m31":
            v = fn(self.be.embed(a.v), b.v)
        else:
            v = fn(a.v, self.be.embed(b.v))
        return Felt(v, "qm31", self.be, max(a.deg, b.deg))

    def __add__(self, o):
        return self._addsub(o, self.be.m31_add)

    def __radd__(self, o):
        return self._coerce(o).__add__(self)

    def __sub__(self, o):
        return self._addsub(o, self.be.m31_sub)

    def __rsub__(self, o):
        return self._coerce(o).__sub__(self)

    def __neg__(self):
        return Felt(self.be.m31_neg(self.v), self.kind, self.be, self.deg)

    def __mul__(self, o):
        a, b = self, self._coerce(o)
        deg = a.deg + b.deg
        if a.kind == "m31" and b.kind == "m31":
            return Felt(self.be.m31_mul(a.v, b.v), "m31", self.be, deg)
        if a.kind == "qm31" and b.kind == "qm31":
            return Felt(self.be.qm31_mul(a.v, b.v), "qm31", self.be, deg)
        q, m = (a, b) if a.kind == "qm31" else (b, a)
        return Felt(self.be.qm31_mul_m31(q.v, m.v), "qm31", self.be, deg)

    def __rmul__(self, o):
        return self.__mul__(o)

    def as_qm31(self) -> "Felt":
        if self.kind == "qm31":
            return self
        return Felt(self.be.embed(self.v), "qm31", self.be, self.deg)
