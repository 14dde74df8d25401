"""Mersenne-31 field arithmetic on torch tensors, plus numpy host mirrors.

The proving field stack (same encoding as the JAX package):

- ``M31``  : integers mod p = 2^31 - 1, canonical in [0, p).
- ``CM31`` : M31[i] / (i^2 + 1), trailing dim 2.
- ``QM31`` : CM31[u] / (u^2 - (2 + i)), trailing dim 4 ``[a, b, c, d]``
  meaning ``(a + b·i) + (c + d·i)·u``.

Storage is ``torch.int32`` (a canonical M31 value is < 2^31, so its
int32 bit pattern is the value itself).  The functions below are the
plain path: they accept int32 or int64 tensors of canonical values and
return int64 working values — one widening 64-bit product plus two
Mersenne folds and a final conditional subtract.  The final subtract is
not optional: (p - 1)^2 folded once gives 2^31, i.e. exactly p + 1.
Callers narrow back to int32 where they store.

The CUDA kernels use the same arithmetic in ``csrc/m31.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 31) - 1


def _i64(x):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int64 else x.to(torch.int64)
    return int(x)


def _fold(t):
    """int64 t in [0, 2^62] -> canonical [0, p)."""
    r = (t & P) + (t >> 31)            # < 2^32
    r = (r & P) + (r >> 31)            # <= p + 1
    return torch.where(r >= P, r - P, r)


# ---------------------------------------------------------------------------
# M31
# ---------------------------------------------------------------------------

def m31_reduce(x):
    """uint32 values (int64 in [0, 2^32)) -> canonical [0, p)."""
    x = _i64(x)
    x = (x & P) + (x >> 31)
    return torch.where(x >= P, x - P, x)


def m31_add(a, b):
    s = _i64(a) + _i64(b)
    return torch.where(s >= P, s - P, s)


def m31_sub(a, b):
    d = _i64(a) + (P - _i64(b))
    return torch.where(d >= P, d - P, d)


def m31_neg(a):
    a = _i64(a)
    return torch.where(a == 0, a, P - a)


def m31_mul(a, b):
    return _fold(_i64(a) * _i64(b))


def m31_fold_sum(x, dim: int = 0):
    """Modular sum along ``dim``: exact int64 sum, then one reduction.
    Canonical terms (< 2^31) keep the sum exact for up to 2^32 terms."""
    x = _i64(x)
    assert x.shape[dim] <= (1 << 32)
    return torch.remainder(x.sum(dim=dim), P)


def m31_pow(x, e: int):
    acc = None
    base = _i64(x)
    while e:
        if e & 1:
            acc = base if acc is None else m31_mul(acc, base)
        e >>= 1
        if e:
            base = m31_mul(base, base)
    return torch.ones_like(base) if acc is None else acc


def m31_inv(x):
    """x^(p-2) by the x^(2^k - 1) ladder (37 multiplies); inv(0) = 0."""
    x = _i64(x)
    t1 = m31_mul(m31_pow(x, 1 << 1), x)        # x^(2^2 - 1)
    t2 = m31_mul(m31_pow(t1, 1 << 1), x)       # x^(2^3 - 1)
    t3 = m31_mul(m31_pow(t2, 1 << 3), t2)      # x^(2^6 - 1)
    t4 = m31_mul(m31_pow(t3, 1 << 6), t3)      # x^(2^12 - 1)
    t5 = m31_mul(m31_pow(t4, 1 << 12), t4)     # x^(2^24 - 1)
    t6 = m31_mul(m31_pow(t5, 1 << 3), t2)      # x^(2^27 - 1)
    t7 = m31_mul(m31_pow(t6, 1 << 2), t1)      # x^(2^29 - 1)
    return m31_mul(m31_pow(t7, 1 << 2), x)     # x^(2^31 - 3)


# ---------------------------------------------------------------------------
# CM31: (..., 2)
# ---------------------------------------------------------------------------

def cm31_mul(a, b):
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    rr = m31_sub(m31_mul(ar, br), m31_mul(ai, bi))
    ri = m31_add(m31_mul(ar, bi), m31_mul(ai, br))
    return torch.stack([rr, ri], dim=-1)


def cm31_inv(a):
    ar, ai = a[..., 0], a[..., 1]
    ninv = m31_inv(m31_add(m31_mul(ar, ar), m31_mul(ai, ai)))
    return torch.stack([m31_mul(ar, ninv), m31_mul(m31_neg(ai), ninv)],
                       dim=-1)


# ---------------------------------------------------------------------------
# QM31: (..., 4)
# ---------------------------------------------------------------------------

def qm31_add(a, b):
    return m31_add(a, b)


def qm31_sub(a, b):
    return m31_sub(a, b)


def qm31_from_m31(x):
    x = _i64(x)
    z = torch.zeros_like(x)
    return torch.stack([x, z, z, z], dim=-1)


def _mul_by_r(x):
    """CM31 multiply by R = 2 + i."""
    xr, xi = x[..., 0], x[..., 1]
    return torch.stack([m31_sub(m31_add(xr, xr), xi),
                        m31_add(m31_add(xi, xi), xr)], dim=-1)


def qm31_mul(x, y):
    """(A + B·u)(C + D·u) = AC + R·BD + (AD + BC)·u."""
    xa, xb = x[..., 0:2], x[..., 2:4]
    ya, yb = y[..., 0:2], y[..., 2:4]
    ac = cm31_mul(xa, ya)
    bd = cm31_mul(xb, yb)
    ad_bc = m31_add(cm31_mul(xa, yb), cm31_mul(xb, ya))
    return torch.cat([m31_add(ac, _mul_by_r(bd)), ad_bc], dim=-1)


def qm31_mul_m31(x, s):
    return m31_mul(x, _i64(s)[..., None])


def qm31_inv(x):
    """1/(A + B·u) = (A - B·u) / (A^2 - R·B^2)."""
    xa, xb = x[..., 0:2], x[..., 2:4]
    dinv = cm31_inv(m31_sub(cm31_mul(xa, xa), _mul_by_r(cm31_mul(xb, xb))))
    return torch.cat([cm31_mul(xa, dinv), cm31_mul(m31_neg(xb), dinv)],
                     dim=-1)


# ---------------------------------------------------------------------------
# Host mirrors (numpy uint64): twiddle/point precompute and the verifier.
# ---------------------------------------------------------------------------

def np_m31_add(a, b):
    return (a.astype(np.uint64) + b.astype(np.uint64)) % np.uint64(P)


def np_m31_sub(a, b):
    return (a.astype(np.uint64) + np.uint64(P) - b.astype(np.uint64)) \
        % np.uint64(P)


def np_m31_mul(a, b):
    return (a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(P)


def np_m31_neg(a):
    return (np.uint64(P) - a.astype(np.uint64)) % np.uint64(P)


def np_m31_pow(x, e: int):
    x = np.asarray(x, dtype=np.uint64)
    acc = np.ones_like(x)
    while e:
        if e & 1:
            acc = np_m31_mul(acc, x)
        x = np_m31_mul(x, x)
        e >>= 1
    return acc


def np_m31_inv(x):
    return np_m31_pow(x, P - 2)


def np_cm31_mul(a, b):
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    rr = np_m31_sub(np_m31_mul(ar, br), np_m31_mul(ai, bi))
    ri = np_m31_add(np_m31_mul(ar, bi), np_m31_mul(ai, br))
    return np.stack([rr, ri], axis=-1)


def np_cm31_inv(a):
    a = np.asarray(a, np.uint64)
    ar, ai = a[..., 0], a[..., 1]
    ninv = np_m31_inv(np_m31_add(np_m31_mul(ar, ar), np_m31_mul(ai, ai)))
    return np.stack([np_m31_mul(ar, ninv),
                     np_m31_mul(np_m31_neg(ai), ninv)], axis=-1)


def _np_mul_by_r(x):
    xr, xi = x[..., 0], x[..., 1]
    rr = np_m31_sub(np_m31_add(xr, xr), xi)
    ri = np_m31_add(np_m31_add(xi, xi), xr)
    return np.stack([rr, ri], axis=-1)


def np_qm31(a, b=0, c=0, d=0):
    parts = np.broadcast_arrays(*(np.asarray(v, np.uint64) % np.uint64(P)
                                  for v in (a, b, c, d)))
    return np.stack(parts, axis=-1)


def np_qm31_add(a, b):
    return np_m31_add(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def np_qm31_sub(a, b):
    return np_m31_sub(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def np_qm31_neg(a):
    return np_m31_neg(np.asarray(a, np.uint64))


def _np_qm31_mul_scalar(x, y):
    """(4,) x (4,) in Python ints: numpy's per-op overhead on 4-element
    arrays dominates the verifier's scalar arithmetic otherwise."""
    a0, a1, a2, a3 = (int(t) for t in x)
    b0, b1, b2, b3 = (int(t) for t in y)
    ac0 = (a0 * b0 - a1 * b1) % P
    ac1 = (a0 * b1 + a1 * b0) % P
    bd0 = (a2 * b2 - a3 * b3) % P
    bd1 = (a2 * b3 + a3 * b2) % P
    hi0 = (a0 * b2 - a1 * b3 + a2 * b0 - a3 * b1) % P
    hi1 = (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P
    lo0 = (ac0 + 2 * bd0 - bd1) % P          # + R·bd, R = 2 + i
    lo1 = (ac1 + 2 * bd1 + bd0) % P
    return np.array([lo0, lo1, hi0, hi1], np.uint64)


def np_qm31_mul(x, y):
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    if x.shape == (4,) and y.shape == (4,):
        return _np_qm31_mul_scalar(x, y)
    xa, xb = x[..., 0:2], x[..., 2:4]
    ya, yb = y[..., 0:2], y[..., 2:4]
    ac = np_cm31_mul(xa, ya)
    bd = np_cm31_mul(xb, yb)
    ad_bc = np_m31_add(np_cm31_mul(xa, yb), np_cm31_mul(xb, ya))
    return np.concatenate([np_m31_add(ac, _np_mul_by_r(bd)), ad_bc], axis=-1)


def np_qm31_inv(x):
    x = np.asarray(x, np.uint64)
    xa, xb = x[..., 0:2], x[..., 2:4]
    denom = np_m31_sub(np_cm31_mul(xa, xa), _np_mul_by_r(np_cm31_mul(xb, xb)))
    dinv = np_cm31_inv(denom)
    return np.concatenate([np_cm31_mul(xa, dinv),
                           np_cm31_mul(np_m31_neg(xb), dinv)], axis=-1)


def np_qm31_conj(x):
    """Galois conjugation over CM31: u -> -u (negates coords 2, 3)."""
    x = np.asarray(x, np.uint64)
    return np.concatenate([x[..., 0:2], np_m31_neg(x[..., 2:4])], axis=-1)


def np_qm31_pow(x, e: int):
    x = np.asarray(x, np.uint64)
    acc = np_qm31(np.ones(x.shape[:-1], np.uint64))
    base = x
    while e:
        if e & 1:
            acc = np_qm31_mul(acc, base)
        base = np_qm31_mul(base, base)
        e >>= 1
    return acc
