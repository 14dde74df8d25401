"""The M31 circle group, canonic cosets, evaluation domains and row orders.

Host numpy, identical to the JAX package's geometry:

* C(M31) = {(x, y) : x^2 + y^2 = 1} is cyclic of order 2^31 with
  generator ``G = (2, 1268011823)``.
* The domain of size N = 2^n is laid out ``D = [H | J(H)]`` with
  H[k] = (4k+1)·g, g of order 2^(n+1), J(x, y) = (x, -y).  Every circle
  FFT stage then pairs element k with element k + half of its chunk.
* Three row orders: natural (trace order, row r <-> (2r+1)·g), layout
  (what the FFT consumes) and committed (bit-reversed layout: the
  Merkle/FRI order).

``dev_*`` helpers return device copies through the device-constant cache.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .field import (P, np_m31_mul, np_m31_add, np_m31_sub, np_m31_inv,
                    np_qm31, np_qm31_add, np_qm31_sub, np_qm31_mul,
                    np_qm31_inv)
from ..utils.device import dev_const

CIRCLE_GEN = (2, 1268011823)
LOG_CIRCLE_ORDER = 31


def point_double(p):
    x, y = p
    return ((2 * x * x - 1) % P, (2 * x * y) % P)


def point_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return ((x1 * x2 - y1 * y2) % P, (x1 * y2 + y1 * x2) % P)


def point_neg(p):
    return (p[0], (P - p[1]) % P)


def point_mul(p, k: int):
    r = (1, 0)
    while k:
        if k & 1:
            r = point_add(r, p)
        p = point_double(p)
        k >>= 1
    return r


def subgroup_gen(log_order: int):
    """Generator of the subgroup of order 2^log_order."""
    return point_mul(CIRCLE_GEN, 1 << (LOG_CIRCLE_ORDER - log_order))


def _enumerate_coset(initial, step, log_len: int):
    """Points initial + k·step, k < 2^log_len, by doubling (uint64)."""
    n = 1 << log_len
    xs = np.empty(n, dtype=np.uint64)
    ys = np.empty(n, dtype=np.uint64)
    xs[0], ys[0] = initial
    size = 1
    offset = step
    while size < n:
        ox, oy = offset
        px, py = xs[:size], ys[:size]
        xs[size:2 * size] = np_m31_sub(np_m31_mul(px, np.uint64(ox)),
                                       np_m31_mul(py, np.uint64(oy)))
        ys[size:2 * size] = np_m31_add(np_m31_mul(px, np.uint64(oy)),
                                       np_m31_mul(py, np.uint64(ox)))
        offset = point_double(offset)
        size *= 2
    return xs, ys


class CircleDomain:
    """Canonic-coset evaluation domain of size 2^log_size with its FFT
    twiddles: stage 1 folds on y(H[k]); stage j >= 2 on
    pi^(j-2)(x(H[k])), pi(x) = 2x^2 - 1, each table half the last."""

    def __init__(self, log_size: int):
        assert 1 <= log_size <= 30
        self.log_size = log_size
        n = 1 << log_size
        g = subgroup_gen(log_size + 1)
        hx, hy = _enumerate_coset(g, point_mul(g, 4), log_size - 1)
        self.half_x = hx.astype(np.uint32)
        self.half_y = hy.astype(np.uint32)
        self.y_twiddles = self.half_y
        self.x_twiddle_stages = []
        if log_size >= 2:
            t = self.half_x[: n // 4].astype(np.uint64)
            self.x_twiddle_stages.append(t.astype(np.uint32))
            for _ in range(log_size - 2):
                t = t[: len(t) // 2]
                t = (2 * np_m31_mul(t, t) + (P - 1)) % P
                self.x_twiddle_stages.append(t.astype(np.uint32))
        self.inv_y_twiddles = np_m31_inv(self.y_twiddles).astype(np.uint32)
        self.inv_x_twiddle_stages = [np_m31_inv(t).astype(np.uint32)
                                     for t in self.x_twiddle_stages]

    def points(self):
        """All N points as (x, y) uint32 arrays in layout order."""
        x = np.concatenate([self.half_x, self.half_x])
        y = np.concatenate([self.half_y, (P - self.half_y.astype(np.uint64))
                            % P]).astype(np.uint32)
        return x, y


@lru_cache(maxsize=None)
def domain(log_size: int) -> CircleDomain:
    return CircleDomain(log_size)


@lru_cache(maxsize=None)
def bit_reverse_indices(log_n: int) -> np.ndarray:
    """perm[i] = bit-reversal of i over log_n bits (an involution)."""
    idx = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros(1 << log_n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def layout_to_natural(log_size: int) -> np.ndarray:
    """perm[l] = natural row index of layout position l."""
    n = 1 << log_size
    half = n // 2
    out = np.empty(n, dtype=np.int64)
    k = np.arange(half, dtype=np.int64)
    out[:half] = 2 * k
    out[half:] = 2 * (half - 1 - k) + 1
    return out


@lru_cache(maxsize=None)
def natural_to_layout(log_size: int) -> np.ndarray:
    inv = np.empty(1 << log_size, dtype=np.int64)
    inv[layout_to_natural(log_size)] = np.arange(1 << log_size)
    return inv


@lru_cache(maxsize=None)
def committed_points(log_size: int):
    """Domain (x, y) uint32 arrays in committed order."""
    x, y = domain(log_size).points()
    perm = bit_reverse_indices(log_size)
    return x[perm], y[perm]


def oods_point_from_felt(t):
    """QM31 t -> circle point ((1 - t^2)/(1 + t^2), 2t/(1 + t^2))."""
    t = np.asarray(t, np.uint64)
    t2 = np_qm31_mul(t, t)
    one = np_qm31(np.uint64(1))
    inv = np_qm31_inv(np_qm31_add(one, t2))
    return (np_qm31_mul(np_qm31_sub(one, t2), inv),
            np_qm31_mul(np_qm31_add(t, t), inv))


def qm31_point_add(p, q):
    x1, y1 = (np.asarray(c, np.uint64) for c in p)
    x2, y2 = (np.asarray(c, np.uint64) for c in q)
    return (np_qm31_sub(np_qm31_mul(x1, x2), np_qm31_mul(y1, y2)),
            np_qm31_add(np_qm31_mul(x1, y2), np_qm31_mul(y1, x2)))


def m31_point_as_qm31(p):
    return np_qm31(np.uint64(p[0])), np_qm31(np.uint64(p[1]))


# -- device copies -----------------------------------------------------------

def dev_bit_reverse(log_n: int, device):
    return dev_const("circle.brev", log_n, device,
                     lambda: bit_reverse_indices(log_n))


def dev_layout_to_natural(log_size: int, device):
    return dev_const("circle.l2n", log_size, device,
                     lambda: layout_to_natural(log_size))


def dev_committed_points(log_size: int, device):
    return (dev_const("circle.cpts.x", log_size, device,
                      lambda: committed_points(log_size)[0]),
            dev_const("circle.cpts.y", log_size, device,
                      lambda: committed_points(log_size)[1]))
