"""DEEP quotients at the queried points.

For a sample (f, z, v) the quotient is

    q(p) = (c·f(p) - a·y_p - b) / V_z(p),
    c = conj(y_z) - y_z,  a = conj(v) - v,  b = v·c - a·y_z,
    V_z(p) = dy·(x_p - x_z) - dx·(y_p - y_z),
    dx = x_z - conj(x_z), dy = y_z - conj(y_z),

and all quotients of one committed size are combined with powers of a
channel-drawn gamma.  ``QuotientsAt`` evaluates that combination at the
opened positions from the opened column values (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .field import (P, np_qm31_add, np_qm31_sub, np_qm31_mul, np_qm31_inv,
                    np_qm31_conj, np_qm31_pow, np_m31_mul, np_qm31)
from .circle import committed_points

__all__ = ["PointSample", "n_terms", "QuotientsAt"]



@dataclass
class PointSample:
    """One OODS point and the columns of a size group sampled at it."""
    point: tuple      # (x, y), each a (4,) QM31
    columns: list     # indices into the size group's column list
    values: list      # claimed f_k(z), one (4,) QM31 per column


def _denominator_coeffs(z_x, z_y):
    z_x = np.asarray(z_x, np.uint64)
    z_y = np.asarray(z_y, np.uint64)
    return (np_qm31_sub(z_x, np_qm31_conj(z_x)),
            np_qm31_sub(z_y, np_qm31_conj(z_y)))


def n_terms(samples) -> int:
    return sum(len(s.columns) for s in samples)


def _gamma_powers(gamma, k0: int, k: int) -> np.ndarray:
    """(k, 4): gamma^k0 .. gamma^(k0 + k - 1)."""
    gamma = np.asarray(gamma, np.uint64)
    p = np.zeros((max(1, k), 4), np.uint64)
    p[0] = np_qm31(np.uint64(1))
    step = 1
    while step < k:
        m = min(step, k - step)
        p[step:step + m] = np_qm31_mul(p[:m], np_qm31_pow(gamma, step)[None])
        step *= 2
    if k0:
        p = np_qm31_mul(p, np_qm31_pow(gamma, k0)[None, :])
    return p[:k]


def _sample_coeffs(sample: PointSample, g: np.ndarray):
    """gcs (K, 4), A (4,), B (4,) for one sample with gamma powers g."""
    z_y = np.asarray(sample.point[1], np.uint64)
    V = (np.stack([np.asarray(v, np.uint64) for v in sample.values])
         if sample.values else np.zeros((0, 4), np.uint64))
    c = np_qm31_sub(np_qm31_conj(z_y), z_y)
    a = np_qm31_sub(np_qm31_conj(V), V)
    b = np_qm31_sub(np_qm31_mul(V, c[None, :]), np_qm31_mul(a, z_y[None, :]))
    gcs = np_qm31_mul(g, c[None, :])
    A = np_qm31_mul(g, a).sum(axis=0) % np.uint64(P)
    B = np_qm31_mul(g, b).sum(axis=0) % np.uint64(P)
    return gcs, A, B


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# CUDA kernel K3 and the public entry points
# ---------------------------------------------------------------------------


class QuotientsAt:
    """Verifier recompute of the combined quotient at opened positions
    (host numpy); per-sample constants are built once."""

    def __init__(self, log_size: int, samples, gamma, gamma_offset: int = 0):
        xs, ys = committed_points(log_size)
        self.xs = np.asarray(xs, np.uint64)
        self.ys = np.asarray(ys, np.uint64)
        self.pre = []
        k0 = gamma_offset
        for s in samples:
            z_x = np.asarray(s.point[0], np.uint64)
            z_y = np.asarray(s.point[1], np.uint64)
            dx, dy = _denominator_coeffs(z_x, z_y)
            K = len(s.columns)
            g = _gamma_powers(gamma, k0, K)
            k0 += K
            gcs, A, B = _sample_coeffs(s, g)
            self.pre.append((z_x, z_y, dx, dy, list(s.columns), gcs, A, B))

    def at_many(self, positions, values: np.ndarray) -> np.ndarray:
        """values: (G, Q) opened values in the group's column order.
        Returns (Q, 4) uint64."""
        pos = np.asarray(positions, np.int64)
        x_p, y_p = self.xs[pos], self.ys[pos]
        total = np.zeros((len(pos), 4), np.uint64)
        for z_x, z_y, dx, dy, cols, gcs, A, B in self.pre:
            V = np_qm31_sub(np_qm31_mul(dy[None, :], np_qm31_sub(
                np_qm31(x_p), z_x)), np_qm31_mul(dx[None, :], np_qm31_sub(
                    np_qm31(y_p), z_y)))
            f = values[np.asarray(cols, np.int64)]
            num = np.empty((len(pos), 4), np.uint64)
            for t in range(4):
                num[:, t] = ((gcs[:, t, None] * f) % np.uint64(P)) \
                    .sum(axis=0) % np.uint64(P)
            num = np_qm31_sub(num, np_qm31_add(
                np_m31_mul(A[None, :], y_p[:, None]), B[None, :]))
            total = np_qm31_add(total, np_qm31_mul(num, np_qm31_inv(V)))
        return total
