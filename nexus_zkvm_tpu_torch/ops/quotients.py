"""DEEP quotient accumulation (kernel K3) and the verifier's recompute.

For a sample (f, z, v) the quotient is

    q(p) = (c·f(p) - a·y_p - b) / V_z(p),
    c = conj(y_z) - y_z,  a = conj(v) - v,  b = v·c - a·y_z,
    V_z(p) = dy·(x_p - x_z) - dx·(y_p - y_z),
    dx = x_z - conj(x_z), dy = y_z - conj(y_z),

and all quotients of one committed size are combined with powers of a
channel-drawn gamma.  The host precomputes per sample the line
constants and the gamma-weighted coefficients ``gcs`` (one per column,
zero where a column does not take part in the sample); the device then
does, per domain point p in committed order,

    sum over samples of (sum_k gcs[s, k]·col_k(p) - A_s·y_p - B_s) / V_s(p).

The size group's columns arrive as whole per-role matrices (pre, main,
inter, comp), so no (K, M) gather is ever built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .field import (
    P, m31_mul, m31_add, m31_fold_sum, qm31_add, qm31_sub, qm31_mul,
    qm31_mul_m31, qm31_inv, qm31_from_m31,
    np_qm31_add, np_qm31_sub, np_qm31_mul, np_qm31_inv, np_qm31_conj,
    np_qm31_pow, np_m31_mul, np_qm31,
)
from .circle import committed_points, dev_committed_points
from ..utils.device import from_u32

__all__ = ["PointSample", "n_terms", "prep_args_full", "accumulate_blocks",
           "accumulate_blocks_plain", "accumulate_quotients", "QuotientsAt",
           "MAX_SAMPLES", "MAX_ROLES"]

MAX_SAMPLES = 8     # samples (OODS points) per size group the kernel takes
MAX_ROLES = 4       # per-role column blocks (pre, main, inter, comp)


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


def prep_args_full(samples, gamma, gamma_offset: int, k_total: int) -> dict:
    """Host constants of one size group: ``consts`` (S, 6, 4) holds
    zx, zy, dx, dy, A, B per sample; ``gcs`` (S, k_total, 4) the gamma
    coefficient of every column (zero off the sample's columns)."""
    S = len(samples)
    consts = np.zeros((S, 6, 4), np.uint32)
    gcs = np.zeros((S, k_total, 4), np.uint32)
    k0 = gamma_offset
    for si, s in enumerate(samples):
        z_x, z_y = s.point
        dx, dy = _denominator_coeffs(z_x, z_y)
        K = len(s.columns)
        g = _gamma_powers(gamma, k0, K)
        k0 += K
        gc, A, B = _sample_coeffs(s, g)
        consts[si] = np.stack([np.asarray(z_x, np.uint64),
                               np.asarray(z_y, np.uint64), dx, dy, A, B])
        if K:
            gcs[si, np.asarray(s.columns, np.int64)] = gc
    return {"consts": consts, "gcs": gcs}


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def accumulate_blocks_plain(blocks, x_p, y_p, consts, gcs) -> torch.Tensor:
    """blocks: per-role (C_r, M) int32 matrices (committed order), x_p,
    y_p: (M,) points, consts (S, 6, 4), gcs (S, K, 4) int32 tensors."""
    c64 = consts.to(torch.int64)
    total = None
    for s in range(consts.shape[0]):
        zx, zy, dx, dy, A, B = (c64[s, i] for i in range(6))
        V = qm31_sub(qm31_mul(dy, qm31_sub(qm31_from_m31(x_p), zx)),
                     qm31_mul(dx, qm31_sub(qm31_from_m31(y_p), zy)))
        coords = []
        for t in range(4):
            acc, off = None, 0
            for blk in blocks:
                g = gcs[s, off:off + blk.shape[0], t, None]
                part = m31_fold_sum(m31_mul(blk, g), dim=0)
                acc = part if acc is None else m31_add(acc, part)
                off += blk.shape[0]
            coords.append(acc)
        num = qm31_sub(qm31_sub(torch.stack(coords, dim=-1),
                                qm31_mul_m31(A, y_p)), B)
        contrib = qm31_mul(num, qm31_inv(V))
        total = contrib if total is None else qm31_add(total, contrib)
    return total.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel K3 and the public entry points
# ---------------------------------------------------------------------------

def accumulate_blocks(blocks, x_p, y_p, consts, gcs) -> torch.Tensor:
    """Combined quotients of one size group: (M, 4) int32, committed
    order.  Same arguments as :func:`accumulate_blocks_plain`."""
    if x_p.is_cuda:
        S, K = int(gcs.shape[0]), int(gcs.shape[1])
        M = int(x_p.shape[0])
        if not 1 <= S <= MAX_SAMPLES or not 1 <= len(blocks) <= MAX_ROLES:
            raise ValueError(f"kernel takes 1..{MAX_SAMPLES} samples and "
                             f"1..{MAX_ROLES} blocks, got {S}, {len(blocks)}")
        for name, t in [("x_p", x_p), ("y_p", y_p), ("consts", consts),
                        ("gcs", gcs)] + [(f"block{i}", b)
                                         for i, b in enumerate(blocks)]:
            kernels.check_cuda_tensor(t, name)
        if sum(int(b.shape[0]) for b in blocks) != K or any(
                b.shape[1] != M for b in blocks) or tuple(consts.shape) != (
                S, 6, 4):
            raise ValueError("block rows, gcs and consts shapes disagree")
        out = torch.empty((M, 4), dtype=torch.int32, device=x_p.device)
        ptrs = [b.data_ptr() for b in blocks] + [0] * (MAX_ROLES - len(blocks))
        rows = [int(b.shape[0]) for b in blocks] + [0] * (MAX_ROLES
                                                          - len(blocks))
        kernels.launch("deep_quotients", *ptrs, *rows, x_p.data_ptr(),
                       y_p.data_ptr(), consts.data_ptr(), gcs.data_ptr(),
                       S, K, M, out.data_ptr())
        return out
    if x_p.device.type == "cpu":
        return accumulate_blocks_plain(blocks, x_p, y_p, consts, gcs)
    raise ValueError(f"unsupported device {x_p.device}")


def accumulate_quotients(log_size: int, columns: torch.Tensor, samples,
                         gamma, gamma_offset: int = 0) -> torch.Tensor:
    """Combined quotients of a (K, 2^log_size) committed-order column
    matrix; the k-th (sample, column) term gets gamma^(gamma_offset + k)."""
    dev = columns.device
    a = prep_args_full(samples, gamma, gamma_offset, int(columns.shape[0]))
    xs, ys = dev_committed_points(log_size, dev)
    return accumulate_blocks([columns], xs, ys, from_u32(a["consts"], dev),
                             from_u32(a["gcs"], dev))


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
