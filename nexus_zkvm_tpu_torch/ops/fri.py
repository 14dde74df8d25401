"""FRI over circle/line domains in committed order (kernel K4 for the folds).

Same protocol as the JAX package:

* inputs: per circle log size s the combined quotients Q_s, (2^s, 4)
  QM31 in committed order; no committed first layer.
* fold: out[i] = (a + b) + alpha·(a - b)·t[i], (a, b) = (in[2i],
  in[2i+1]), t the inverse y (circle fold) or x (line fold) twiddles.
* blocks of up to 2^log_arity folds per committed layer, fold i of a
  block using alpha^(2^i); a smaller input joins on the landing fold of
  its block as w^2·cur + circle_fold(Q_s, w).
* the last layer is sent as 2^log_last_layer line coefficients.

Each fold is one launch of ``csrc/fri.cu`` (the landing fold also folds
the injected input); each committed layer is a Merkle tree over its
(2^m, 4) rows (kernel K2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .field import (
    P, np_m31_mul, np_qm31_add, np_qm31_sub, np_qm31_mul,
    qm31_add, qm31_sub, qm31_mul, qm31_mul_m31,
)
from .circle import domain, bit_reverse_indices
from . import merkle
from ..utils.device import dev_const, to_u32

__all__ = ["FriConfig", "FriProof", "fri_commit", "fri_decommit_items",
           "fri_proof_from_decs", "fri_replay", "fri_check_queries",
           "fold_schedule", "FoldBlock", "fold", "fold_plain"]


@dataclass(frozen=True)
class FriConfig:
    log_blowup: int = 1
    log_last_layer: int = 2
    n_queries: int = 54
    log_arity: int = 3

    @property
    def last_line_log(self) -> int:
        return self.log_blowup + self.log_last_layer


@dataclass(frozen=True)
class FoldBlock:
    m: int           # committed line-layer log size
    k: int           # pair folds after this commit
    inj: int | None  # input circle size joining at the landing fold


def fold_schedule(input_sizes, config: FriConfig):
    """Block boundaries at every smaller input's folded size and at
    every log_arity-th fold, whichever comes first."""
    sizes = sorted(set(int(s) for s in input_sizes), reverse=True)
    ll = config.last_line_log
    blocks = []
    m = sizes[0] - 1
    while m > ll:
        k = min(config.log_arity, m - ll)
        for s in sizes[1:]:
            if m > s - 1 >= m - k:
                k = m - s + 1
        inj = m - k + 1
        blocks.append(FoldBlock(m=m, k=k,
                                inj=inj if inj in sizes[1:] else None))
        m -= k
    return blocks


@lru_cache(maxsize=None)
def circle_fold_twiddles(log_size: int) -> np.ndarray:
    """inv(y) twiddles of the circle -> line fold, committed order."""
    return domain(log_size).inv_y_twiddles[bit_reverse_indices(log_size - 1)]


@lru_cache(maxsize=None)
def line_fold_twiddles(log_line_size: int) -> np.ndarray:
    """inv(x) twiddles folding a line layer 2^m -> 2^(m-1)."""
    t = domain(log_line_size + 1).inv_x_twiddle_stages[0]
    return t[bit_reverse_indices(log_line_size - 1)]


@lru_cache(maxsize=None)
def line_point_x(log_line_size: int) -> np.ndarray:
    return domain(log_line_size + 1).half_x[bit_reverse_indices(log_line_size)]


def line_interpolate(values_committed: np.ndarray) -> np.ndarray:
    """QM31 values on the 2^m line domain (committed order) -> natural
    order coefficients of b_j(x) = prod_k pi^k(x)^(j_k).  Host numpy."""
    v = np.asarray(values_committed, np.uint64)
    m = int(v.shape[0]).bit_length() - 1
    assert v.shape == (1 << m, 4)
    if m == 0:
        return v.copy()
    d = domain(m + 1)
    v = v[bit_reverse_indices(m)]
    shape = v.shape
    for j in range(1, m + 1):
        half = 1 << (m - j)
        s = v.reshape(1 << (j - 1), 2, half, 4)
        a, b = s[:, 0], s[:, 1]
        t = d.inv_x_twiddle_stages[j - 1][:half, None]
        v = np.stack([np_qm31_add(a, b), np_m31_mul(np_qm31_sub(a, b), t)],
                     axis=1).reshape(shape)
    v = np_m31_mul(v, np.uint64(pow(1 << m, P - 2, P)))
    return v[bit_reverse_indices(m)]


def line_eval_at(coeffs: np.ndarray, x: int) -> np.ndarray:
    c = np.asarray(coeffs, np.uint64)
    acc = np.zeros(4, np.uint64)
    for j in range(c.shape[0]):
        bj, xx, jj = np.uint64(1), np.uint64(x), j
        while jj:
            if jj & 1:
                bj = np_m31_mul(bj, xx)
            xx = (2 * np_m31_mul(xx, xx) + np.uint64(P - 1)) % np.uint64(P)
            jj >>= 1
        acc = np_qm31_add(acc, np_m31_mul(c[j], bj))
    return acc


# ---------------------------------------------------------------------------
# Folds: plain PyTorch version and CUDA kernel K4
# ---------------------------------------------------------------------------

def _fold_pairs(v, alpha, tw):
    v = v.to(torch.int64).reshape(-1, 2, 4)
    a, b = v[:, 0], v[:, 1]
    return qm31_add(qm31_add(a, b),
                    qm31_mul(alpha, qm31_mul_m31(qm31_sub(a, b), tw)))


def fold_plain(v, alpha, tw, inj=None, inj_tw=None, w2=None):
    """(2L, 4) -> (L, 4); with ``inj``: w2·fold(v) + fold(inj, alpha)."""
    alpha = torch.as_tensor(np.asarray(alpha, np.int64), device=v.device)
    out = _fold_pairs(v, alpha, tw)
    if inj is not None:
        w2 = torch.as_tensor(np.asarray(w2, np.int64), device=v.device)
        out = qm31_add(qm31_mul(w2, out), _fold_pairs(inj, alpha, inj_tw))
    return out.to(torch.int32)


def fold(v, alpha, tw, inj=None, inj_tw=None, w2=None) -> torch.Tensor:
    """One fold of a (2L, 4) QM31 layer with the QM31 ``alpha`` (host
    (4,) array) and (L,) inverse twiddles; on the landing fold of a
    block, ``inj`` (2L, 4) is folded with the same alpha and added to
    w2·fold(v)."""
    if v.is_cuda:
        L = v.shape[0] // 2
        kernels.check_cuda_tensor(v, "layer", ndim=2)
        kernels.check_cuda_tensor(tw, "twiddles", ndim=1)
        if v.shape != (2 * L, 4) or tw.shape[0] != L:
            raise ValueError("fold expects (2L, 4) values and L twiddles")
        a = [int(x) for x in np.asarray(alpha, np.uint64)]
        if inj is not None:
            kernels.check_cuda_tensor(inj, "injected layer", ndim=2)
            kernels.check_cuda_tensor(inj_tw, "injected twiddles", ndim=1)
            if inj.shape != v.shape or inj_tw.shape != tw.shape:
                raise ValueError("injected input must match the layer shape")
            ip, itp = inj.data_ptr(), inj_tw.data_ptr()
            w = [int(x) for x in np.asarray(w2, np.uint64)]
        else:
            ip, itp, w = 0, 0, [0, 0, 0, 0]
        out = torch.empty((L, 4), dtype=torch.int32, device=v.device)
        kernels.launch("fri_fold", v.data_ptr(), out.data_ptr(), L,
                       tw.data_ptr(), *a, ip, itp, *w)
        return out
    if v.device.type == "cpu":
        return fold_plain(v, alpha, tw, inj, inj_tw, w2)
    raise ValueError(f"unsupported device {v.device}")


def dev_circle_fold_twiddles(log_size: int, device):
    return dev_const("fri.ctw", log_size, device,
                     lambda: circle_fold_twiddles(log_size))


def dev_line_fold_twiddles(log_line_size: int, device):
    return dev_const("fri.ltw", log_line_size, device,
                     lambda: line_fold_twiddles(log_line_size))


def _alpha_powers(alpha, k: int) -> np.ndarray:
    """(k, 4): alpha^(2^i) for i < k."""
    out = np.empty((k, 4), np.uint64)
    a = np.asarray(alpha, np.uint64)
    for i in range(k):
        out[i] = a
        a = np_qm31_mul(a, a)
    return out


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

@dataclass
class FriProverState:
    config: FriConfig
    input_sizes: list
    schedule: list
    inner: list              # [(MerkleTree, root np, FoldBlock)]
    last_layer: np.ndarray


def fri_commit(inputs: dict, channel, config: FriConfig) -> FriProverState:
    """Commit phase.  inputs: {circle log size -> (2^s, 4) int32 tensor}."""
    sizes = sorted(inputs, reverse=True)
    s0 = sizes[0]
    dev = inputs[s0].device
    assert all(s - 1 > 0 for s in sizes)
    assert sizes[-1] - 1 >= config.last_line_log, \
        "input smaller than the FRI last layer"
    sched = fold_schedule(sizes, config)
    alpha = channel.draw_felt()
    cur = fold(inputs[s0], alpha, dev_circle_fold_twiddles(s0, dev))
    inner = []
    for blk in sched:
        tree = merkle.commit_matrix(cur.t())
        root = tree.root()
        channel.mix_u32s(root)
        pows = _alpha_powers(channel.draw_felt(), blk.k)
        for i in range(blk.k):
            tw = dev_line_fold_twiddles(blk.m - i, dev)
            if i == blk.k - 1 and blk.inj is not None:
                cur = fold(cur, pows[i], tw, inputs[blk.inj],
                           dev_circle_fold_twiddles(blk.inj, dev),
                           np_qm31_mul(pows[i], pows[i]))
            else:
                cur = fold(cur, pows[i], tw)
        inner.append((tree, root, blk))

    coeffs_full = line_interpolate(to_u32(cur))
    coeffs = coeffs_full[: 1 << config.log_last_layer]
    # NZT_FRI_UNSAFE_TRUNCATE=1 skips this degree check, so that tests
    # can play a malicious prover and check that the verifier rejects
    if not os.environ.get("NZT_FRI_UNSAFE_TRUNCATE"):
        assert not coeffs_full[1 << config.log_last_layer:].any(), \
            "FRI last layer exceeds its degree bound"
    coeffs = coeffs.astype(np.uint32)
    channel.mix_felts(coeffs)
    return FriProverState(config=config, input_sizes=sizes, schedule=sched,
                          inner=inner, last_layer=coeffs)


@dataclass
class FriProof:
    inner_roots: list
    inner_decommitments: list
    last_layer: np.ndarray


def _coset_positions(queries, shift: int, k: int):
    """The full 2^k-coset of p = q >> shift for every query."""
    M = 1 << k
    out = set()
    for q in queries:
        base = (int(q) >> shift) & ~(M - 1)
        out.update(range(base, base + M))
    return sorted(out)


def fri_decommit_items(state: FriProverState, queries):
    """(tree, positions) pairs of every committed layer's opening."""
    s0 = state.input_sizes[0]
    return [(tree, _coset_positions(queries, s0 - blk.m, blk.k))
            for tree, _root, blk in state.inner]


def fri_proof_from_decs(state: FriProverState, decs) -> FriProof:
    return FriProof(inner_roots=[r for _t, r, _b in state.inner],
                    inner_decommitments=list(decs),
                    last_layer=state.last_layer)


def fri_decommit(state: FriProverState, queries) -> FriProof:
    pend = [merkle.decommit_async(t, p)
            for t, p in fri_decommit_items(state, queries)]
    return fri_proof_from_decs(state, merkle.finalize_decommitments(pend))


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------

def fri_replay(proof: FriProof, channel, config: FriConfig,
               input_sizes) -> list:
    """Replay the commit-phase transcript; returns the alphas."""
    sched = fold_schedule(input_sizes, config)
    if len(proof.inner_roots) != len(sched) or \
            len(proof.inner_decommitments) != len(sched):
        raise ValueError("FRI proof has wrong number of inner layers")
    if proof.last_layer.shape != (1 << config.log_last_layer, 4):
        raise ValueError("FRI last layer has wrong shape")
    alphas = [channel.draw_felt()]
    for root in proof.inner_roots:
        channel.mix_u32s(root)
        alphas.append(channel.draw_felt())
    channel.mix_felts(np.asarray(proof.last_layer, np.uint32))
    return alphas


def _np_fold_pair(a, b, alpha, inv_t: int):
    f1 = np_m31_mul(np_qm31_sub(a, b), np.uint64(inv_t))
    return np_qm31_add(np_qm31_add(a, b), np_qm31_mul(alpha, f1))


def fri_check_queries(proof: FriProof, alphas, queries, inputs_at,
                      input_sizes, config: FriConfig) -> bool:
    """Fold consistency at every query.  inputs_at: {circle log size ->
    {position -> (4,) QM31}} recomputed by the caller from openings."""
    sizes = sorted(set(int(s) for s in input_sizes), reverse=True)
    s0 = sizes[0]
    sched = fold_schedule(sizes, config)
    if len(proof.inner_decommitments) != len(sched) or \
            len(proof.inner_roots) != len(sched):
        return False
    if np.asarray(proof.last_layer).shape != (1 << config.log_last_layer, 4):
        return False
    if config.last_line_log == 0:
        return False
    inner_vals = []
    for j, (dec, blk) in enumerate(zip(proof.inner_decommitments, sched)):
        pos = _coset_positions(queries, s0 - blk.m, blk.k)
        if not merkle.verify_decommitment(proof.inner_roots[j],
                                          [1 << blk.m] * 4, pos, dec):
            return False
        inner_vals.append({p: np.asarray([dec.column_values[c][i]
                                          for c in range(4)], np.uint64)
                           for i, p in enumerate(pos)})
    ctw = {s: circle_fold_twiddles(s) for s in sizes}
    last_coeffs = np.asarray(proof.last_layer, np.uint64)
    lx = line_point_x(config.last_line_log)
    for q in queries:
        q = int(q)
        try:
            v0 = np.asarray(inputs_at[s0][q & ~1], np.uint64)
            v1 = np.asarray(inputs_at[s0][q | 1], np.uint64)
        except KeyError:
            return False
        val = _np_fold_pair(v0, v1, np.asarray(alphas[0], np.uint64),
                            int(ctw[s0][q >> 1]))
        p = q >> 1
        for j, blk in enumerate(sched):
            M = 1 << blk.k
            base = p & ~(M - 1)
            try:
                work = [inner_vals[j][base + t] for t in range(M)]
            except KeyError:
                return False
            if not np.array_equal(work[p - base], val):
                return False
            w = np.asarray(alphas[j + 1], np.uint64)
            gbase = base
            for i in range(blk.k):
                ltw = line_fold_twiddles(blk.m - i)
                work = [_np_fold_pair(work[2 * r], work[2 * r + 1], w,
                                      int(ltw[(gbase >> 1) + r]))
                        for r in range(len(work) // 2)]
                gbase >>= 1
                if i < blk.k - 1:
                    w = np_qm31_mul(w, w)
            val = work[0]
            p = gbase
            if blk.inj is not None:
                try:
                    w0 = np.asarray(inputs_at[blk.inj][2 * p], np.uint64)
                    w1 = np.asarray(inputs_at[blk.inj][2 * p + 1], np.uint64)
                except KeyError:
                    return False
                inj = _np_fold_pair(w0, w1, w, int(ctw[blk.inj][p]))
                val = np_qm31_add(np_qm31_mul(np_qm31_mul(w, w), val), inj)
        if not np.array_equal(line_eval_at(last_coeffs, int(lx[p])), val):
            return False
    return True
