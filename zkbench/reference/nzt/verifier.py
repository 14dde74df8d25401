"""The STARK verifier: the transcript replayed, the preprocessed
commitment recomputed, the OODS composition identity, the Merkle
openings, the DEEP quotients at the queried points, FRI and the
proof of work.

A proof is read by its attributes alone (``log_sizes``, ``roots``,
``claimed_sums``, ``sampled``, ``fri_proof``, ``pow_nonce``,
``openings``).  The preprocessed commitment is recomputed with plain
PyTorch operations on ``device``, every other check is host numpy.
"""

from __future__ import annotations

import hashlib
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from .air.component import (component_info, run_constraints,
                             PointEvalContext, preprocessed_is_first)
from .air.lookups import draw_relations
from .ops import fri, merkle, quotients
from .ops.blake2s import hash_rows_plain
from .ops.cfft import evaluate_plain, extend_coeffs, interpolate_plain
from .ops.circle import (oods_point_from_felt, qm31_point_add,
                         m31_point_as_qm31, subgroup_gen, point_mul,
                         point_neg, dev_bit_reverse, dev_layout_to_natural)
from .ops.field import (np_qm31, np_qm31_add, np_qm31_mul, np_qm31_inv,
                        np_qm31_pow, np_qm31_sub)
from .prover.config import PcsConfig
from .utils.device import from_u32, to_u32

__all__ = ["verify", "commit_roots", "open_positions"]

ROLE_ORDER = ("pre", "main", "inter", "comp")
_QM31_BASIS = [np_qm31(*(np.uint64(1) if t == i else np.uint64(0)
                         for t in range(4))) for i in range(4)]


# (eval size, digest of a size group's columns) -> root
_ROOTS: dict = {}


def scope(_name):
    return nullcontext()


def commit_roots(columns, trace_logs, log_blowup: int, device) -> list:
    """[(eval size, (8,) uint32 root)], largest first, of natural-order
    uint32 columns: each size group's columns in their order,
    interpolated, evaluated on the 2^(n + log_blowup) domain in
    bit-reversed order, its rows hashed to leaves and climbed.  A group
    whose columns were committed before (the same bytes) takes the root
    found then."""
    groups = {}
    for col, n in zip(columns, trace_logs):
        groups.setdefault(n, []).append(np.asarray(col, np.uint32))
    roots = []
    for n, cols in groups.items():
        s = n + log_blowup
        host = np.stack(cols)
        key = (s, hashlib.blake2b(host.tobytes(), digest_size=16).digest())
        if key not in _ROOTS:
            mat = from_u32(host, device)
            coeffs = interpolate_plain(
                mat[:, dev_layout_to_natural(n, device)])
            ev = evaluate_plain(extend_coeffs(coeffs, s))[
                :, dev_bit_reverse(s, device)]
            layer = hash_rows_plain(ev.t())
            del mat, coeffs, ev
            while layer.shape[0] > 1:
                layer = hash_rows_plain(layer.reshape(-1, 16))
            _ROOTS[key] = to_u32(layer[0])
        roots.append((s, _ROOTS[key]))
    return sorted(roots, key=lambda r: r[0], reverse=True)


def open_positions(queries, s0: int, s: int):
    """Sorted opened positions {p, p^1}, p = q >> (s0 - s)."""
    out = set()
    for q in queries:
        p = int(q) >> (s0 - s)
        out.update((p, p ^ 1))
    return sorted(out)


@dataclass
class ColumnMeta:
    role: str
    comp: int          # component index; -1 for shared/composition columns
    key: tuple
    trace_log: int
    offsets: tuple     # sorted mask offsets
    ridx: int          # index within its role (commit order)


@dataclass
class Plan:
    metas: list
    pre_sizes: list            # distinct component sizes, descending
    by_role: dict              # role -> [plan indices]
    index: dict                # (role, comp, key) -> plan index
    groups: dict               # eval_log -> [plan indices] (plan order)
    n_comp_trace_log: int      # nmax + 2

    def role_size_cols(self, role, s):
        return [self.metas[i].ridx for i in self.groups[s]
                if self.metas[i].role == role]

    def comp_ridxs(self, role, c):
        return [self.metas[i].ridx for i in self.by_role[role]
                if self.metas[i].comp == c]

    def inter_ridxs(self, c, n_logup_cols):
        return [self.metas[self.index[("inter", c, (b, t))]].ridx
                for b in range(n_logup_cols) for t in range(4)]

    def is_first_index(self, n):
        return self.index[("pre", -1, ("is_first", self.pre_sizes.index(n)))]


def build_plan(log_sizes, infos, config: PcsConfig) -> Plan:
    nmax = max(log_sizes)
    pre_sizes = sorted(set(log_sizes), reverse=True)
    metas, by_role, index = [], {r: [] for r in ROLE_ORDER}, {}

    def add(role, comp, key, trace_log, offsets):
        m = ColumnMeta(role=role, comp=comp, key=key, trace_log=trace_log,
                       offsets=tuple(offsets), ridx=len(by_role[role]))
        index[(role, comp, key)] = len(metas)
        by_role[role].append(len(metas))
        metas.append(m)

    for si, n in enumerate(pre_sizes):
        add("pre", -1, ("is_first", si), n, (0,))
    for c, info in enumerate(infos):
        for j in range(info.n_pre):
            add("pre", c, (j,), log_sizes[c], info.masks_pre[j])
    for c, info in enumerate(infos):
        for i in range(info.n_main):
            add("main", c, (i,), log_sizes[c], info.masks_main[i])
    for c, info in enumerate(infos):
        for b in range(info.n_logup_cols):
            for t in range(4):
                add("inter", c, (b, t), log_sizes[c], info.masks_inter[b])
    for t in range(4):
        add("comp", -1, (t,), nmax + 2, (0,))
    groups = {}
    for i, m in enumerate(metas):
        groups.setdefault(m.trace_log + config.fri.log_blowup, []).append(i)
    return Plan(metas=metas, pre_sizes=pre_sizes, by_role=by_role,
                index=index, groups=groups, n_comp_trace_log=nmax + 2)


def _point_for(z, trace_log: int, off: int):
    if off == 0:
        return z
    step = point_mul(subgroup_gen(trace_log), abs(off))
    if off < 0:
        step = point_neg(step)
    return qm31_point_add(z, m31_point_as_qm31(step))


def _build_samples(plan: Plan, z, sampled):
    """{eval_log -> [PointSample]} in canonical order."""
    out = {}
    for s, idxs in plan.groups.items():
        offs = sorted({o for i in idxs for o in plan.metas[i].offsets})
        tlog = plan.metas[idxs[0]].trace_log
        batches = []
        for o in offs:
            cols, vals = [], []
            for gi, i in enumerate(idxs):
                m = plan.metas[i]
                if o in m.offsets:
                    cols.append(gi)
                    vals.append(np.asarray(sampled[i][m.offsets.index(o)],
                                           np.uint64))
            batches.append(quotients.PointSample(
                point=_point_for(z, tlog, o), columns=cols, values=vals))
        out[s] = batches
    return out


def vanish_at_qm31(n: int, z_x):
    """v_n at a QM31 x-coordinate (host)."""
    t = np.asarray(z_x, np.uint64)
    one = np_qm31(np.uint64(1))
    for _ in range(n - 1):
        sq = np_qm31_mul(t, t)
        t = np_qm31_sub(np_qm31_add(sq, sq), one)
    return t


def _qm31_reconstruct(vals):
    """QM31 value of a 4-base-column group from its coordinate samples."""
    acc = np.zeros(4, np.uint64)
    for t in range(4):
        acc = np_qm31_add(acc, np_qm31_mul(_QM31_BASIS[t],
                                           np.asarray(vals[t], np.uint64)))
    return acc


def _mask_values(plan: Plan, info, c: int, n: int, sampled) -> dict:
    """Component c's sampled mask values, as `PointEvalContext` reads
    them: {(role, index, offset) -> (4,)}, an interaction batch's QM31
    value made from its four coordinate columns."""
    vals = {}
    for role, count in (("pre", info.n_pre), ("main", info.n_main)):
        for j in range(count):
            i = plan.index[(role, c, (j,))]
            for oi, o in enumerate(plan.metas[i].offsets):
                vals[(role, j, o)] = sampled[i][oi]
    for b in range(info.n_logup_cols):
        idxs = [plan.index[("inter", c, (b, t))] for t in range(4)]
        for oi, o in enumerate(plan.metas[idxs[0]].offsets):
            vals[("inter", b, o)] = _qm31_reconstruct(
                [sampled[i][oi] for i in idxs])
    vals[("is_first", 0, 0)] = sampled[plan.is_first_index(n)][0]
    return vals


def _relation_widths(infos):
    widths = {}
    for info in infos:
        for name, w in info.relation_widths.items():
            widths[name] = max(widths.get(name, 0), w)
    return widths


def _alpha_shifts(infos):
    ks = [info.n_constraints for info in infos]
    return [sum(ks[c + 1:]) for c in range(len(ks))]


def _pre_columns(components, log_sizes, plan: Plan):
    cols, logs = [], []
    for n in plan.pre_sizes:
        cols.append(preprocessed_is_first(n))
        logs.append(n)
    for c, comp in enumerate(components):
        for _name, arr in comp.preprocessed(log_sizes[c]):
            cols.append(np.asarray(arr, np.uint32))
            logs.append(log_sizes[c])
    return cols, logs


def verify(components, proof, channel,
           config: PcsConfig, device="cpu") -> bool:
    """Check a proof.  ``device`` runs the recomputation of the
    preprocessed commitment (plain PyTorch); everything else is host
    numpy."""
    dev = torch.device(device)
    try:
        return _verify(components, proof, channel, config, dev)
    except (KeyError, IndexError, ValueError, AssertionError):
        return False


def _verify(components, proof, channel, config, dev):
    infos = [component_info(c) for c in components]
    log_sizes = list(proof.log_sizes)
    if len(log_sizes) != len(components):
        return False  # log_sizes length
    plan = build_plan(log_sizes, infos, config)
    blowup = config.fri.log_blowup
    s0 = plan.n_comp_trace_log + blowup
    channel.mix_u32s(np.asarray(log_sizes, np.uint32))

    with scope("v:pre-commit"):
        pre_cols, pre_logs = _pre_columns(components, log_sizes, plan)
        pre_roots = commit_roots(pre_cols, pre_logs, blowup, dev)
        if [(s, r.tolist()) for s, r in pre_roots] != \
                [(s, np.asarray(r).tolist()) for s, r in proof.roots["pre"]]:
            return False  # preprocessed root mismatch
        for _s, root in pre_roots:
            channel.mix_u32s(root)

    for _s, root in proof.roots["main"]:
        channel.mix_u32s(np.asarray(root, np.uint32))
    relations = draw_relations(channel, _relation_widths(infos))
    claimed_sums = [np.asarray(cs, np.uint64) for cs in proof.claimed_sums]
    if len(claimed_sums) != len(components):
        return False  # claimed_sums length
    total = np.zeros(4, np.uint64)
    for cs in claimed_sums:
        total = np_qm31_add(total, cs)
    if total.any():
        return False  # claimed sums do not cancel
    channel.mix_felts(np.stack(claimed_sums).astype(np.uint32))
    for _s, root in proof.roots["inter"]:
        channel.mix_u32s(np.asarray(root, np.uint32))
    alpha = np.asarray(channel.draw_felt(), np.uint64)
    for _s, root in proof.roots["comp"]:
        channel.mix_u32s(np.asarray(root, np.uint32))

    z = oods_point_from_felt(channel.draw_felt())
    sampled = [np.asarray(s, np.uint64) for s in proof.sampled]
    if len(sampled) != len(plan.metas):
        return False  # sampled length
    for i, m in enumerate(plan.metas):
        if sampled[i].shape != (len(m.offsets), 4):
            return False  # sampled shape
    channel.mix_felts(np.concatenate([s.reshape(-1, 4) for s in sampled])
                      .astype(np.uint32))

    # -- OODS composition identity -----------------------------------------
    shifts = _alpha_shifts(infos)
    total = np.zeros(4, np.uint64)
    for c, comp in enumerate(components):
        n = log_sizes[c]
        mask_vals = _mask_values(plan, infos[c], c, n, sampled)
        ctx = PointEvalContext(mask_vals, relations, claimed_sums[c], alpha,
                               params=comp.params())
        acc, k = run_constraints(comp, ctx)
        if k != infos[c].n_constraints:
            return False  # constraint count
        if acc is None:
            continue
        term = np_qm31_mul(acc.as_qm31().v,
                           np_qm31_inv(vanish_at_qm31(n, z[0])))
        total = np_qm31_add(total, np_qm31_mul(np_qm31_pow(alpha, shifts[c]),
                                               term))
    comp_at_z = _qm31_reconstruct(
        [sampled[plan.index[("comp", -1, (t,))]][0] for t in range(4)])
    if not np.array_equal(total, comp_at_z):
        return False  # OODS composition identity

    # -- quotient / FRI phase ------------------------------------------------
    gamma = np.asarray(channel.draw_felt(), np.uint64)
    alphas = fri.fri_replay(proof.fri_proof, channel, config.fri,
                            list(plan.groups))
    if not channel.mix_pow_nonce(config.pow_bits, proof.pow_nonce):
        return False  # proof of work
    queries = channel.draw_queries(config.fri.n_queries, s0)

    with scope("v:merkle"):
        roots = {role: dict((s, np.asarray(r)) for s, r in proof.roots[role])
                 for role in ROLE_ORDER}
        roots["pre"] = dict(pre_roots)
        opened = {}
        for role in ROLE_ORDER:
            decs = dict((s, d) for s, d in proof.openings[role])
            for s in sorted({plan.metas[i].trace_log + blowup
                             for i in plan.by_role[role]}, reverse=True):
                ncols = len(plan.role_size_cols(role, s))
                positions = open_positions(queries, s0, s)
                if not merkle.verify_decommitment(
                        roots[role][s], [1 << s] * ncols, positions,
                        decs[s]):
                    return False  # a Merkle opening does not verify
                opened[(role, s)] = decs[s]

    with scope("v:quotients"):
        samples_by_size = _build_samples(plan, z, sampled)
        inputs_at, off = {}, 0
        for s in sorted(plan.groups, reverse=True):
            positions = open_positions(queries, s0, s)
            counter, rows = {}, []
            for i in plan.groups[s]:
                role = plan.metas[i].role
                k = counter.get(role, 0)
                counter[role] = k + 1
                rows.append(np.asarray(opened[(role, s)].column_values[k],
                                       np.uint64))
            out = quotients.QuotientsAt(s, samples_by_size[s], gamma,
                                        off).at_many(positions,
                                                     np.stack(rows))
            off += quotients.n_terms(samples_by_size[s])
            inputs_at[s] = {p: out[pi] for pi, p in enumerate(positions)}

    with scope("v:fri"):
        return fri.fri_check_queries(proof.fri_proof, alphas, queries,
                                     inputs_at, list(plan.groups),
                                     config.fri)
