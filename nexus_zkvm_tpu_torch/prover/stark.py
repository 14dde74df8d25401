"""STARK prove and verify, resident on one device.

Transcript order (frozen; prover and verifier must match):
  mix log_sizes | mix pre roots | mix main roots | draw relations
  | mix claimed_sums | mix inter roots | draw composition alpha
  | mix comp root | draw OODS t | mix sampled values | draw gamma
  | FRI (mix inner roots / draw alphas / mix last layer)
  | PoW grind+mix | draw queries.

Composition: components in order, constraints within a component
Horner-accumulated with alpha; component c's block is scaled by
alpha^(sum of later components' constraint counts) and divided by its
own vanishing polynomial v_n = pi^(n-1)(x).  Every component takes one
route: LDE of its columns to the 4x domain, constraint evaluation,
÷ v_n, × alpha^shift, then per-size buckets interpolated and extended
into the composition basis.

The verifier is host numpy/hashlib apart from recomputing the
preprocessed commitment, which runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import cfft, fri, merkle, quotients
from ..ops.field import (
    m31_add, m31_sub, m31_mul, m31_inv, m31_fold_sum, qm31_mul,
    qm31_mul_m31, np_qm31, np_qm31_add, np_qm31_sub, np_qm31_mul,
    np_qm31_inv, np_qm31_pow,
)
from ..ops.circle import (
    domain, natural_to_layout, oods_point_from_felt, qm31_point_add,
    m31_point_as_qm31, subgroup_gen, point_mul, point_neg,
    dev_committed_points, dev_layout_to_natural,
)
from ..air.component import (
    component_info, generate_interaction, run_constraints,
    run_constraints_domain, PointEvalContext, preprocessed_is_first,
)
from ..air.lookups import draw_relations
from ..utils.device import resolve_device, dev_const, from_u32, to_u32
from ..utils.profile import scope
from .config import PcsConfig
from . import pcs

__all__ = ["prove", "verify", "Proof"]

ROLE_ORDER = ("pre", "main", "inter", "comp")
_QM31_BASIS = [np_qm31(*(np.uint64(1) if t == i else np.uint64(0)
                         for t in range(4))) for i in range(4)]


# ---------------------------------------------------------------------------
# Column plan — the canonical committed-column enumeration
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

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


def _oods_basis_factors(tlog: int, point) -> np.ndarray:
    """(tlog, 4) kron factors of the point basis, slowest first:
    reversed pi-iterates of x, then y."""
    x, y = (np.asarray(v, np.uint64) for v in point)
    two, one = np_qm31(np.uint64(2)), np_qm31(np.uint64(1))
    xs = [x]
    for _ in range(tlog - 2):
        xs.append(np_qm31_sub(np_qm31_mul(two, np_qm31_mul(xs[-1], xs[-1])),
                              one))
    return np.stack(list(reversed(xs)) + [y]).astype(np.uint32)


def _oods_dot(cols: torch.Tensor, factors: np.ndarray) -> torch.Tensor:
    """(C, N) bit-reversed coefficient rows at a QM31 point -> (C, 4):
    the kron basis is expanded on the device from its factors, then
    dotted with every row (exact int64 sums)."""
    f = torch.as_tensor(factors.astype(np.int64), device=cols.device)
    basis = torch.zeros((1, 4), dtype=torch.int64, device=cols.device)
    basis[0, 0] = 1
    for i in range(f.shape[0]):
        basis = torch.cat([basis, qm31_mul(f[i], basis)])
    return torch.stack([m31_fold_sum(m31_mul(cols, basis[None, :, t]), dim=1)
                        for t in range(4)], dim=-1)


def inv_vanishing_natural(n: int, eval_log: int, device) -> torch.Tensor:
    """1 / v_n on the 2^eval_log domain, natural order (cached)."""
    def build():
        x_layout, _ = domain(eval_log).points()
        t = torch.from_numpy(x_layout[natural_to_layout(eval_log)]
                             .astype(np.int64))
        for _ in range(n - 1):
            sq = m31_mul(t, t)
            t = m31_sub(m31_add(sq, sq), 1)
        return m31_inv(t).numpy().astype(np.uint32)
    return dev_const(f"stark.invv{n}", eval_log, device, build)


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


# ---------------------------------------------------------------------------
# Proof
# ---------------------------------------------------------------------------

@dataclass
class Proof:
    log_sizes: list
    roots: dict              # role -> [(eval_log, (8,) uint32)] desc
    claimed_sums: list       # per component, (4,) uint64
    sampled: list            # per plan column, (n_offsets, 4) uint64
    fri_proof: fri.FriProof
    pow_nonce: int
    openings: dict           # role -> [(eval_log, MerkleDecommitment)]

    def size_estimate(self) -> int:
        """Rough serialized size in bytes (values + hashes)."""
        decs = [d for v in self.openings.values() for _s, d in v]
        decs += self.fri_proof.inner_decommitments
        total = sum(sum(len(v) * 4 for v in d.column_values)
                    + len(d.sibling_hashes) * 32 for d in decs)
        total += len(self.fri_proof.inner_roots) * 32
        total += self.fri_proof.last_layer.size * 4
        total += sum(s.size * 4 for s in self.sampled)
        total += sum(len(r) * 32 for r in self.roots.values())
        return total + len(self.claimed_sums) * 16


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------

def _interactions(components, infos, plan, log_sizes, relations, rc_pre,
                  rc_main, device):
    """Per component: its natural-order rows -> LogUp columns."""
    outs, claimed = [], []
    for c, comp in enumerate(components):
        n = log_sizes[c]
        main = (rc_main.natural_rows(plan.comp_ridxs("main", c))[0]
                if infos[c].n_main else None)
        pre = (rc_pre.natural_rows(plan.comp_ridxs("pre", c))[0]
               if infos[c].n_pre else None)
        cols, cs = generate_interaction(comp, main, pre, relations, n, device)
        outs.append(cols)
        claimed.append(torch.zeros(4, dtype=torch.int32, device=device)
                       if cs is None else cs)
    return outs, to_u32(torch.stack(claimed)).astype(np.uint64)


def _composition(components, infos, plan, log_sizes, relations,
                 claimed_sums, alpha, rcs, device) -> torch.Tensor:
    """(4, 2^comp_log) int32 composition coefficients."""
    shifts = _alpha_shifts(infos)
    buckets = {}
    for c, comp in enumerate(components):
        n = log_sizes[c]
        ev = n + 2
        with scope("c:lde"):
            main_ev = rcs["main"].evals_natural_matrix(
                plan.comp_ridxs("main", c), ev)
            pre_ev = rcs["pre"].evals_natural_matrix(
                plan.comp_ridxs("pre", c), ev)
            isf_ev = rcs["pre"].evals_natural_matrix(
                [plan.metas[plan.is_first_index(n)].ridx], ev)[0]
            inter_ev = None
            if infos[c].n_logup_cols:
                B = infos[c].n_logup_cols
                inter_ev = rcs["inter"].evals_natural_matrix(
                    plan.inter_ridxs(c, B), ev).reshape(B, 4, -1) \
                    .permute(0, 2, 1)
        with scope("c:eval"):
            acc, k = run_constraints_domain(
                comp, main_ev, pre_ev, inter_ev, isf_ev, relations,
                claimed_sums[c], alpha, device)
            assert k == infos[c].n_constraints
            del main_ev, pre_ev, inter_ev
            if acc is None:
                continue
            contrib = qm31_mul_m31(acc, inv_vanishing_natural(n, ev, device))
            shift = torch.as_tensor(
                np_qm31_pow(alpha, shifts[c]).astype(np.int64), device=device)
            contrib = qm31_mul(shift, contrib)
            buckets[ev] = (contrib if ev not in buckets
                           else m31_add(buckets[ev], contrib))
    comp_log = plan.n_comp_trace_log
    out = torch.zeros((4, 1 << comp_log), dtype=torch.int32, device=device)
    with scope("c:combine"):
        for ev in sorted(buckets, reverse=True):
            layout = buckets[ev][dev_layout_to_natural(ev, device)]
            cf = cfft.interpolate(layout.t().contiguous().to(torch.int32))
            out = m31_add(out, cfft.extend_coeffs(cf, comp_log)) \
                .to(torch.int32)
    return out


def prove(components, log_sizes, main_traces, channel,
          config: PcsConfig = PcsConfig(), device="cuda") -> Proof:
    """components: list of Component; main_traces: per component a list
    of natural-order uint32 numpy columns of size 2^log_sizes[c].  The
    traces are read, never modified."""
    dev = resolve_device(device)
    infos = [component_info(c) for c in components]
    plan = build_plan(log_sizes, infos, config)
    blowup = config.fri.log_blowup
    s0 = plan.n_comp_trace_log + blowup
    channel.mix_u32s(np.asarray(log_sizes, np.uint32))

    with scope("commit:pre"):
        pre_cols, pre_logs = _pre_columns(components, log_sizes, plan)
        rc_pre = pcs.commit_columns("pre", pre_cols, pre_logs, blowup, dev)
        rc_pre.mix_roots(channel)

    with scope("commit:main"):
        blocks, block_logs = [], []
        for c in range(len(components)):
            tr = main_traces[c]
            assert len(tr) == infos[c].n_main
            for col in tr:
                assert col.shape == (1 << log_sizes[c],)
            if infos[c].n_main:
                blocks.append(np.stack([np.asarray(col, np.uint32)
                                        for col in tr]))
                block_logs.append(log_sizes[c])
        rc_main = pcs.commit_blocks("main", blocks, block_logs, blowup, dev)
        del blocks
        rc_main.mix_roots(channel)

    with scope("interaction"):
        relations = draw_relations(channel, _relation_widths(infos))
        inter_cols, claimed = _interactions(components, infos, plan,
                                            log_sizes, relations, rc_pre,
                                            rc_main, dev)
        claimed_sums = list(claimed)
        channel.mix_felts(claimed.astype(np.uint32))
        rc_main.natural = rc_pre.natural = None
    with scope("commit:inter"):
        blocks, block_logs = [], []
        for c, arr in enumerate(inter_cols):
            if arr is not None:
                blocks.append(arr.permute(0, 2, 1).reshape(-1, arr.shape[1]))
                block_logs.append(log_sizes[c])
        del inter_cols
        rc_inter = (pcs.commit_blocks("inter", blocks, block_logs, blowup,
                                      dev, keep_natural=False)
                    if blocks else None)
        del blocks
        if rc_inter is not None:
            rc_inter.mix_roots(channel)

    with scope("composition"):
        alpha = np.asarray(channel.draw_felt(), np.uint64)
        rcs = {"pre": rc_pre, "main": rc_main, "inter": rc_inter}
        comp_coeffs = _composition(components, infos, plan, log_sizes,
                                   relations, claimed_sums, alpha, rcs, dev)
        rcs["comp"] = pcs.commit_from_coeffs("comp", comp_coeffs,
                                             plan.n_comp_trace_log, blowup)
        del comp_coeffs
        rcs["comp"].mix_roots(channel)

    with scope("oods"):
        z = oods_point_from_felt(channel.draw_felt())
        groups = {}          # (role, tlog, off) -> [(plan idx, offset idx)]
        for i, m in enumerate(plan.metas):
            for oi, o in enumerate(m.offsets):
                groups.setdefault((m.role, m.trace_log, o), []).append((i, oi))
        sampled = [np.zeros((len(m.offsets), 4), np.uint64)
                   for m in plan.metas]
        dots = []
        for (role, tlog, off), members in groups.items():
            cols, _n = rcs[role].coeff_rows([plan.metas[i].ridx
                                             for i, _ in members])
            dots.append(_oods_dot(cols, _oods_basis_factors(
                tlog, _point_for(z, tlog, off))))
        fetched = to_u32(torch.cat(dots).to(torch.int32)).astype(np.uint64)
        k = 0
        for members in groups.values():
            for i, oi in members:
                sampled[i][oi] = fetched[k]
                k += 1
        channel.mix_felts(np.concatenate([s.reshape(-1, 4) for s in sampled])
                          .astype(np.uint32))
        # quotients, FRI and openings read committed evals and trees only
        for rc in rcs.values():
            if rc is not None:
                rc.coeff_batches = None

    with scope("quotients"):
        gamma = np.asarray(channel.draw_felt(), np.uint64)
        samples_by_size = _build_samples(plan, z, sampled)
        fri_inputs, offset = {}, 0
        for s in sorted(plan.groups, reverse=True):
            roles = []
            for i in plan.groups[s]:
                if plan.metas[i].role not in roles:
                    roles.append(plan.metas[i].role)
            # the group enumerates every column of each role at this size
            # in commit order, so role blocks are whole eval matrices
            for role in roles:
                assert plan.role_size_cols(role, s) == \
                    rcs[role].cols_by_size[s], (role, s)
            a = quotients.prep_args_full(samples_by_size[s], gamma, offset,
                                         len(plan.groups[s]))
            xs, ys = dev_committed_points(s, dev)
            fri_inputs[s] = quotients.accumulate_blocks(
                [rcs[role].evals[s] for role in roles], xs, ys,
                from_u32(a["consts"], dev), from_u32(a["gcs"], dev))
            offset += quotients.n_terms(samples_by_size[s])
    with scope("fri"):
        fri_state = fri.fri_commit(fri_inputs, channel, config.fri)
        del fri_inputs

    with scope("pow"):
        pow_nonce = channel.grind_pow(config.pow_bits)
    queries = channel.draw_queries(config.fri.n_queries, s0)
    with scope("openings"):
        roots, keys, items = {}, [], []
        for role in ROLE_ORDER:
            rc = rcs[role]
            roots[role] = [] if rc is None else rc.roots()
            for s in ([] if rc is None else rc.sizes_desc()):
                keys.append((role, s))
                items.append((rc.trees[s], pcs.open_positions(queries, s0,
                                                              s)))
        items += fri.fri_decommit_items(fri_state, queries)
        decs = merkle.finalize_decommitments(
            merkle.decommit_many_fused(items))
        openings = {role: [] for role in ROLE_ORDER}
        for (role, s), d in zip(keys, decs):
            openings[role].append((s, d))
        fri_proof = fri.fri_proof_from_decs(fri_state, decs[len(keys):])

    return Proof(log_sizes=list(log_sizes), roots=roots,
                 claimed_sums=claimed_sums, sampled=sampled,
                 fri_proof=fri_proof, pow_nonce=pow_nonce, openings=openings)


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------

def verify(components, proof: Proof, channel,
           config: PcsConfig = PcsConfig(), device="cuda") -> bool:
    """Check a proof.  ``device`` runs the recomputation of the
    preprocessed commitment; everything else is host numpy."""
    dev = resolve_device(device)
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
        pre_roots = pcs.commit_columns("pre", pre_cols, pre_logs, blowup,
                                       dev, keep_natural=False).roots()
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
        mask_vals = {}
        for role, count in (("pre", infos[c].n_pre),
                            ("main", infos[c].n_main)):
            for j in range(count):
                i = plan.index[(role, c, (j,))]
                for oi, o in enumerate(plan.metas[i].offsets):
                    mask_vals[(role, j, o)] = sampled[i][oi]
        for b in range(infos[c].n_logup_cols):
            idxs = [plan.index[("inter", c, (b, t))] for t in range(4)]
            for oi, o in enumerate(plan.metas[idxs[0]].offsets):
                mask_vals[("inter", b, o)] = _qm31_reconstruct(
                    [sampled[i][oi] for i in idxs])
        mask_vals[("is_first", 0, 0)] = sampled[plan.is_first_index(n)][0]
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
                positions = pcs.open_positions(queries, s0, s)
                if not merkle.verify_decommitment(
                        roots[role][s], [1 << s] * ncols, positions,
                        decs[s]):
                    return False  # a Merkle opening does not verify
                opened[(role, s)] = decs[s]

    with scope("v:quotients"):
        samples_by_size = _build_samples(plan, z, sampled)
        inputs_at, off = {}, 0
        for s in sorted(plan.groups, reverse=True):
            positions = pcs.open_positions(queries, s0, s)
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
