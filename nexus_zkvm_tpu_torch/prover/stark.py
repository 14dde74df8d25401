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
into the composition basis.  A component whose natural 4x-domain
columns exceed the memory budget runs that route in row passes.

The large-trace memory mode (``MemoryConfig``, chosen by size; see
``prover/pcs.py``): streamed trees keep their coefficients after OODS,
their quotients fold column chunks recomputed from them (K11, then
K12), and their openings recompute the opened values.  The proof is the
same under any ``MemoryConfig``.

Under a mesh of D ranks (``parallel.use_mesh``) nothing streams, and a
rank holds of every size group whose rows split the coefficients of its
share of the columns and the committed-order row window of the
evaluations (``prover/pcs.py``, ``parallel/commit.py``).  Each phase
runs on what the rank holds: the interaction on its natural-order row
window of each component whose rows split (the LogUp running sum
carried across ranks by one all_gather of the windows' totals, the
windows committed through step 0 of the windowed commit); OODS samples
the columns it owns, the
pieces joined by a disjoint sum; the composition runs K7 on the rank's
window of each 4x domain, over an LDE built a column chunk at a time
from coefficients broadcast by their owners, and the windows are
gathered before ``c:combine``; the quotients (K3) and the FRI folds (K4)
run on row windows, a layer gathered once it is too small to split; the
openings gather the positions the rank owns, joined by a disjoint sum.
Every rank holds the same transcript and proof, byte for byte a single
process's.

The verifier is host numpy/hashlib apart from recomputing the
preprocessed commitment, which runs on ``device``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops import cfft, fri, merkle, quotients
from ..ops.field import (
    P, m31_add, m31_mul, m31_fold_sum, qm31_mul, np_m31_inv,
    np_qm31, np_qm31_add, np_qm31_sub, np_qm31_mul,
    np_qm31_inv, np_qm31_pow,
)
from ..ops.circle import (
    oods_point_from_felt, qm31_point_add,
    m31_point_as_qm31, subgroup_gen, point_mul, point_neg,
    dev_committed_points, dev_layout_to_natural,
)
from ..air.component import (
    component_info, run_constraints, PointEvalContext,
    preprocessed_is_first, domain_halo, MAIN, PRE, INTER, ISF,
)
from ..air.tape import (gen_halo, generate_interaction, interaction_operands,
                        interaction_columns, accumulate_composition,
                        build_kernels)
from ..air.lookups import draw_relations
from ..parallel import commit as pcommit
from ..parallel.context import active_mesh
from ..utils.device import resolve_device, dev_const, from_u32, to_u32
from ..utils.profile import note, scope
from .config import MemoryConfig, PcsConfig
from . import pcs

__all__ = ["prove", "verify", "Proof", "oods_dot", "oods_dot_plain",
           "oods_dot_groups", "oods_dot_groups_plain", "oods_plan"]

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


def oods_dot_plain(cols: torch.Tensor, factors: np.ndarray) -> torch.Tensor:
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


# K8's work partition (`oods_plan`, mirrored by csrc/oods.cu): a block of
# 256 threads reads 2^OODS_LO_BITS words of a row a step (its lo words;
# the row's other index bits are hi; kLoBits in the kernel), a unit of
# work is OODS_CHUNK steps of one row, or as many short rows as fill one
# step
OODS_LO_BITS = 10
OODS_CHUNK = 256
# descriptor fields of a group, int64 each (the D_* of csrc/oods.cu)
OODS_FIELDS = ("base", "rows", "n_rows", "log_n", "k", "R", "H", "n_chunks",
               "unit0", "basis", "factors")


def oods_plan(shapes, chunk: int = OODS_CHUNK):
    """K8's work list for groups of ``shapes`` [(rows, log_n)] (output
    order): (order, table, E, U), ``order`` the launch order (the
    largest units first), ``table`` a (G, len(OODS_FIELDS)) int64
    descriptor a group in that order, with "base" and "factors" left 0
    for the wrapper, E the basis entries and U the units of all groups.
    A group's lo/hi split is k = min(log_n, OODS_LO_BITS); a unit is R =
    2^(OODS_LO_BITS - k) rows of H = min(2^(log_n - k), chunk) high
    indices; "rows" (the group's first row in the row lists and the
    output) and "basis" (2^k B_lo entries, then 2^(log_n - k) B_hi) are
    running offsets, "unit0" the group's first unit."""
    f = {name: i for i, name in enumerate(OODS_FIELDS)}
    rows_off = np.cumsum([0] + [r for r, _n in shapes])
    geo = []
    for r, n in shapes:
        k = min(n, OODS_LO_BITS)
        nhi = 1 << (n - k)
        R, H = 1 << (OODS_LO_BITS - k), min(nhi, chunk)
        geo.append((k, R, H, nhi // H))
    # words a unit, largest first (stable)
    order = sorted(range(len(shapes)),
                   key=lambda g: -(geo[g][1] * geo[g][2] << geo[g][0]))
    table = np.zeros((len(shapes), len(OODS_FIELDS)), np.int64)
    unit0 = basis = 0
    for i, g in enumerate(order):
        (r, n), (k, R, H, nch) = shapes[g], geo[g]
        row = table[i]
        row[[f["rows"], f["n_rows"], f["log_n"], f["k"], f["R"], f["H"],
             f["n_chunks"], f["unit0"], f["basis"]]] = \
            (rows_off[g], r, n, k, R, H, nch, unit0, basis)
        unit0 += -(-r // R) * nch
        basis += (1 << k) + (1 << (n - k))
    return order, table, basis, unit0


def oods_dot_groups_plain(groups) -> torch.Tensor:
    """(sum of rows, 4) int32: `oods_dot_plain` of each group (batch,
    rows, factors) in turn, its rows gathered (all of the batch for
    ``rows`` None)."""
    return torch.cat([oods_dot_plain(b if rows is None else b[list(rows)], f)
                      for b, rows, f in groups]).to(torch.int32)


def oods_dot_groups(groups) -> torch.Tensor:
    """The OODS samples of every group (batch, rows, factors): ``batch``
    a (R, 2^n) coefficient matrix, ``rows`` the indices of its rows to
    sample (None: all, in order), ``factors`` the (n, 4) factors of the
    group's point.  Returns (sum of rows, 4) int32, the groups' rows in
    turn.  On CUDA batches one launch of ``csrc/oods.cu`` (kernel K8)
    samples every group, each row read where it lies, after one
    host-to-device copy of the descriptors, row lists and factors; on
    CPU ones `oods_dot_groups_plain` runs."""
    if not groups:
        raise ValueError("no OODS groups")
    dev = groups[0][0].device
    shapes, rows_all, facts = [], [], []
    for batch, rows, factors in groups:
        n = len(factors)
        R = int(batch.shape[0]) if batch.dim() == 2 else -1
        rows = list(range(R)) if rows is None else [int(r) for r in rows]
        if batch.device != dev or batch.dim() != 2 or \
                batch.shape[1] != 1 << n or not rows or \
                min(rows) < 0 or max(rows) >= R:
            raise ValueError(f"OODS group of {len(rows)} rows of a batch "
                             f"{tuple(batch.shape)} on {batch.device} "
                             f"against {n} factors on {dev}")
        shapes.append((len(rows), n))
        rows_all.append(rows)
        facts.append(np.asarray(factors, np.uint32).reshape(n, 4))
    if not groups[0][0].is_cuda:
        if dev.type == "cpu":
            return oods_dot_groups_plain(groups)
        raise ValueError(f"unsupported device {dev}")
    order, table, E, U = oods_plan(shapes, OODS_CHUNK)
    f = {name: i for i, name in enumerate(OODS_FIELDS)}
    fact_off = np.cumsum([0] + [4 * s[1] for s in shapes])
    for i, g in enumerate(order):
        kernels.check_cuda_tensor(groups[g][0], "batch", ndim=2)
        table[i, f["base"]] = groups[g][0].data_ptr()
        table[i, f["factors"]] = fact_off[g]
    n_out = int(sum(s[0] for s in shapes))
    host = np.concatenate([table.reshape(-1), np.concatenate(rows_all),
                           np.concatenate([x.reshape(-1) for x in facts])
                           .astype(np.int64)])
    buf = torch.from_numpy(host).to(dev)
    basis = torch.empty((E, 4), dtype=torch.int32, device=dev)
    acc = torch.empty(1 + 4 * n_out, dtype=torch.int64, device=dev)
    out = torch.empty((n_out, 4), dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    kernels.launch("oods_dot", ptr, len(groups), ptr + 8 * table.size,
                   ptr + 8 * (table.size + n_out), E, U, OODS_LO_BITS,
                   basis.data_ptr(), acc.data_ptr(), n_out, out.data_ptr(),
                   device=dev)
    return out


def oods_dot(cols: torch.Tensor, factors: np.ndarray) -> torch.Tensor:
    """(C, 4) int64 samples of the coefficient rows at the point of
    ``factors``: one group of `oods_dot_groups` (kernel K8) on a CUDA
    ``cols``, `oods_dot_plain` on a CPU one."""
    if cols.is_cuda:
        return oods_dot_groups([(cols, None, factors)]).to(torch.int64)
    if cols.device.type == "cpu":
        return oods_dot_plain(cols, factors)
    raise ValueError(f"unsupported device {cols.device}")


def inv_vanishing_natural(n: int, eval_log: int, device) -> torch.Tensor:
    """1 / v_n on the 2^eval_log domain, natural order (cached).

    Natural row r is the point (2r + 1)·g, g of order 2^(eval_log + 1),
    and v_n = pi^(n-1)(x) is the x-coordinate of 2^(n-1) times it: the
    point (2r + 1)·q, q = 2^(n-1)·g of order 2^(eval_log - n + 2).  So
    v_n repeats with period 2^(eval_log - n + 1) in r (8 rows on the 4x
    domain): those values are inverted once and tiled."""
    def build():
        q = point_mul(subgroup_gen(eval_log + 1), 1 << (n - 1))
        period = 1 << min(eval_log, eval_log - n + 1)
        xs = np.asarray([point_mul(q, 2 * r + 1)[0] for r in range(period)],
                        np.uint64)
        return np.tile(np_m31_inv(xs), (1 << eval_log) // period) \
            .astype(np.uint32)
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

def _gen_halos(components, infos, log_sizes) -> dict:
    """n -> (hneg, hpos): the most rows around its own that a gen tape
    of a component of 2^n rows reads, over those components."""
    widths = _relation_widths(infos)
    out = {}
    for comp, n in zip(components, log_sizes):
        hneg, hpos = gen_halo(comp, n, widths)
        a, b = out.get(n, (0, 0))
        out[n] = (max(a, hneg), max(b, hpos))
    return out


def _interactions(components, infos, plan, log_sizes, relations, rc_pre,
                  rc_main, device, mesh=None):
    """Per component: its natural-order rows -> LogUp columns, and the
    claimed sums.  Where ``mesh`` splits a component's rows a rank
    generates only its natural window [lo, lo + L) (the operands, K7,
    from the window blocks the commitments kept; the columns, K6): the
    windows' totals (each last column's last row) of every such
    component go through one all_gather; rank r's columns are then made
    again from the same operands with the carry of the totals of the
    ranks before it, and a claimed sum is the sum of its D totals.  Each
    component's (row lo, row hi) is noted as ``interaction_windows``
    (components without lookups left out)."""
    outs, claimed, windows = [], [], []
    split = []                # (component, its operands on ranks r > 0)
    zero = torch.zeros(4, dtype=torch.int32, device=device)
    for c, comp in enumerate(components):
        n = log_sizes[c]
        main = (rc_main.natural_rows(plan.comp_ridxs("main", c))[0]
                if infos[c].n_main else None)
        pre = (rc_pre.natural_rows(plan.comp_ridxs("pre", c))[0]
               if infos[c].n_pre else None)
        span = rc_pre.natural_span(n)
        if span is None:
            cols, cs = generate_interaction(comp, main, pre, relations, n,
                                            device)
        else:
            with scope("i:eval"):
                got = interaction_operands(comp, main, pre, relations, n,
                                           device, span)
            cols = cs = None
            if got is not None:
                cols = interaction_columns(got)
                split.append((c, got if mesh.rank else None))
            del got
        del main, pre
        if cols is not None:
            lo, L = (0, 1 << n) if span is None else span[:2]
            windows.append((c, lo, lo + L))
        outs.append(cols)
        claimed.append(zero if cs is None else cs)
    if split:
        with scope("i:carry"):
            totals = to_u32(mesh.all_gather(torch.stack(
                [outs[c][-1, -1] for c, _got in split])[None]))
            sums = np.cumsum(totals.astype(np.int64), axis=0) % P
        for j, (c, got) in enumerate(split):
            claimed[c] = from_u32(sums[-1, j].astype(np.uint32), device)
            if mesh.rank:
                outs[c] = None
                outs[c] = interaction_columns(got, from_u32(
                    sums[mesh.rank - 1, j].astype(np.uint32), device))
            split[j] = got = None
    note("interaction_windows", windows)
    return outs, to_u32(torch.stack(claimed)).astype(np.uint64)


def _natural_rows(info) -> int:
    """Natural columns a component's composition reads: main,
    preprocessed, 4 per LogUp batch, is_first."""
    return info.n_main + info.n_pre + 4 * info.n_logup_cols + 1


def _composition_cols(c: int, n: int, info, plan: Plan) -> dict:
    """Load role -> (role, the columns of it) that component c's
    composition reads (None for a role it lacks)."""
    return {
        MAIN: ("main", plan.comp_ridxs("main", c)) if info.n_main else None,
        PRE: ("pre", plan.comp_ridxs("pre", c)) if info.n_pre else None,
        ISF: ("pre", [plan.metas[plan.is_first_index(n)].ridx]),
        INTER: (("inter", plan.inter_ridxs(c, info.n_logup_cols))
                if info.n_logup_cols else None)}


def _comp_passes(memory: MemoryConfig, info, n: int, mesh) -> int:
    """Row passes of component (info, 2^n rows)'s composition: its 4x
    domain, or this rank's window of it, by the memory budget."""
    w0, w1 = pcommit.window(mesh, 1 << (n + 2))
    return memory.comp_passes(_natural_rows(info), (w1 - w0).bit_length() - 1)


def _composition(components, infos, plan, log_sizes, relations,
                 claimed_sums, alpha, rcs, device,
                 memory: MemoryConfig, mesh=None) -> torch.Tensor:
    """(4, 2^comp_log) int32 composition coefficients.  Each component's
    columns are evaluated on its 4x domain in natural order, as blocks of
    rows [lo - hneg, hi + hpos) with the domain's wrap
    (`pcs.lde_window`), and its tape adds acc / v_n · alpha^shift over
    rows [lo, hi) into the bucket of that size (K7).  A component within
    the memory budget is one window [0, N), its LDE one batch; a larger
    one runs in row passes, its LDE in column chunks, so at most
    1/passes of its natural columns exist at once.  Under ``mesh`` a
    rank composes its window of each 4x domain that splits
    (``parallel.commit.window``), in passes by the window's bytes, its
    LDE in column chunks whose coefficients come from their owners
    (`RoleCommitment.coeff_source`); the buckets' windows are gathered
    before they are combined.  The pass counts are noted on the active
    profile as ``composition_passes``."""
    shifts = _alpha_shifts(infos)
    buckets, all_passes = {}, []
    for c, comp in enumerate(components):
        info, n = infos[c], log_sizes[c]
        ev = n + 2
        N = 1 << ev
        if ev not in buckets:
            buckets[ev] = torch.zeros((N, 4), dtype=torch.int32,
                                      device=device)
        w0, w1 = pcommit.window(mesh, N)
        passes = _comp_passes(memory, info, n, mesh)
        all_passes.append(passes)
        hneg, hpos = domain_halo(info)
        chunk = memory.chunk_cols(ev) if passes > 1 or mesh else None
        sources = {role: None if x is None else
                   (*rcs[x[0]].coeff_source(x[1], chunk or len(x[1])),
                    len(x[1]))
                   for role, x in _composition_cols(c, n, info, plan).items()}
        invv = inv_vanishing_natural(n, ev, device)
        L = (w1 - w0) // passes
        for lo in range(w0, w1, L):
            with scope("c:lde"):
                mats = {role: None if src is None else pcs.lde_window(
                            *src, ev, lo - hneg, L + hneg + hpos, device)
                        for role, src in sources.items()}
            with scope("c:eval"):
                k = accumulate_composition(
                    comp, n, mats, relations, claimed_sums[c], alpha,
                    np_qm31_pow(alpha, shifts[c]), invv, buckets[ev],
                    (lo, lo + L, hneg))
            del mats
        assert k == info.n_constraints
    note("composition_passes", all_passes)
    comp_log = plan.n_comp_trace_log
    out = torch.zeros((4, 1 << comp_log), dtype=torch.int32, device=device)
    with scope("c:combine"):
        for ev in sorted(buckets, reverse=True):
            w0, w1 = pcommit.window(mesh, 1 << ev)
            if w1 - w0 < 1 << ev:
                buckets[ev] = mesh.all_gather(buckets[ev][w0:w1])
            layout = buckets[ev][dev_layout_to_natural(ev, device)]
            cf = cfft.interpolate(layout.t().contiguous())
            out = m31_add(out, cfft.extend_coeffs(cf, comp_log)) \
                .to(torch.int32)
    return out


def _quotients_streamed(role_rcs, s: int, xs, ys, consts, gcs,
                        chunk_cols: int) -> torch.Tensor:
    """The combined quotients of a size group with a streamed tree: the
    per-sample column sums (S, 2^s, 4) are folded role by role (K11), a
    kept role from its committed evaluations, a streamed one chunk by
    chunk from its recomputed LDE (K1, layout order), then finalized
    (K12).  Equal to `quotients.accumulate_blocks` on the whole group."""
    S = int(gcs.shape[0])
    acc = torch.zeros((S, 1 << s, 4), dtype=torch.int32, device=xs.device)
    off = 0
    for rc in role_rcs:
        C = len(rc.cols_by_size[s])
        if not rc.streamed(s):
            quotients.colsum_fold(acc, rc.evals[s],
                                  gcs[:, off:off + C].contiguous(), False)
        else:
            batch = rc.coeff_batches[s - rc.log_blowup][1]
            for lo in range(0, C, chunk_cols):
                hi = min(C, lo + chunk_cols)
                ev = cfft.evaluate(batch[lo:hi], s)
                quotients.colsum_fold(
                    acc, ev, gcs[:, off + lo:off + hi].contiguous(), True)
                del ev
        off += C
    return quotients.colsum_finalize(acc, xs, ys, consts)


def prove(components, log_sizes, main_traces, channel,
          config: PcsConfig = PcsConfig(), device="cuda",
          memory: MemoryConfig | None = None,
          release_traces: bool = False) -> Proof:
    """components: list of Component; main_traces: per component either
    a list of natural-order uint32 numpy columns of size 2^log_sizes[c]
    or one (n_main, 2^log_sizes[c]) int32 tensor (committed as it is,
    without a host round trip when it already lies on ``device``).  The
    traces are read, never modified; with ``release_traces`` the list's
    entries are set to None once committed, so a device trace is freed
    after the interaction.  ``memory`` decides where the data is kept,
    never the proof (None: `MemoryConfig.for_device` of ``device`` and
    the active mesh); the thresholds and the route taken are noted on
    the active profile (``memory``: the MemoryConfig's fields;
    ``cache_released``: whether a composition in passes on a card had
    the caching allocator emptied at the start and before it;
    ``streamed``: the (role, eval size) trees committed column-streamed;
    ``composition_passes``: each component's row passes; ``sharded``:
    the (role, eval size) trees, and ("fri", size) layer trees, committed
    in row windows over the active mesh; ``mesh_windows``: what this rank
    holds of each (role, eval size) group, (role, s, (row lo, hi),
    (column lo, hi)); ``interaction_windows``: the natural rows
    (component, row lo, row hi) of each component's interaction this
    rank made; ``natural_windows``: the natural values it kept for them,
    (role, n, (row lo, rows, hneg), shape)).  Under an active mesh
    (``parallel.use_mesh``)
    every rank calls ``prove`` with the same arguments and gets the same
    proof."""
    dev = resolve_device(device)
    mesh = active_mesh()
    if mesh is not None and mesh.size == 1:
        mesh = None
    if memory is None:
        memory = MemoryConfig.for_device(dev, mesh)
    note("memory", dataclasses.asdict(memory))
    infos = [component_info(c) for c in components]
    plan = build_plan(log_sizes, infos, config)
    blowup = config.fri.log_blowup
    # a composition in row passes: the trace crowds the card, so the
    # caching allocator's free blocks (the last proof's, then those of
    # the phases before the composition) go back to the card, where
    # blocks of the next phase's sizes can be carved
    tight = dev.type == "cuda" and any(
        _comp_passes(memory, info, n, mesh) > 1
        for info, n in zip(infos, log_sizes))
    note("cache_released", tight)
    if tight:
        torch.cuda.empty_cache()
    s0 = plan.n_comp_trace_log + blowup
    channel.mix_u32s(np.asarray(log_sizes, np.uint32))

    # under a mesh the natural values are kept as row windows with the
    # halo the interaction's operands read
    halo = _gen_halos(components, infos, log_sizes) if mesh else None
    with scope("commit:pre"):
        pre_cols, pre_logs = _pre_columns(components, log_sizes, plan)
        rc_pre = pcs.commit_columns("pre", pre_cols, pre_logs, blowup, dev,
                                    memory=memory, mesh=mesh, halo=halo)
        rc_pre.mix_roots(channel)

    with scope("commit:main"):
        blocks, block_logs = [], []
        for c in range(len(components)):
            tr = main_traces[c]
            shape = (infos[c].n_main, 1 << log_sizes[c])
            if isinstance(tr, torch.Tensor):
                assert tuple(tr.shape) == shape and tr.dtype == torch.int32
            else:
                assert len(tr) == infos[c].n_main
                for col in tr:
                    assert col.shape == shape[1:]
            if infos[c].n_main:
                blocks.append(tr if isinstance(tr, torch.Tensor) else
                              np.stack([np.asarray(col, np.uint32)
                                        for col in tr]))
                block_logs.append(log_sizes[c])
            if release_traces:
                main_traces[c] = None
        tr = None
        rc_main = pcs.commit_blocks("main", blocks, block_logs, blowup, dev,
                                    memory=memory, mesh=mesh, halo=halo)
        rc_main.mix_roots(channel)

    relations = draw_relations(channel, _relation_widths(infos))
    if dev.type == "cuda":
        # every component's two tapes, and their K7 kernels built in one
        # batch (loaded already on a warm proof)
        with scope("k7:build"):
            build_kernels(components, log_sizes, relations)
    with scope("interaction"):
        inter_cols, claimed = _interactions(components, infos, plan,
                                            log_sizes, relations, rc_pre,
                                            rc_main, dev, mesh)
        claimed_sums = list(claimed)
        channel.mix_felts(claimed.astype(np.uint32))
        note("natural_windows", [
            (role, n, rc.natural_span(n) or (0, 1 << n, 0), tuple(t.shape))
            for role, rc in (("pre", rc_pre), ("main", rc_main))
            for n, (_idxs, t) in rc.natural.items()])
        rc_main.natural = rc_pre.natural = None
    with scope("commit:inter"):
        # each component's (B, L, 4) columns are freed as their (4B, L)
        # copy is made, and the commitment takes the copies over (a
        # rank's window where the mesh splits the rows: L = M/D)
        blocks, block_logs = [], []
        for c in range(len(inter_cols)):
            arr, inter_cols[c] = inter_cols[c], None
            if arr is not None:
                blocks.append(arr.permute(0, 2, 1).reshape(-1, arr.shape[1]))
                block_logs.append(log_sizes[c])
        arr = inter_cols = None
        rc_inter = (pcs.commit_blocks("inter", blocks, block_logs, blowup,
                                      dev, keep_natural=False, memory=memory,
                                      mesh=mesh, row_windows=True)
                    if blocks else None)
        if rc_inter is not None:
            rc_inter.mix_roots(channel)

    with scope("composition"):
        if tight:
            torch.cuda.empty_cache()
        alpha = np.asarray(channel.draw_felt(), np.uint64)
        rcs = {"pre": rc_pre, "main": rc_main, "inter": rc_inter}
        comp_coeffs = _composition(components, infos, plan, log_sizes,
                                   relations, claimed_sums, alpha, rcs, dev,
                                   memory, mesh)
        rcs["comp"] = pcs.commit_from_coeffs("comp", comp_coeffs,
                                             plan.n_comp_trace_log, blowup,
                                             memory, mesh)
        del comp_coeffs
        rcs["comp"].mix_roots(channel)
    note("streamed", [(role, s) for role, rc in rcs.items() if rc is not None
                      for s in rc.sizes_desc() if rc.streamed(s)])
    note("mesh_windows", [(role, *w) for role, rc in rcs.items()
                          if rc is not None for w in rc.windows()]
         if mesh else [])

    with scope("oods"):
        z = oods_point_from_felt(channel.draw_felt())
        groups = {}          # (role, tlog, off) -> [(plan idx, offset idx)]
        for i, m in enumerate(plan.metas):
            for oi, o in enumerate(m.offsets):
                groups.setdefault((m.role, m.trace_log, o), []).append((i, oi))
        sampled = [np.zeros((len(m.offsets), 4), np.uint64)
                   for m in plan.metas]
        # every group's rows sampled where they lie, in one K8 launch;
        # under a mesh each rank samples the columns it owns, and a
        # disjoint sum puts every row in its place on every rank
        todo, where, k = [], [], 0
        for (role, tlog, off), members in groups.items():
            mine = [j for j, (i, _oi) in enumerate(members)
                    if rcs[role].samples(plan.metas[i].ridx)]
            if mine:
                todo.append((*rcs[role].coeff_row_index(
                    [plan.metas[members[j][0]].ridx for j in mine]),
                    _oods_basis_factors(tlog, _point_for(z, tlog, off))))
                where += [k + j for j in mine]
            k += len(members)
        got = oods_dot_groups(todo) if todo else None
        if mesh is not None:
            buf = torch.zeros((k, 4), dtype=torch.int32, device=dev)
            if got is not None:
                buf[torch.as_tensor(where, device=dev)] = got
            got = mesh.all_reduce(buf)
        fetched = to_u32(got).astype(np.uint64)
        k = 0
        for members in groups.values():
            for i, oi in members:
                sampled[i][oi] = fetched[k]
                k += 1
        channel.mix_felts(np.concatenate([s.reshape(-1, 4) for s in sampled])
                          .astype(np.uint32))
        # quotients, FRI and openings read committed evals and trees;
        # a role with a streamed size recomputes its evals from its
        # coefficients, so it keeps them
        for rc in rcs.values():
            if rc is not None and not any(map(rc.streamed, rc.trees)):
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
            # this rank's row window of the group (all of it when the
            # rows do not split)
            lo, hi = pcommit.window(mesh, 1 << s)
            xs, ys = (t[lo:hi] for t in dev_committed_points(s, dev))
            consts, gcs = from_u32(a["consts"], dev), from_u32(a["gcs"], dev)
            if any(rcs[role].streamed(s) for role in roles):
                fri_inputs[s] = _quotients_streamed(
                    [rcs[role] for role in roles], s, xs, ys, consts, gcs,
                    memory.chunk_cols(s))
            else:
                fri_inputs[s] = quotients.accumulate_blocks(
                    [rcs[role].evals[s] for role in roles], xs, ys, consts,
                    gcs)
            offset += quotients.n_terms(samples_by_size[s])
    with scope("fri"):
        fri_state = fri.fri_commit(fri_inputs, channel, config.fri, mesh)
        del fri_inputs
    note("sharded", [(role, s) for role, rc in rcs.items() if rc is not None
                     for s in rc.sizes_desc() if rc.trees[s].sharded]
         + [("fri", tree.max_depth) for tree, _r, _b in fri_state.inner
            if tree.sharded])

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
                pos = pcs.open_positions(queries, s0, s)
                items.append((rc.trees[s], pos) if not rc.streamed(s) else
                             (rc.trees[s], pos, pcs.opened_values_streamed(
                                 rc, s, pos, memory.chunk_cols(s))))
        items += fri.fri_decommit_items(fri_state, queries)
        decs = merkle.finalize_decommitments(
            merkle.decommit_many_fused(items, mesh))
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
