"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  On a machine
with the card and the CUDA toolkit (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is uint32 equality (exact).
"""

import numpy as np
import pytest
import torch

from nexus_zkvm_tpu_torch import kernels
from nexus_zkvm_tpu_torch.ops import blake2s, cfft, circle, fri, quotients
from nexus_zkvm_tpu_torch.utils.device import from_u32

P = (1 << 31) - 1
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def rand(dev, shape, hi=P, seed=0):
    rng = np.random.default_rng(seed)
    return from_u32(rng.integers(0, hi, shape, dtype=np.uint32), dev)


# K1's pass boundaries: one pass up to T, two up to 2T - LOG_W (the main
# path's 2^24), three past it
_T, _TWO = cfft.TILE_LOG, 2 * cfft.TILE_LOG - cfft.LOG_W


@pytest.mark.parametrize("rows", [3, 5])
@pytest.mark.parametrize("n", sorted({1, 2, 5, 11, _T, _T + 1, 22, _TWO,
                                      _TWO + 1}))
def test_cfft(dev, n, rows):
    x = rand(dev, (rows, 1 << n), seed=n + rows)
    assert torch.equal(cfft.interpolate(x), cfft.interpolate_plain(x))
    assert torch.equal(cfft.evaluate(x), cfft.evaluate_plain(x))


@pytest.mark.parametrize("n", [1, 5, _T + 1, 22])
def test_cfft_in_place(dev, n):
    x = rand(dev, (3, 1 << n), seed=n)
    want = cfft.interpolate_plain(x)
    assert cfft.interpolate(x, out=x).data_ptr() == x.data_ptr()
    assert torch.equal(x, want)


@pytest.mark.parametrize("b", [1, 2])
def test_cfft_extend(dev, b):
    """The LDE's zero-extension fused into the first forward pass."""
    x = rand(dev, (5, 1 << 20), seed=b)
    assert torch.equal(cfft.evaluate(x, 20 + b),
                       cfft.evaluate_plain(cfft.extend_coeffs(x, 20 + b)))


def test_cfft_lde_past_2_32_words(dev):
    """K1's 64-bit row offsets: an LDE of 260 rows from 2^22 to 2^24
    points (4.4e9 output words, as the composition's resident LDE at
    2^22 rows) equals, at its first and last rows, the plain version on
    that row alone."""
    x = torch.randint(0, P, (260, 1 << 22), dtype=torch.int32, device=dev)
    out = cfft.evaluate(x, 24)
    for r in (0, 259):
        want = cfft.evaluate_plain(cfft.extend_coeffs(x[r:r + 1], 24))
        assert torch.equal(out[r:r + 1], want)
    del out, x
    torch.cuda.empty_cache()


def test_blake2s_leaves_past_2_32_words(dev):
    """K2's 64-bit message offsets: the leaves of a (260, 2^24) column
    matrix (4.4e9 words, read leaf-wise at a 2^24-word stride) equal the
    plain version's at the first and last leaves."""
    cols = torch.randint(0, P, (260, 1 << 24), dtype=torch.int32,
                         device=dev)
    got = blake2s.hash_rows(cols.t())
    for sl in (slice(0, 4), slice((1 << 24) - 4, 1 << 24)):
        want = blake2s.hash_rows_plain(cols[:, sl].t().contiguous())
        assert torch.equal(got[sl], want)
    del got, cols
    torch.cuda.empty_cache()


def test_quotients_past_2_32_words_of_segments(dev):
    """K3 and K11 over a size group wider than 2^32 words, as several
    CPU components make one: a preprocessed column and 520 columns
    (more than two 2^22-row segments' interaction columns) at 2^23
    points, 4.4e9 words.  Only the last 8 columns are nonzero, so the
    kernels' sums, which read every word, equal the plain versions' over
    those columns alone, read past 2^32 words into the block."""
    M, S = 1 << 23, 2
    pre = rand(dev, (1, M), seed=1)
    big = torch.zeros((520, M), dtype=torch.int32, device=dev)
    big[512:] = rand(dev, (8, M), seed=2)
    gcs = rand(dev, (S, 521, 4), seed=3)
    consts = rand(dev, (S, 6, 4), seed=4)
    xs, ys = circle.dev_committed_points(23, dev)
    got = quotients.accumulate_blocks([pre, big], xs, ys, consts, gcs)
    tail = gcs[:, [0] + list(range(513, 521))].contiguous()
    assert torch.equal(got, quotients.accumulate_blocks_plain(
        [pre, big[512:]], xs, ys, consts, tail))
    acc = rand(dev, (S, M, 4), seed=5)
    want = acc.clone()
    quotients.colsum_fold(acc, big, gcs[:, 1:].contiguous(), False)
    quotients.colsum_fold_plain(want, big[512:], gcs[:, 513:].contiguous(),
                                False)
    assert torch.equal(acc, want)
    del big, acc, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("n,seg", [(838_900, 1), (3_355_438, 3)])
def test_cpu_fill_of_a_segment_past_2_22_steps(dev, n, seg):
    """K5 on a segment that starts past step 2^22 (clk0 = seg 2^22 + 1):
    the fib guest in 2^22-step segments, a short second segment and the
    last of four (its clk past 3 2^22); the fill equals the plain
    version."""
    from pathlib import Path
    from nexus_zkvm_tpu_torch.machine import fill_dev
    from nexus_zkvm_tpu_torch.machine.driver import build_components, _clog2
    from nexus_zkvm_tpu_torch.sdk import Guest, LocalProver, encode_u32s
    src = (Path(__file__).resolve().parents[1] / "examples" / "guests"
           / "fib.s").read_text()
    view, trace = LocalProver(Guest.from_asm(src), device="cpu").trace(
        public_input=encode_u32s(n))
    part = trace.split_by(1 << 22)[seg]
    assert int(part.steps["clk"][0]) == (seg << 22) + 1
    _c, _f, (lo, hi) = build_components(view, 1)
    rows, prm = fill_dev.step_rows(part, view, _clog2(part.n_steps, lo=4),
                                   lo, hi)
    rows = from_u32(rows, dev)
    got = fill_dev.cpu_fill(rows, prm)
    want = fill_dev.cpu_fill_plain(rows, prm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_memory_config_for_the_card(dev):
    """``MemoryConfig.for_device`` on the card: the card fractions of its
    total memory, over the mesh ranks on the card."""
    from nexus_zkvm_tpu_torch.parallel.mesh import Mesh
    from nexus_zkvm_tpu_torch.prover import MemoryConfig
    total = torch.cuda.get_device_properties(dev).total_memory
    assert MemoryConfig.for_device(dev) == MemoryConfig.for_bytes(total)
    mesh = Mesh(size=2, rank=0, device=dev, backend="gloo", per_card=2)
    assert MemoryConfig.for_device(dev, mesh) == \
        MemoryConfig.for_bytes(total // 2)
    assert MemoryConfig.for_device("cpu") == MemoryConfig()


@pytest.mark.parametrize("W", [1, 4, 16, 17, 192])
def test_blake2s(dev, W):
    m = rand(dev, (257, W), 1 << 32, seed=W)
    assert torch.equal(blake2s.hash_rows(m), blake2s.hash_rows_plain(m))
    cols = rand(dev, (W, 64), 1 << 32, seed=W + 1)
    assert torch.equal(blake2s.hash_rows(cols.t()),
                       blake2s.hash_rows_plain(cols.t()))
    layer = rand(dev, (128, 8), 1 << 32, seed=W + 2)
    assert torch.equal(blake2s.hash_parents(layer),
                       blake2s.hash_rows_plain(layer.reshape(-1, 16)))


# K3: (samples, role block rows, log M, word): every S; K = 1, 15, 17 and
# the fib 2^20 proof's 438 (roles of 1, 193 and 244 rows, so stages
# straddle role boundaries); M from 4 points (one short block) to 2^21;
# every word and coefficient p - 1; a sample whose V is 0 everywhere
_Q_CASES = {
    "S1_K1": (1, (1,), 2, None),
    "S2_K15": (2, (15,), 3, None),
    "S3_K17_roles": (3, (1, 7, 9), 9, None),
    "S4_stage_edge": (4, (16, 1), 8, None),
    "S5_K17": (5, (17,), 10, None),
    "S6_K438": (6, (1, 193, 244), 13, None),
    "S7_K31": (7, (14, 17), 16, None),
    "S8_K438_2^21": (8, (1, 193, 244), 21, None),
    "S3_K438_2^21": (3, (1, 193, 244), 21, None),
    "words_p-1": (3, (1, 193, 244), 11, P - 1),
    "zero_V": (4, (5, 12), 9, "zero_v"),
}


@pytest.mark.parametrize("case", list(_Q_CASES))
def test_quotients(dev, case):
    S, rows, s, words = _Q_CASES[case]
    rng = np.random.default_rng(len(case) * 100 + S)
    M, K = 1 << s, sum(rows)
    if words == P - 1:
        blocks = [from_u32(np.full((r, M), P - 1, np.uint32), dev)
                  for r in rows]
        gcs_np = np.full((S, K, 4), P - 1, np.uint32)
    else:
        blocks = [rand(dev, (r, M), seed=i + s) for i, r in enumerate(rows)]
        gcs_np = rng.integers(0, P, (S, K, 4), dtype=np.uint32)
        for i in range(1, S):               # columns absent from a sample
            gcs_np[i, rng.random(K) < 0.6] = 0
    consts_np = rng.integers(0, P, (S, 6, 4), dtype=np.uint32)
    if words == "zero_v":
        consts_np[1, 2:4] = 0               # dx = dy = 0: V = 0
    gcs, consts = from_u32(gcs_np, dev), from_u32(consts_np, dev)
    xs, ys = circle.dev_committed_points(s, dev)
    before = kernels.launch_counts()["deep_quotients"]
    got = quotients.accumulate_blocks(blocks, xs, ys, consts, gcs)
    assert kernels.launch_counts()["deep_quotients"] == before + 1
    assert torch.equal(
        got, quotients.accumulate_blocks_plain(blocks, xs, ys, consts, gcs))


def test_quotients_refuses_what_the_copies_cannot_take(dev):
    """K3's bulk copies move 16-byte units: M must be a multiple of 4
    and every block 16-byte aligned; the wrapper raises otherwise."""
    xs, ys = circle.dev_committed_points(3, dev)
    consts, gcs = rand(dev, (1, 6, 4), seed=1), rand(dev, (1, 2, 4), seed=2)
    with pytest.raises(ValueError, match="16-byte"):
        quotients.accumulate_blocks([rand(dev, (2, 2), seed=3)], xs[:2],
                                    ys[:2], consts, gcs)
    flat = rand(dev, (2 * 8 + 1,), seed=4)
    with pytest.raises(ValueError, match="16-byte"):
        quotients.accumulate_blocks([flat[1:].reshape(2, 8)], xs, ys, consts,
                                    gcs)


def test_fri_fold(dev):
    v, inj = rand(dev, (256, 4), seed=5), rand(dev, (256, 4), seed=6)
    alpha = np.array([1, 2, 3, 4], np.uint64)
    w2 = np.array([5, 6, 7, P - 1], np.uint64)
    tw = fri.dev_line_fold_twiddles(8, dev)
    ctw = fri.dev_circle_fold_twiddles(8, dev)
    assert torch.equal(fri.fold(v, alpha, tw), fri.fold_plain(v, alpha, tw))
    assert torch.equal(fri.fold(v, alpha, tw, inj, ctw, w2),
                       fri.fold_plain(v, alpha, tw, inj, ctw, w2))


# -- K5, K6 and the machine path ---------------------------------------------

def _mixed_step_rows():
    from chip_smoke import MIXED_SRC
    from nexus_zkvm_tpu_torch.machine.driver import build_components, _clog2
    from nexus_zkvm_tpu_torch.machine.fill_dev import step_rows
    from nexus_zkvm_tpu_torch.vm import asm, k_trace
    view, trace = k_trace(asm.assemble(MIXED_SRC))
    _c, _f, (lo, hi) = build_components(view, 1)
    return step_rows(trace, view, _clog2(len(trace.steps["clk"]), lo=4),
                     lo, hi)


def test_cpu_fill(dev):
    from nexus_zkvm_tpu_torch.machine.fill_dev import cpu_fill, cpu_fill_plain
    rows, params = _mixed_step_rows()
    rows = from_u32(rows, dev)
    mat, hist = cpu_fill(rows, params)
    want_mat, want_hist = cpu_fill_plain(rows, params)
    assert torch.equal(mat, want_mat)
    assert torch.equal(hist, want_hist)


@pytest.mark.parametrize("B,M", [(1, 256), (1, 1), (7, 1000), (61, 1 << 12),
                                 (61, 4097), (64, 777), (70, 300),
                                 (200, 257)])
def test_logup_columns(dev, B, M):
    """Every operand mode (M31/QM31, constant/column), a ragged last
    block and a block-sum scan over several blocks; B across K6's chunks
    of pairs (16) and past 64."""
    from nexus_zkvm_tpu_torch.air.component import (logup_columns,
                                                    logup_columns_plain)
    rng = np.random.default_rng(B)
    pieces, meta, off = [], [], 0
    for k in range(4):
        for b in range(B):
            mode = int(rng.integers(0, 4)) if k % 2 == 0 else \
                int(rng.integers(1, 4))
            n = (1, M, 4, 4 * M)[mode]
            pieces.append(rng.integers(1, P, n, dtype=np.uint32))
            meta.append((off, mode))
            off += n
    src = from_u32(np.concatenate(pieces), dev)
    meta = torch.tensor(meta, dtype=torch.int64).reshape(4, B, 2)
    assert torch.equal(logup_columns(src, meta, M),
                       logup_columns_plain(src, meta, M))
    # a mesh rank's carry: the last column's prefix sum starts from it
    carry = from_u32(rng.integers(0, P, 4, dtype=np.uint32), dev)
    assert torch.equal(logup_columns(src, meta, M, carry),
                       logup_columns_plain(src, meta, M, carry))


@pytest.mark.parametrize("mode", range(4))
def test_logup_columns_zero_denominators(dev, mode):
    """Denominators of one operand mode set to 0 at the first, middle
    and last pair of K6's chunks and across chunk boundaries (a
    column's at a few rows, a constant at every row): f = 0 there, as
    in the plain version, and the other pairs of each chunk unharmed."""
    from nexus_zkvm_tpu_torch.air.component import (LOGUP_CHUNK,
                                                    logup_columns,
                                                    logup_columns_plain)
    B, M, C = 2 * LOGUP_CHUNK + 5, 600, LOGUP_CHUNK
    zero = {0, C // 2, C - 1, C, 2 * C - 1, 2 * C, B - 1}
    rng = np.random.default_rng(mode)
    pieces, meta, off = [], [], 0
    for k in range(4):
        for b in range(B):
            m = mode if k == 1 else int(rng.integers(0, 4))
            n = (1, M, 4, 4 * M)[m]
            words = rng.integers(1, P, n, dtype=np.uint32)
            if k == 1 and b in zero:
                w = (1, 1, 4, 4)[m]
                rows = range(n // w) if m in (0, 2) else (0, 1, 255, 256,
                                                           M - 1)
                for r in rows:
                    words[w * r:w * r + w] = 0
            pieces.append(words)
            meta.append((off, m))
            off += n
    src = from_u32(np.concatenate(pieces), dev)
    meta = torch.tensor(meta, dtype=torch.int64).reshape(4, B, 2)
    assert torch.equal(logup_columns(src, meta, M),
                       logup_columns_plain(src, meta, M))


def test_machine_proof_cpu_equals_cuda(dev):
    """The fib guest at n = 10 through LocalProver: the CPU and CUDA
    proofs are byte-equal and the CUDA proof verifies."""
    from nexus_zkvm_tpu_torch.sdk import (LocalProver, encode_u32s,
                                          proof_to_bytes)
    from chip_smoke import fib_guest
    guest = fib_guest()
    got = {}
    for device in ("cpu", "cuda"):
        prover = LocalProver(guest, device=device)
        view, proof = prover.prove_with_input(public_input=encode_u32s(10))
        got[device] = proof_to_bytes(proof)
    assert got["cpu"] == got["cuda"]
    assert prover.verify(view, proof)


# -- K7, K8, K9 ----------------------------------------------------------------

def _tape_components():
    """chip_smoke's synthetic pair and the fib guest's machine
    components (the CPU component, keccak, the tables), with relations."""
    import nexus_zkvm_tpu_torch as T
    from chip_smoke import fib_guest, make_components
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.air.lookups import draw_relations
    from nexus_zkvm_tpu_torch.machine.driver import build_components
    from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
    from nexus_zkvm_tpu_torch.sdk import LocalProver, encode_u32s
    view, _t = LocalProver(fib_guest(), device="cpu").trace(
        public_input=encode_u32s(3))
    comps = make_components() + build_components(view, 1)[0]
    rel = draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))
    return comps, rel


def _random_mats(dev, comp, rel, N, seed, domain):
    from nexus_zkvm_tpu_torch.air.component import component_info
    from nexus_zkvm_tpu_torch.air.tape import MAIN, PRE, INTER, ISF
    info = component_info(comp)
    rng = np.random.default_rng(seed)

    def mat(rows):
        return (from_u32(rng.integers(0, P, (rows, N), dtype=np.uint32), dev)
                if rows else None)
    return {MAIN: mat(info.n_main), PRE: mat(info.n_pre),
            INTER: mat(4 * info.n_logup_cols) if domain else None,
            ISF: mat(1)}


@pytest.mark.parametrize("window", [(0, 1), (1, 4)], ids=["whole", "pass"])
@pytest.mark.parametrize("log_size", [3, 6])
def test_air_eval_composition(dev, log_size, window):
    """Every tape's generated kernel (keccak's in pieces) over the whole
    domain, and over its second quarter (a pass of the memory mode), from
    halo-extended blocks."""
    from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
    from nexus_zkvm_tpu_torch.air.tape import (
        air_eval_composition, air_eval_composition_plain, domain_tape)
    comps, rel = _tape_components()
    rng = np.random.default_rng(log_size)
    N = 1 << (log_size + 2)
    L = N // window[1]
    lo = window[0] * L
    for i, comp in enumerate(comps):
        tape = domain_tape(comp, log_size, rel)
        if tape is None:
            continue
        hneg, hpos = domain_halo(component_info(comp))
        mats = _random_mats(dev, comp, rel, L + hneg + hpos, i, True)
        claimed, alpha, shift = (rng.integers(0, P, 4).astype(np.uint64)
                                 for _ in range(3))
        uni = tape.uniforms(rel, claimed)
        invv = rand(dev, (N,), seed=i)
        start = rand(dev, (N, 4), seed=i + 1)
        got, want = start.clone(), start.clone()
        air_eval_composition(tape, mats, uni, lo, L, hneg, alpha, shift,
                             invv, got)
        air_eval_composition_plain(tape, mats, uni, lo, L, hneg, alpha,
                                   shift, invv, want)
        assert torch.equal(got, want), comp.name


@pytest.mark.parametrize("log_size", [3, 6])
def test_air_eval_operands(dev, log_size):
    """Every gen tape's generated kernel: one library serves both sizes
    (the store words are a * M + b, M an argument)."""
    from nexus_zkvm_tpu_torch.air.tape import (
        air_eval_operands, air_eval_operands_plain, gen_tape)
    comps, rel = _tape_components()
    N = 1 << log_size
    for i, comp in enumerate(comps):
        tape = gen_tape(comp, log_size, rel)
        if tape is None:
            continue
        mats = _random_mats(dev, comp, rel, N, i, False)
        uni = tape.uniforms(rel, None)
        assert torch.equal(air_eval_operands(tape, mats, uni, N),
                           air_eval_operands_plain(tape, mats, uni, N)), \
            comp.name
        # a mesh rank's window: rows [N/4, N/2) from the blocks' first
        # N/4 + halo columns, the buffer laid out for N/4 rows
        hneg, hpos = tape.halo()
        L = N // 4
        win = {r: None if m is None else m[:, :hneg + L + hpos].contiguous()
               for r, m in mats.items()}
        assert torch.equal(
            air_eval_operands(tape, win, uni, N, L, L, hneg),
            air_eval_operands_plain(tape, win, uni, N, L, L, hneg)), \
            comp.name


def test_generated_kernels_load_from_cache(dev, monkeypatch):
    """A tape's K7 pieces, once built, load from build/kernels/ without
    running nvcc when the process has not loaded them yet; a launch of
    several pieces counts one."""
    from nexus_zkvm_tpu_torch.air import tape_cuda
    from nexus_zkvm_tpu_torch.air.tape import domain_tape, gen_tape
    comps, rel = _tape_components()
    keccak = next(c for c in comps if c.name == "keccak")
    tapes = [domain_tape(keccak, 3, rel), gen_tape(keccak, 3, rel)]
    n = sum(len(tape_cuda.pieces(t)) for t in tapes)
    assert n > 2
    tape_cuda.build(tapes)
    monkeypatch.setattr(kernels, "_GEN_LIBS", {})

    def no_nvcc():
        raise AssertionError("nvcc ran for a piece built before")
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    rec = tape_cuda.build(tapes)
    assert rec["built"] == 0 and rec["loaded"] == n
    before = kernels.launch_counts()["air_eval_composition"]
    from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
    from nexus_zkvm_tpu_torch.air.tape import air_eval_composition
    hneg, hpos = domain_halo(component_info(keccak))
    N = 1 << 5
    mats = _random_mats(dev, keccak, rel, N + hneg + hpos, 0, True)
    felt = np.arange(4, dtype=np.uint64)
    air_eval_composition(tapes[0], mats, tapes[0].uniforms(rel, felt), 0, N,
                         hneg, felt, felt, rand(dev, (N,)),
                         rand(dev, (N, 4)))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["air_eval_composition"] == before + 1


def test_generated_build_failure_raises_with_the_log(dev):
    text = '#error "no such piece"\n'
    with pytest.raises(RuntimeError, match="no such piece"):
        kernels.build_generated([(
            "air_eval_operands",
            kernels.generated_path("air_broken_gen_0", text), text)])


@pytest.mark.parametrize("C,log_n", [(1, 4), (3, 11), (5, 13), (40, 16)])
def test_oods_dot(dev, C, log_n):
    from nexus_zkvm_tpu_torch.prover.stark import oods_dot, oods_dot_plain
    cols = rand(dev, (C, 1 << log_n), seed=C)
    factors = np.random.default_rng(log_n).integers(
        0, P, (log_n, 4), dtype=np.uint32)
    assert torch.equal(oods_dot(cols, factors), oods_dot_plain(cols, factors))


# (rows of the batch, log_n, rows sampled or None) a group; groups of one
# case with equal (rows, log_n) share one batch
_OODS_CASES = {
    "shared": [(6, 12, None), (6, 12, [5, 0, 3]), (6, 12, [2])],
    "small": [(40, 4, list(range(39, -1, -2))), (3, 7, None),
              (200, 5, None), (2, 10, [1, 1, 0])],
    "mixed": [(244, 16, None), (244, 16, [243, 7]), (9, 11, None),
              (3, 14, [2, 0]), (70, 8, None), (1, 6, None)],
    "large": [(3, 22, [2, 0]), (2, 20, None), (5, 21, [4])],
}


@pytest.mark.parametrize("words", ["random", "p"])
@pytest.mark.parametrize("case", list(_OODS_CASES))
def test_oods_dot_groups(dev, case, words):
    """Many groups in one K8 launch: groups that share a batch, row
    subsets out of order (and repeated), log_n 4..22 (k < 10 packed
    rows included); words of p, a non-canonical zero, at every place."""
    from nexus_zkvm_tpu_torch.prover.stark import (oods_dot_groups,
                                                   oods_dot_groups_plain)
    rng = np.random.default_rng(len(case))
    batches, groups = {}, []
    for R, n, rows in _OODS_CASES[case]:
        if (R, n) not in batches:
            batches[(R, n)] = (rand(dev, (R, 1 << n), seed=R + n)
                               if words == "random" else
                               torch.full((R, 1 << n), P, dtype=torch.int32,
                                          device=dev))
        groups.append((batches[(R, n)], rows,
                       rng.integers(0, P, (n, 4), dtype=np.uint32)))
    before = kernels.launch_counts()["oods_dot"]
    got = oods_dot_groups(groups)
    assert kernels.launch_counts()["oods_dot"] == before + 1
    assert torch.equal(got, oods_dot_groups_plain(groups))


def test_gather_openings(dev):
    """Uniform trees (one of them on a transposed view, as FRI commits
    its layers), a mixed-depth tree, many openings in one launch; then a
    wide piece at a small tree (many units), digest layers 16-byte
    aligned and not, at output offsets of 4 words and odd ones."""
    from nexus_zkvm_tpu_torch.ops import merkle
    from nexus_zkvm_tpu_torch.ops.merkle import GATHER_FIELDS, _Gather
    t1 = merkle.commit_matrix(rand(dev, (5, 256), seed=1))
    t2 = merkle.commit_matrix(rand(dev, (64, 4), seed=2).t())
    t3 = merkle.commit([rand(dev, (1 << d,), seed=d).reshape(-1)
                        for d in (8, 6, 8, 3)])
    rng = np.random.default_rng(9)
    items = [(t, sorted(rng.integers(0, 1 << t.max_depth, 7).tolist()))
             for t in (t1, t2, t3, t1)]
    pieces = []
    for t, q in items:
        vals, sibs = merkle._pieces(t, q)
        pieces += vals + sibs
    merkle.place(pieces)
    assert torch.equal(merkle.gather_openings(pieces),
                       merkle.gather_openings_plain(pieces))
    decs = merkle.finalize_decommitments(merkle.decommit_many_fused(items))
    for (t, q), d in zip(items, decs):
        lengths = ([t.matrix.shape[1]] * t.matrix.shape[0]
                   if t.matrix is not None
                   else [c.shape[0] for c in t.columns])
        assert merkle.verify_decommitment(t.root(), lengths, q, d)
    wide = rand(dev, (3781, 64), seed=3)
    words = rand(dev, (8 * 40 + 1,), 1 << 32, seed=4)
    aligned, odd = words[:320].view(40, 8), words[1:].view(40, 8)
    pieces = [_Gather(wide, np.sort(rng.choice(64, 50, replace=False)), 1),
              _Gather(aligned, np.array([0, 3, 39]), 8),
              _Gather(odd, np.array([1, 2, 38]), 8),
              _Gather(wide[:1], np.array([5]), 1),
              _Gather(aligned, np.arange(40), 8),
              _Gather(odd, np.arange(40), 8)]
    merkle.place(pieces)
    packed, G = merkle.gather_plan(pieces)[:2]
    table = packed[:G * len(GATHER_FIELDS)].reshape(G, -1)
    vec, out = (table[:, GATHER_FIELDS.index(k)] for k in ("vec", "out"))
    assert vec.tolist() == [0, 1, 0, 0, 1, 0]
    assert out[1] % 4 == 2 and out[4] % 4 == 3
    before = kernels.launch_counts()["gather_openings"]
    got = merkle.gather_openings(pieces)
    assert kernels.launch_counts()["gather_openings"] == before + 1
    assert torch.equal(got, merkle.gather_openings_plain(pieces))


@pytest.mark.parametrize("D", [2, 4])
def test_gather_openings_of_mesh_ranks(dev, D):
    """A mesh rank's part of the openings (`merkle._mesh_pieces`: a
    value piece a column at its run of positions, the below-top
    siblings of its window, rank 0 the top's and a whole tree's),
    gathered by K9 into a zeroed buffer at the pieces' offsets: the
    sum over the ranks equals the single process's gather."""
    from nexus_zkvm_tpu_torch.ops import merkle
    t1 = merkle.commit_matrix(rand(dev, (5, 1 << 10), seed=11))
    t2 = merkle.commit_matrix(rand(dev, (1 << 9, 4), seed=12).t())
    small = merkle.commit_matrix(rand(dev, (3, 16), seed=13))
    rng = np.random.default_rng(D)
    items = [(t, sorted(set(rng.integers(0, 1 << t.max_depth,
                                         20).tolist())))
             for t in (t1, small, t2)]
    whole = merkle.decommit_many_fused(items).buffer
    total = torch.zeros_like(whole, dtype=torch.int64)
    top = D.bit_length() - 1
    for r in range(D):
        base, mine = 0, []
        for t, q in items:
            if t is not small:
                w = (1 << t.max_depth) // D
                lo, hi = r * w, (r + 1) * w
                t = merkle.MerkleTree(
                    layers=[x if d <= top else x[lo >> (t.max_depth - d):
                                                hi >> (t.max_depth - d)]
                            for d, x in enumerate(t.layers)],
                    columns=[], matrix=t.matrix[:, lo:hi].contiguous(),
                    window=(lo, hi), top=top)
            _v, _s, got, n = merkle._mesh_pieces(t, q, r, base)
            mine += got
            base += n
        before = kernels.launch_counts()["gather_openings"]
        buf = merkle.gather_openings(mine, base)
        assert kernels.launch_counts()["gather_openings"] == before + 1
        assert torch.equal(buf, merkle.gather_openings_plain(mine, base))
        total += buf.to(torch.int64)
    assert torch.equal(total, whole.to(torch.int64))


@pytest.mark.parametrize("log_n", [4, 12, 23])
def test_gather_columns(dev, log_n):
    """A column chunk at the tree's positions through K9's single-piece
    entry (indices on the card, or a host list uploaded), equal to
    torch.index_select; a transposed view read in place."""
    from nexus_zkvm_tpu_torch.ops import merkle
    rng = np.random.default_rng(log_n)
    src = rand(dev, (16, 1 << log_n), seed=log_n)
    idx = np.sort(rng.integers(0, 1 << log_n, 120)).tolist()
    ix = torch.tensor(idx, dtype=torch.int64, device=dev)
    before = kernels.launch_counts()["gather_openings"]
    got = merkle.gather_columns(src, ix)
    assert kernels.launch_counts()["gather_openings"] == before + 1
    assert torch.equal(got, src.index_select(1, ix))
    assert torch.equal(merkle.gather_columns(src, idx), got)
    tsrc = rand(dev, (1 << log_n, 5), seed=log_n + 1).t()
    assert torch.equal(merkle.gather_columns(tsrc, ix),
                       tsrc.index_select(1, ix))


def test_gather_refuses_2_31_words(dev):
    from nexus_zkvm_tpu_torch.ops import merkle
    from nexus_zkvm_tpu_torch.ops.merkle import _Gather
    src = torch.zeros((1, 1 << 16), dtype=torch.int32, device=dev) \
        .expand(1 << 15, 1 << 16)
    ix = torch.arange(1 << 16, device=dev)
    before = kernels.launch_counts()["gather_openings"]
    with pytest.raises(ValueError, match="2\\^31"):
        merkle.gather_columns(src, ix)
    with pytest.raises(ValueError, match="2\\^31"):
        merkle.gather_openings([_Gather(src, np.arange(1 << 16), 1)])
    assert kernels.launch_counts()["gather_openings"] == before


# -- K10, K11 and K12 (the large-trace memory mode) ---------------------------

# the tile plan's boundaries (csrc/brev_tile.cuh): t shrinks below 2T
_BT = circle.TILE_LOG
_LOG_M = sorted({0, 1, 2 * _BT - 1, 2 * _BT, 2 * _BT + 1, 9, 12})
_WIDTHS = [1, 4, 16, 17, 64]


@pytest.mark.parametrize("width", _WIDTHS)
@pytest.mark.parametrize("log_m", _LOG_M)
def test_blake2s_leaves_stream(dev, log_m, width):
    """K10 launched with chunks of ``width`` columns: alone (first and
    last at once), after a 16-column chunk (last), and, for a multiple
    of 16, before one (neither), every state equal to the plain one."""
    splits = [[width], [16, width]] + ([[width, 16]] if width % 16 == 0
                                      else [])
    for split in splits:
        C = sum(split)
        mat = rand(dev, (C, 1 << log_m), seed=C + log_m)
        got = want = None
        done = 0
        for c in split:
            last = done + c == C
            want = blake2s.leaves_stream_plain(want, mat[done:done + c], done,
                                               C, last)
            got = blake2s.leaves_stream(got, mat[done:done + c], done, C,
                                        last)
            assert torch.equal(got, want), (split, done)
            done += c


@pytest.mark.parametrize("brev", [False, True])
@pytest.mark.parametrize("width", _WIDTHS)
@pytest.mark.parametrize("log_m", _LOG_M)
def test_quotient_colsums_and_finalize(dev, log_m, width, brev):
    """K11 on a ``width``-column block in committed or layout order, some
    coefficients zero, then K12 on the sums."""
    S = 3
    M = 1 << log_m
    acc0 = rand(dev, (S, M, 4), seed=11 + log_m)
    block = rand(dev, (width, M), seed=12 + width)
    gcs_np = np.random.default_rng(13).integers(0, P, (S, width, 4),
                                                dtype=np.uint32)
    gcs_np[1, ::3] = 0
    gcs = from_u32(gcs_np, dev)
    got, want = acc0.clone(), acc0.clone()
    quotients.colsum_fold(got, block, gcs, brev)
    quotients.colsum_fold_plain(want, block, gcs, brev)
    assert torch.equal(got, want)
    consts = rand(dev, (S, 6, 4), seed=14)
    xs, ys = rand(dev, (M,), seed=15), rand(dev, (M,), seed=16)
    assert torch.equal(quotients.colsum_finalize(got, xs, ys, consts),
                       quotients.colsum_finalize_plain(got, xs, ys, consts))
    consts[1, 2:4] = 0                      # a sample whose V is 0
    assert torch.equal(quotients.colsum_finalize(got, xs, ys, consts),
                       quotients.colsum_finalize_plain(got, xs, ys, consts))


@pytest.mark.parametrize("S", range(1, 9))
def test_quotient_finalize(dev, S):
    """K12 for every S, at M of one point, a ragged last block and 2^12,
    a zero V at the first and last sample."""
    for M in (1, 257, 1 << 12):
        acc = rand(dev, (S, M, 4), seed=20 + S)
        consts = rand(dev, (S, 6, 4), seed=21 + S)
        consts[0, 2:4] = 0
        consts[S - 1, 2:4] = 0
        xs, ys = rand(dev, (M,), seed=22), rand(dev, (M,), seed=23)
        assert torch.equal(quotients.colsum_finalize(acc, xs, ys, consts),
                           quotients.colsum_finalize_plain(acc, xs, ys,
                                                           consts)), M


def test_sharded_commit_on_the_card(dev):
    """A 2-rank sharded commit with its ranks on the card (gloo through
    the host on one card; NCCL with a card each where there are two):
    every rank's root equals the single-process pcs root, each rank ran
    K1 and K2 on the device it was given."""
    import torch_mesh as tm
    from nexus_zkvm_tpu_torch.prover import pcs
    nccl = torch.cuda.device_count() >= 2
    spec = (40, 12, 7)
    recs = tm.spawn(tm.mesh_commit_rank, 2, spec, 12, 1,
                    backend="nccl" if nccl else "gloo", device="cuda",
                    timeout=300)
    want = pcs.commit_blocks("t", [tm.mesh_columns(spec, dev)], [12],
                             1, dev).trees[13].root()
    for r, rec in enumerate(recs):
        assert np.array_equal(rec["root"], want), r
        assert rec["device"] == (f"cuda:{r}" if nccl else "cuda:0"), rec
        assert all(rec["launches"][k] for k in tm.K1K2), rec


def test_launch_on_the_tensors_device(dev):
    """Tensors on a second card while the first is current: the kernels
    launch on the second card's stream and equal their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: no second device to launch on")
    other = torch.device("cuda", 1)
    x = rand(other, (3, 1 << 11), seed=5)
    with torch.cuda.device(0):
        got = cfft.evaluate(cfft.interpolate(x))
        leaves = blake2s.hash_rows(got.t())
        parents = blake2s.hash_parents(leaves)
    assert got.device == other
    assert torch.equal(got, cfft.evaluate_plain(cfft.interpolate_plain(x)))
    assert torch.equal(leaves, blake2s.hash_rows_plain(got.t()))
    assert torch.equal(parents,
                       blake2s.hash_rows_plain(leaves.reshape(-1, 16)))
