"""Kernel K7's generated sources, compiled for the CPU.

``air/tape_cuda.py`` writes each constraint tape out as CUDA C++ on the
template ``csrc/air_eval_gen.cuh``.  Under ``-DNZT_HOST`` the template's
qualifiers and load macro reduce, through ``csrc/host_shim.h``, to plain
C++ with a loop over rows, so the same emitted text compiles with ``g++``
into a shared library that ctypes calls.  On seeded numpy rows, uint32
equality with the plain interpreter (`air_eval_plain`, which
tests/test_torch_tape.py holds to the JAX package's evaluation bodies):

* both tapes of every fib10 machine component and of the synthetic
  cases: the composition over a whole domain and over a window with its
  halo, the LogUp operands over the whole trace and over a window;
* keccak's composition tape, cut into pieces: every piece run by a numpy
  reading of its text, their bucket additions summed against the
  one-piece plain result, and one piece compiled;
* the CPU component's generated composition against the JAX package's
  `DomainEvalContext` body directly;
* the text and its library digest are the same for one tape and differ
  between two; an operand tape's text does not depend on the log size.

    python -m pytest -q tests/test_torch_tape_cuda.py

(about 20 s of one process, most of it g++.)
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

import chip_smoke
from test_torch_machine import FIB10_SRC
from test_torch_tape import LOG, MACHINE, Traps
import jax.numpy as jnp
from nexus_zkvm_tpu.air import component as RC
from nexus_zkvm_tpu.air.lookups import draw_relations as rdraw
from nexus_zkvm_tpu.channel import Blake2sChannel as RChannel
from nexus_zkvm_tpu.machine import driver as rdriver
from nexus_zkvm_tpu.vm import asm as rasm, k_trace as rk_trace
import nexus_zkvm_tpu_torch as T
from nexus_zkvm_tpu_torch import kernels
from nexus_zkvm_tpu_torch.air import tape_cuda
from nexus_zkvm_tpu_torch.air.component import component_info, domain_halo
from nexus_zkvm_tpu_torch.air.lookups import draw_relations
from nexus_zkvm_tpu_torch.air.tape import (
    MAIN, PRE, INTER, ISF, air_eval_composition_plain, air_eval_operands_plain,
    air_eval_plain, composition_uniforms, domain_tape, gen_tape)
from nexus_zkvm_tpu_torch.machine import driver as tdriver
from nexus_zkvm_tpu_torch.ops.field import np_qm31_add, np_qm31_mul
from nexus_zkvm_tpu_torch.prover.stark import _relation_widths
from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
from nexus_zkvm_tpu_torch.vm import asm as tasm, k_trace as tk_trace

P = (1 << 31) - 1
SYNTHETIC = ("wide_squares", "vals_table", "traps")
CASES = ([("fib10", n) for n in MACHINE]
         + [("synthetic", n) for n in SYNTHETIC])
# keccak's composition is several pieces: test_keccak_pieces_sum_to_plain
COMPOSE_CASES = [c for c in CASES if c != ("fib10", "keccak")]


def _u32(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint32)


@pytest.fixture(scope="module")
def programs():
    """name -> (port components, relations)."""
    tv, _tt = tk_trace(tasm.assemble(FIB10_SRC), backend="python")
    out = {"fib10": tdriver.build_components(tv, 1)[0],
           "synthetic": chip_smoke.make_components() + [Traps()]}
    return {k: (comps, draw_relations(T.Blake2sChannel(), _relation_widths(
        [component_info(c) for c in comps]))) for k, comps in out.items()}


def _pick(programs, prog, name):
    comps, rel = programs[prog]
    return comps[[c.name for c in comps].index(name)], rel


def _host_build(pieces_by_key, tmp) -> dict:
    """Compile every piece's text with g++ under the host shim, all at
    once; returns {key: [ctypes entry of each piece]}."""
    gxx = shutil.which("g++")
    assert gxx, "the CPU tests of the generated K7 compile with g++"
    procs = []
    for key, (name, pieces) in pieces_by_key.items():
        for i, p in enumerate(pieces):
            src = tmp / f"{p.stem}.cu"
            src.write_text(p.text)
            lib = tmp / f"lib{p.stem}.so"
            procs.append((key, name, lib, subprocess.Popen(
                [gxx, "-x", "c++", "-std=c++17", "-O0", "-DNZT_HOST",
                 "-I", str(kernels.CSRC), "-shared", "-fPIC", "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = {}
    for key, name, lib, proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        fn = ctypes.CDLL(str(lib)).nzt_tape_entry
        fn.argtypes = kernels.GENERATED[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out.setdefault(key, []).append(fn)
    return out


@pytest.fixture(scope="module")
def host_libs(programs, tmp_path_factory):
    """(prog, name, kind) -> the compiled pieces of that tape, for every
    case but keccak's composition (tested by its piece split below)."""
    todo = {}
    for prog, name in CASES:
        comp, rel = _pick(programs, prog, name)
        for kind, fn in (("domain", domain_tape), ("gen", gen_tape)):
            tape = fn(comp, LOG, rel)
            if tape is None or (name, kind) == ("keccak", "domain"):
                continue
            todo[(prog, name, kind)] = (tape_cuda._name(tape),
                                        tape_cuda.pieces(tape))
    return _host_build(todo, tmp_path_factory.mktemp("k7"))


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _host_composition(fns, tape, mats, uni, alpha, lo, L, hneg, shift, invv,
                      bucket) -> None:
    """Run a composition's pieces in turn over rows [lo, lo + L), adding
    into ``bucket`` (numpy uint32, in place)."""
    table = composition_uniforms(tape, uni, alpha)
    first = next(m for m in mats.values() if m is not None)
    W = first.shape[1]
    bases = [_ptr(first if mats.get(r) is None else mats[r])
             for r in range(4)]
    for fn, piece in zip(fns, tape_cuda.pieces(tape)):
        words = np.ascontiguousarray(table[piece.table].astype(np.uint32))
        assert fn(*bases, W, lo, L, hneg, *(int(s) for s in shift),
                  _ptr(invv), _ptr(bucket), _ptr(words), None) == 0


def _composition_inputs(comp, N, W, rng):
    info = component_info(comp)
    mats = {MAIN: _u32(rng, (info.n_main, W)),
            PRE: _u32(rng, (info.n_pre, W)) if info.n_pre else None,
            INTER: (_u32(rng, (4 * info.n_logup_cols, W))
                    if info.n_logup_cols else None),
            ISF: _u32(rng, (1, W))}
    claimed, alpha, shift = (_u32(rng, 4).astype(np.uint64) for _ in "cas")
    return mats, claimed, alpha, shift, _u32(rng, N), _u32(rng, (N, 4))


def _plain_composition(tape, mats, uni, lo, L, hneg, alpha, shift, invv,
                       start) -> np.ndarray:
    tmats = {r: None if m is None else from_u32(m, "cpu")
             for r, m in mats.items()}
    got = from_u32(start, "cpu")
    air_eval_composition_plain(tape, tmats, uni, lo, L, hneg, alpha, shift,
                               from_u32(invv, "cpu"), got)
    return to_u32(got)


@pytest.mark.parametrize("window", ["whole", "pass"])
@pytest.mark.parametrize("prog,name", COMPOSE_CASES)
def test_generated_composition_equals_plain(programs, host_libs, prog, name,
                                            window):
    """The composition's generated text over the whole 4x domain (the
    window [0, N)) and over its second quarter (a pass of the memory
    mode), from halo-extended blocks of random rows."""
    comp, rel = _pick(programs, prog, name)
    tape = domain_tape(comp, LOG, rel)
    rng = np.random.default_rng(CASES.index((prog, name)) * 2
                                + (window == "pass"))
    N = 1 << (LOG + 2)
    lo, L = (0, N) if window == "whole" else (N // 4, N // 4)
    hneg, hpos = domain_halo(component_info(comp))
    mats, claimed, alpha, shift, invv, start = _composition_inputs(
        comp, N, L + hneg + hpos, rng)
    uni = tape.uniforms(rel, claimed)
    got = start.copy()
    _host_composition(host_libs[(prog, name, "domain")], tape, mats, uni,
                      alpha, lo, L, hneg, shift, invv, got)
    want = _plain_composition(tape, mats, uni, lo, L, hneg, alpha, shift,
                              invv, start)
    assert np.array_equal(got, want)
    if window == "pass":
        assert np.array_equal(got[:lo], start[:lo])
        assert np.array_equal(got[lo + L:], start[lo + L:])


@pytest.mark.parametrize("window", ["whole", "window"])
@pytest.mark.parametrize("prog,name", CASES)
def test_generated_operands_equal_plain(programs, host_libs, prog, name,
                                        window):
    """The LogUp operands' generated text: every word of K6's packed
    buffer, the per-row stores and the row-0 ones, over the whole trace
    (its own columns, a load wrapping) and over its second quarter as a
    mesh rank's window (halo-extended blocks of random rows, the buffer
    laid out for the window's rows).  A component without lookups has
    no gen tape."""
    comp, rel = _pick(programs, prog, name)
    tape = gen_tape(comp, LOG, rel)
    info = component_info(comp)
    if tape is None:
        assert info.n_logup_cols == 0
        return
    rng = np.random.default_rng(100 + CASES.index((prog, name))
                                + 50 * (window == "window"))
    M = 1 << LOG
    lo, L, (hneg, hpos) = ((0, M, (0, 0)) if window == "whole" else
                           (M // 4, M // 4, tape.halo()))
    W = hneg + L + hpos
    mats = {MAIN: _u32(rng, (info.n_main, W)),
            PRE: _u32(rng, (info.n_pre, W)) if info.n_pre else None,
            ISF: _u32(rng, (1, W))}
    uni = tape.uniforms(rel, None)
    first = mats[MAIN]
    bases = [_ptr(first if mats.get(r) is None else mats[r])
             for r in range(4)]
    out = np.full(tape.layout(L)[2], 0xDEADBEEF, np.uint32)
    for fn, piece in zip(host_libs[(prog, name, "gen")],
                         tape_cuda.pieces(tape)):
        words = np.ascontiguousarray(
            np.asarray(uni, np.int64)[piece.table].astype(np.uint32))
        assert fn(*bases, W, L, hneg, M - 1 if L == M else -1, _ptr(out),
                  _ptr(words), None) == 0
    want = to_u32(air_eval_operands_plain(
        tape, {r: None if m is None else from_u32(m, "cpu")
               for r, m in mats.items()}, uni, M,
        *(() if L == M else (lo, L, hneg))))
    assert np.array_equal(out, want)


# ---------------------------------------------------------------------------
# keccak's composition in pieces
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\s*(?:const uint32_t (\w+) = )?(\w+)\((.*)\);$")
_NP = {"nzt_add": lambda a, b: (a + b) % P,
       "nzt_sub": lambda a, b: (a + P - b) % P,
       "nzt_mul": lambda a, b: (a * b) % P}


def _read_piece(text, mats, table, stride, N) -> np.ndarray:
    """A numpy reading of one generated composition piece over rows [0,
    N) of halo-free blocks (hneg 0, every load at its row + off * stride
    mod N): its (N, 4) accumulator sum_j w_j c_j."""
    rows = np.arange(N)
    env = {}
    acc = np.zeros((N, 4), np.uint64)

    def val(tok):
        tok = tok.strip()
        if tok.endswith("u"):
            return np.uint64(int(tok[:-1]))
        m = re.fullmatch(r"U\((\d+)\)", tok)
        return np.uint64(table[int(m[1])]) if m else env[tok]

    def weight(k):
        return table[k:k + 4].astype(np.uint64)
    body = text[text.index("NztAcc& acc) {"):].splitlines()[1:]
    for line in body:
        m = _LINE.match(line)
        if not m:
            continue
        dst, fn, args = m.groups()
        args = [a for a in args.split(",")]
        if fn == "LD":
            role, col, off = (int(a) for a in args)
            env[dst] = mats[role][col, (rows + off * stride) % N] \
                .astype(np.uint64)
        elif fn == "nzt_neg":
            env[dst] = (P - val(args[0])) % P
        elif fn in _NP:
            env[dst] = _NP[fn](val(args[0]), val(args[1]))
        elif fn == "EMIT1":
            x = np.broadcast_to(val(args[1]), (N,))
            acc = (acc + weight(int(args[0]))[None] * x[:, None]) % P
        elif fn == "FOLD":
            continue
        elif fn == "EMITQ":
            e = np.stack([np.broadcast_to(val(a), (N,)) for a in args[1:]],
                         axis=1)
            acc = np_qm31_add(acc, np_qm31_mul(
                np.broadcast_to(weight(int(args[0])), (N, 4)), e))
        else:
            raise AssertionError(line)
    return acc


def test_keccak_pieces_sum_to_plain(programs, tmp_path):
    """Keccak's composition tape exceeds a piece: its pieces cover the
    outputs in order, each within the caps; read in numpy, their
    accumulators sum to the plain interpreter's; compiled, one piece
    adds what its reading says into the bucket."""
    comp, rel = _pick(programs, "fib10", "keccak")
    tape = domain_tape(comp, LOG, rel)
    ps = tape_cuda.pieces(tape)
    assert len(ps) > 1
    assert ps[0].outputs[0] == 0 and ps[-1].outputs[1] == len(tape.emits)
    assert all(a.outputs[1] == b.outputs[0] for a, b in zip(ps, ps[1:]))
    assert all(p.n_ops <= tape_cuda.PIECE_OPS
               and len(p.table) <= tape_cuda.PIECE_TABLE_WORDS for p in ps)
    rng = np.random.default_rng(7)
    N = 1 << (LOG + 2)
    info = component_info(comp)
    mats = {MAIN: _u32(rng, (info.n_main, N)),
            PRE: _u32(rng, (info.n_pre, N)),
            INTER: _u32(rng, (4 * info.n_logup_cols, N)),
            ISF: _u32(rng, (1, N))}
    claimed, alpha = (_u32(rng, 4).astype(np.uint64) for _ in "ca")
    uni = tape.uniforms(rel, claimed)
    table = composition_uniforms(tape, uni, alpha)
    parts = [_read_piece(p.text, mats, table[p.table], tape.stride, N)
             for p in ps]
    total = np.zeros((N, 4), np.uint64)
    for part in parts:
        total = np_qm31_add(total, part)
    want = air_eval_plain(tape, {r: from_u32(m, "cpu")
                                 for r, m in mats.items()}, uni, N,
                          alpha=alpha).numpy()
    assert np.array_equal(total, want.astype(np.uint64))
    # piece 0 compiled, over the one window [0, N) of halo-extended
    # blocks: bucket + part * invv * shift
    (fn,) = _host_build({0: ("air_eval_composition", ps[:1])}, tmp_path)[0]
    shift, invv = _u32(rng, 4).astype(np.uint64), _u32(rng, N)
    bucket = np.zeros((N, 4), np.uint32)
    words = np.ascontiguousarray(table[ps[0].table].astype(np.uint32))
    hneg, hpos = domain_halo(info)
    rows = np.arange(-hneg, N + hpos) % N
    blocks = [np.ascontiguousarray(mats[r][:, rows]) for r in range(4)]
    assert fn(*(_ptr(b) for b in blocks), N + hneg + hpos, 0, N, hneg,
              *(int(s) for s in shift), _ptr(invv), _ptr(bucket),
              _ptr(words), None) == 0
    want0 = np_qm31_mul(np.broadcast_to(shift, (N, 4)),
                        (parts[0] * invv[:, None].astype(np.uint64)) % P)
    assert np.array_equal(bucket, want0.astype(np.uint32))


# ---------------------------------------------------------------------------
# the CPU component against the reference; text and digest
# ---------------------------------------------------------------------------

def test_generated_cpu_composition_equals_reference(programs, host_libs):
    """The CPU component's generated composition, one window [0, N),
    against the JAX package's `DomainEvalContext` body (evaluate,
    `_finalize_logup`, `finalize_acc`) on the same rows."""
    comp, rel = _pick(programs, "fib10", "cpu")
    rv, _rt = rk_trace(rasm.assemble(FIB10_SRC), backend="python")
    rcomps = rdriver.build_components(rv, 1)[0]
    rcomp = rcomps[[c.name for c in rcomps].index("cpu")]
    rrel = rdraw(RChannel(), _relation_widths(
        [component_info(c) for c in programs["fib10"][0]]))
    info = component_info(comp)
    rng = np.random.default_rng(11)
    N = 1 << (LOG + 2)
    main, inter = _u32(rng, (info.n_main, N)), _u32(rng,
                                                    (info.n_logup_cols, N, 4))
    isf = _u32(rng, (1, N))
    claimed, alpha, shift = (_u32(rng, 4).astype(np.uint64) for _ in "cas")
    invv, start = _u32(rng, N), _u32(rng, (N, 4))
    ctx = RC.DomainEvalContext(
        jnp.asarray(main), jnp.asarray(main[:1]), jnp.asarray(inter),
        jnp.asarray(isf[0]), rrel, jnp.asarray(claimed.astype(np.uint32)),
        jnp.asarray(alpha.astype(np.uint32)), params=RC._params_flat(rcomp))
    rcomp.evaluate(ctx)
    RC._finalize_logup(ctx)
    ctx.finalize_acc()
    acc = np.asarray(ctx.acc.as_qm31().v, np.uint64)
    want = np_qm31_add(start, np_qm31_mul(
        np.broadcast_to(shift, acc.shape),
        (acc * invv[:, None].astype(np.uint64)) % P))
    hneg, hpos = domain_halo(info)
    rows = np.arange(-hneg, N + hpos) % N
    mats = {MAIN: np.ascontiguousarray(main[:, rows]), PRE: None,
            INTER: np.ascontiguousarray(
                inter.transpose(0, 2, 1).reshape(-1, N)[:, rows]),
            ISF: np.ascontiguousarray(isf[:, rows])}
    tape = domain_tape(comp, LOG, rel)
    got = start.copy()
    _host_composition(host_libs[("fib10", "cpu", "domain")], tape, mats,
                      tape.uniforms(rel, claimed), alpha, 0, N, hneg, shift,
                      invv, got)
    assert np.array_equal(got, want.astype(np.uint32))


def test_text_and_digest_are_deterministic(programs):
    """One tape gives the same text and library digest every time it is
    generated; two tapes differ; a CPU tape is one piece; an operand
    tape's text is the same at every log size (one library serves
    them)."""
    comp, rel = _pick(programs, "fib10", "cpu")
    tape = domain_tape(comp, LOG, rel)
    ps = tape_cuda.pieces(tape)
    tape._dev.pop("pieces")
    again = tape_cuda.pieces(tape)
    assert [p.text for p in ps] == [p.text for p in again]
    path = kernels.generated_path(ps[0].stem, ps[0].text)
    assert path == kernels.generated_path(again[0].stem, again[0].text)
    assert path.name.startswith("libair_cpu_domain_0-")
    gen = gen_tape(comp, LOG, rel)
    (g,) = tape_cuda.pieces(gen)
    assert len(ps) == 1 and g.text != ps[0].text
    assert kernels.generated_path(g.stem, g.text) != path
    (g2,) = tape_cuda.pieces(gen_tape(comp, LOG + 3, rel))
    assert g2.text == g.text
    other = domain_tape(_pick(programs, "fib10", "mext")[0], LOG, rel)
    assert tape_cuda.pieces(other)[0].text != ps[0].text


def test_program_addresses_are_uniforms(programs):
    """Two guest programs give their CPU and ram_touched components other
    params (entry, exit, heap addresses): the tapes read them from the
    uniform table, so the generated text, and its library, is the same
    for both, and only the uniforms differ."""
    tv, _tt = tk_trace(tasm.assemble(chip_smoke.MIXED_SRC), backend="python")
    mixed = tdriver.build_components(tv, 1)[0]
    fib, rel = programs["fib10"]
    for name in ("cpu", "ram_touched"):
        a = fib[[c.name for c in fib].index(name)]
        b = mixed[[c.name for c in mixed].index(name)]
        assert a.params() != b.params()
        ta, tb = domain_tape(a, LOG, rel), domain_tape(b, LOG, rel)
        assert ta is not tb
        assert [p.text for p in tape_cuda.pieces(ta)] == \
            [p.text for p in tape_cuda.pieces(tb)]
        claimed = np.arange(4, dtype=np.uint64)
        assert not np.array_equal(ta.uniforms(rel, claimed),
                                  tb.uniforms(rel, claimed))
