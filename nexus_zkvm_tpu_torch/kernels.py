"""Build, load and launch the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with
``ctypes``.  The build happens at first use, into ``build/kernels/`` at
the repository root, one ``nvcc`` per source, all started together.  A
library's file name carries a digest of its source and the local
headers it includes, so an edited source is rebuilt and an unchanged one
is loaded as is.

Kernel K7 is generated: ``air/tape_cuda.py`` writes each constraint
tape out as a source (in pieces for a large tape) on the template
``csrc/air_eval_gen.cuh``.  :func:`build_generated` writes those sources
into ``build/kernels/`` beside their libraries, under the same digest
rule, and builds them as many at once as the machine has CPUs, the
longest first; :func:`launch_generated` runs a
tape's pieces as one launch of :data:`GENERATED`'s kernel name.

Every C entry point launches one kernel (in one or more passes) on the
stream it is given, the current stream of the device its tensors lie
on, and returns ``cudaGetLastError()``;
:func:`launch` raises if that is not 0 and adds one to the kernel's
launch count.  Nothing here runs at import time: the CPU tests import
every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "ENTRIES", "GENERATED", "build", "launch",
           "build_generated", "generated_entries", "launch_generated",
           "ptxas_summary", "launch_counts", "reset_launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint32

# kernel name -> (source, C entry point, argtypes).  Every entry point
# ends with the stream argument.
KERNELS = {
    "circle_ifft": ("cfft", "nzt_circle_ifft",
                    [_P, _P, _P, _L, _I, _U, _I, _P]),
    "circle_fft": ("cfft", "nzt_circle_fft", [_P, _P, _P, _L, _I, _I, _I, _P]),
    "blake2s_messages": ("blake2s", "nzt_blake2s_messages",
                         [_P, _P, _L, _I, _L, _L]),
    "blake2s_parents": ("blake2s", "nzt_blake2s_parents", [_P, _P, _L]),
    "blake2s_leaves_stream": ("blake2s", "nzt_blake2s_leaves_stream",
                              [_P, _P, _L, _I, _I, _L, _L, _I, _I, _I, _L]),
    "deep_quotients": ("quotients", "nzt_deep_quotients",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                        _I, _I, _L, _P]),
    "quotient_colsums": ("quotients", "nzt_quotient_colsums",
                         [_P, _P, _P, _I, _I, _L, _I, _I, _I, _L]),
    "quotient_finalize": ("quotients", "nzt_quotient_finalize",
                          [_P, _P, _P, _P, _I, _L, _P]),
    "fri_fold": ("fri", "nzt_fri_fold",
                 [_P, _P, _L, _P, _U, _U, _U, _U, _P, _P, _U, _U, _U, _U]),
    "cpu_fill": ("fill", "nzt_cpu_fill", [_P, _L] + [_U] * 7 + [_P, _P]),
    "logup_columns": ("logup", "nzt_logup_columns",
                      [_P, _P, _I, _L, _P, _P, _P]),
    "oods_dot": ("oods", "nzt_oods_dot",
                 [_P, _I, _P, _P, _L, _L, _I, _P, _P, _L, _P]),
    "gather_openings": ("gather", "nzt_gather_openings", [_P, _I, _I, _P]),
}

# further C entry points of a kernel's source: entry -> (the kernel whose
# launches it counts as, argtypes)
ENTRIES = {
    "nzt_gather_columns": ("gather_openings", [_P, _L, _L, _L, _P, _L, _P]),
}

# generated kernel name -> argtypes of every piece's ``nzt_tape_entry``
# (the four role pointers first, the piece's table words and the stream
# last)
GENERATED = {
    "air_eval_composition": [_P] * 4 + [_L] * 4 + [_U] * 4 + [_P, _P, _P],
    "air_eval_operands": [_P] * 4 + [_L] * 4 + [_P, _P],
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LAUNCHES = {name: 0 for name in [*KERNELS, *GENERATED]}
_LIBS: dict = {}
_GEN_LIBS: dict = {}            # library path -> ctypes.CDLL
_LOCK = threading.Lock()


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return cand


def _includes(text: str) -> list:
    return re.findall(r'#include "([^"]+)"', text)


def _inputs(source: str) -> list:
    """``source``.cu and the local headers it includes, recursively."""
    return _headers([f"{source}.cu"])


def _headers(todo: list) -> list:
    """The files of ``csrc/`` named and the local headers they include,
    recursively."""
    seen = set()
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            todo += _includes((CSRC / name).read_text())
    return sorted(seen)


def _lib_path(source: str) -> Path:
    h = hashlib.blake2s()
    for name in _inputs(source):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source not yet built (in parallel) and load all
    libraries.  Returns the seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        sources = sorted({src for src, _f, _a in KERNELS.values()})
        todo = [s for s in sources if s not in _LIBS]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{src}.cu")]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {src}.cu failed:\n{log}")
            else:
                tmp.replace(out)
                out.with_suffix(".ptxas.txt").write_text(log)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in todo:
            lib = ctypes.CDLL(str(_lib_path(src)))
            entries = [(fn, argtypes) for s, fn, argtypes in KERNELS.values()
                       if s == src]
            entries += [(fn, argtypes) for fn, (k, argtypes) in ENTRIES.items()
                        if KERNELS[k][0] == src]
            for fn, argtypes in entries:
                f = getattr(lib, fn)
                f.argtypes = argtypes + [_P]
                f.restype = ctypes.c_int
            _LIBS[src] = lib
    return time.perf_counter() - t0


def launch(kernel: str, *args, device: torch.device,
           entry: str | None = None) -> None:
    """Launch ``kernel`` on ``device``'s current stream, the device of
    the tensors it reads and writes (with that device current, whatever
    device the process had current); raise on a refused launch.  Pointer
    arguments are passed as Python ints.  ``entry``: another C entry of
    the kernel's source (:data:`ENTRIES`), counted as its launch."""
    src, fn, _argtypes = KERNELS[kernel]
    if entry is not None:
        if ENTRIES[entry][0] != kernel:
            raise ValueError(f"{entry} is not an entry of {kernel}")
        fn = entry
    if src not in _LIBS:
        build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_LIBS[src], fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {rc}")
    _LAUNCHES[kernel] += 1


def generated_path(stem: str, text: str) -> Path:
    """The library of a generated source: its name carries a digest of
    the text and of the ``csrc/`` headers it includes."""
    h = hashlib.blake2s(text.encode())
    for name in _headers(_includes(text)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_generated(sources: list) -> dict:
    """Build and load the generated sources ``sources`` [(kernel name in
    :data:`GENERATED`, library path from `generated_path`, text)] that
    are not loaded yet: each text is written to ``build/kernels/``
    beside its library, and every library not on disk is compiled, one
    ``nvcc`` a source, as many at once as the machine has CPUs, the
    longest source first (the ptxas report beside each).  A failed build
    raises with the compiler's log.  Returns {"seconds", "built",
    "loaded", "slowest_s", "cpu_s", "pieces": {library file name:
    {"wall_s", "cpu_s"} of its nvcc}}."""
    t0 = time.perf_counter()
    rec = {"built": 0, "loaded": 0, "slowest_s": 0.0, "cpu_s": 0.0,
           "pieces": {}}
    with _LOCK:
        todo = {lib: (name, text) for name, lib, text in sources
                if lib not in _GEN_LIBS}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        queue = sorted((lib for lib in todo if not lib.exists()),
                       key=lambda lib: -len(todo[lib][1]))
        running, errors = [], []
        while queue or running:
            while queue and len(running) < (os.cpu_count() or 1):
                running.append(_start_nvcc(queue.pop(0), todo))
            for job in list(running):
                lib, tmp, log, proc, start = job
                # its CPU seconds: its own and its children's (cicc,
                # ptxas, the host compiler)
                pid, status, ru = os.wait4(proc.pid, os.WNOHANG)
                if not pid:
                    continue
                running.remove(job)
                if os.waitstatus_to_exitcode(status) != 0:
                    errors.append(f"nvcc {lib.name} failed:\n"
                                  f"{log.read_text()}")
                    continue
                tmp.replace(lib)
                log.replace(lib.with_suffix(".ptxas.txt"))
                secs, cpu = time.perf_counter() - start, \
                    ru.ru_utime + ru.ru_stime
                rec["pieces"][lib.name] = {"wall_s": secs, "cpu_s": cpu}
                rec["slowest_s"] = max(rec["slowest_s"], secs)
                rec["cpu_s"] += cpu
            if running:
                time.sleep(0.02)
        rec["built"] = len(rec["pieces"])
        if errors:
            raise RuntimeError("\n".join(errors))
        for lib, (name, _text) in todo.items():
            dll = ctypes.CDLL(str(lib))
            dll.nzt_tape_entry.argtypes = GENERATED[name] + [_P]
            dll.nzt_tape_entry.restype = ctypes.c_int
            _GEN_LIBS[lib] = dll
        rec["loaded"] = len(todo)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _start_nvcc(lib: Path, todo: dict) -> list:
    """Write ``lib``'s source beside it (if no process has) and start its
    nvcc into a file of this process; [lib, tmp, log, Popen, start]."""
    src = lib.with_name(lib.name[3:]).with_suffix(".cu")
    tag = f".{os.getpid()}.tmp"
    if not src.exists():
        src_tmp = src.with_suffix(src.suffix + tag)
        src_tmp.write_text(todo[lib][1])
        src_tmp.replace(src)
    tmp, log = lib.with_suffix(tag), lib.with_suffix(".ptxas" + tag)
    with open(log, "w") as f:
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                                 str(tmp), str(src)], stdout=f,
                                stderr=subprocess.STDOUT)
    return [lib, tmp, log, proc, time.perf_counter()]


def generated_entries(name: str, sources: list) -> list:
    """The C entry points of the generated sources [(library path,
    text)] of kernel ``name``, built and loaded at first use."""
    if any(lib not in _GEN_LIBS for lib, _t in sources):
        build_generated([(name, lib, text) for lib, text in sources])
    return [_GEN_LIBS[lib].nzt_tape_entry for lib, _t in sources]


def launch_generated(name: str, calls: list, device: torch.device) -> None:
    """Run the generated entries ``calls`` [(entry, args)] in turn on
    ``device``'s current stream (pointers as Python ints); raise on a
    refused launch; count one launch of ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for fn, args in calls:
            rc = fn(*args, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: a generated piece failed with "
                                   f"CUDA error {rc}")
    _LAUNCHES[name] += 1


def ptxas_summary(lib: Path) -> dict:
    """Registers and spill bytes of a library's kernels, from the ptxas
    report beside it: {"registers": max, "spill_store_bytes": sum,
    "spill_load_bytes": sum}."""
    text = lib.with_suffix(".ptxas.txt").read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    st = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    ld = [int(x) for x in re.findall(r"(\d+) bytes spill loads", text)]
    return {"registers": max(regs, default=0), "spill_store_bytes": sum(st),
            "spill_load_bytes": sum(ld)}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def check_cuda_tensor(t: torch.Tensor, name: str, ndim: int | None = None,
                      contiguous: bool = True,
                      dtype: torch.dtype = torch.int32) -> None:
    """Wrapper-side argument check: CUDA, dtype (int32 unless given),
    rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {t.dim()}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
