"""Build, load and launch the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface and loaded with
``ctypes``.  The build happens at first use, into ``build/kernels/`` at
the repository root, one ``nvcc`` per source, all started together.  A
library's file name carries a digest of its source and the local
headers it includes, so an edited source is rebuilt and an unchanged one
is loaded as is.

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

__all__ = ["KERNELS", "build", "launch", "launch_counts", "reset_launches"]

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
                              [_P, _P, _L, _I, _I, _L, _L, _I, _I]),
    "deep_quotients": ("quotients", "nzt_deep_quotients",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                        _I, _I, _L, _P]),
    "quotient_colsums": ("quotients", "nzt_quotient_colsums",
                         [_P, _P, _P, _I, _I, _L, _I, _I]),
    "quotient_finalize": ("quotients", "nzt_quotient_finalize",
                          [_P, _P, _P, _P, _I, _L, _P]),
    "fri_fold": ("fri", "nzt_fri_fold",
                 [_P, _P, _L, _P, _U, _U, _U, _U, _P, _P, _U, _U, _U, _U]),
    "cpu_fill": ("fill", "nzt_cpu_fill", [_P, _L] + [_U] * 7 + [_P, _P]),
    "logup_columns": ("logup", "nzt_logup_columns",
                      [_P, _P, _I, _L, _P, _P]),
    "air_eval_composition": ("air_eval", "nzt_air_eval_composition",
                             [_P, _I, _P, _I, _L, _L, _L, _I, _I]
                             + [_U] * 4 + [_P, _P]),
    "air_eval_operands": ("air_eval", "nzt_air_eval_operands",
                          [_P, _I, _P, _I, _L, _I, _I, _P, _P]),
    "oods_dot": ("oods", "nzt_oods_dot", [_P, _I, _I, _I, _P, _I, _P, _P]),
    "gather_openings": ("gather", "nzt_gather_openings", [_P, _I, _P, _P]),
}

_LAUNCHES = {name: 0 for name in KERNELS}
_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return cand


def _inputs(source: str) -> list:
    """``source``.cu and the local headers it includes, recursively."""
    seen, todo = set(), [f"{source}.cu"]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.add(name)
            todo += re.findall(r'#include "([^"]+)"',
                               (CSRC / name).read_text())
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
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp),
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
            for name, (s, fn, argtypes) in KERNELS.items():
                if s == src:
                    f = getattr(lib, fn)
                    f.argtypes = argtypes + [_P]
                    f.restype = ctypes.c_int
            _LIBS[src] = lib
    return time.perf_counter() - t0


def launch(kernel: str, *args, device: torch.device) -> None:
    """Launch ``kernel`` on ``device``'s current stream, the device of
    the tensors it reads and writes (with that device current, whatever
    device the process had current); raise on a refused launch.  Pointer
    arguments are passed as Python ints."""
    src, fn, _argtypes = KERNELS[kernel]
    if src not in _LIBS:
        build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_LIBS[src], fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {rc}")
    _LAUNCHES[kernel] += 1


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
