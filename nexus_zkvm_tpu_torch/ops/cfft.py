"""Circle FFT / inverse FFT / low-degree extension (kernel K1).

Same basis and layout as the JAX package: ``interpolate`` maps evals on
domain(n) (layout order) to coefficients in bit-reversed order, scaled
by 1/N; ``evaluate`` runs the stages in reverse; extending to a larger
basis is a zero-interleave (``extend_coeffs``).

Interpolation stage j (j = 1..n) views the row as (2^(j-1), 2, half),
half = N / 2^j, and computes f0 = a + b, f1 = (a - b)·t[k] with the
inverse y-twiddles at stage 1 and the inverse x-twiddles of stage j
after.  The butterflies are in place: f0 replaces a, f1 replaces b.
Evaluation stage j computes a = f0 + t·f1, b = f0 - t·f1, from j = n
down to 1.

On a CUDA tensor a whole transform is one launch of ``csrc/cfft.cu``,
which runs the stages in a few passes over shared-memory tiles
(:func:`_pass_plan`) and fuses an LDE's zero-extension into its first
pass; on a CPU tensor the plain PyTorch version below runs the same
stages.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..utils.device import dev_const
from .circle import domain
from .field import P, m31_add, m31_sub, m31_mul

__all__ = ["interpolate", "evaluate", "extend_coeffs", "lde",
           "interpolate_plain", "evaluate_plain", "twiddle_table"]


def _log2(n: int) -> int:
    k = int(n).bit_length() - 1
    assert 1 << k == n and k >= 1, f"size {n} is not a power of two >= 2"
    return k


def twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """All stage twiddles of domain(log_n), concatenated: stage j's
    2^(log_n - j) entries start at N - 2^(log_n - j + 1)."""
    def build():
        d = domain(log_n)
        if inverse:
            parts = [d.inv_y_twiddles] + d.inv_x_twiddle_stages
        else:
            parts = [d.y_twiddles] + d.x_twiddle_stages
        return np.concatenate(parts).astype(np.uint32)
    return dev_const("cfft.inv_tw" if inverse else "cfft.tw", log_n, device,
                     build)


def _stage_off(n: int, j: int) -> int:
    return (1 << n) - (1 << (n - j + 1))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def interpolate_plain(evals: torch.Tensor) -> torch.Tensor:
    n = _log2(evals.shape[-1])
    tw = twiddle_table(n, True, evals.device)
    v = evals.to(torch.int64)
    shape = v.shape
    for j in range(1, n + 1):
        half = 1 << (n - j)
        s = v.reshape(shape[:-1] + (1 << (j - 1), 2, half))
        a, b = s[..., 0, :], s[..., 1, :]
        t = tw[_stage_off(n, j): _stage_off(n, j) + half]
        v = torch.stack([m31_add(a, b), m31_mul(m31_sub(a, b), t)],
                        dim=-2).reshape(shape)
    return m31_mul(v, pow(1 << n, P - 2, P)).to(torch.int32)


def evaluate_plain(coeffs: torch.Tensor) -> torch.Tensor:
    n = _log2(coeffs.shape[-1])
    tw = twiddle_table(n, False, coeffs.device)
    v = coeffs.to(torch.int64)
    shape = v.shape
    for j in range(n, 0, -1):
        half = 1 << (n - j)
        s = v.reshape(shape[:-1] + (1 << (j - 1), 2, half))
        f0, f1 = s[..., 0, :], s[..., 1, :]
        tf1 = m31_mul(tw[_stage_off(n, j): _stage_off(n, j) + half], f1)
        v = torch.stack([m31_add(f0, tf1), m31_sub(f0, tf1)],
                        dim=-2).reshape(shape)
    return v.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel K1
# ---------------------------------------------------------------------------

TILE_LOG = 14      # a tile holds 2^14 words: 66 KB of shared memory, padded
LOG_W = 4          # a large-half tile reads runs of at least 2^4 words
_LOG_W_MAX = 5     # and of at most 2^5 (128 bytes)


def _pass_plan(k: int, n: int, inverse: bool, T: int = TILE_LOG,
               logw: int = LOG_W) -> list:
    """The passes of csrc/cfft.cu for a transform of 2^k inputs on 2^n
    points (k < n: a forward LDE from 2^k coefficients), in the order they
    run, as (lo, hi, wb, s0): the pass runs the stages of position bits
    [s0, hi) on tiles of 2^(wb + hi - lo) <= 2^T words, every position
    whose bits [0, wb) and [lo, hi) vary.  The small-half pass (lo = 0)
    takes up to T bits; the rest are split evenly into large-half passes
    of at most T - logw stages, whose runs of 2^wb contiguous words are
    as long as the tile allows, up to 2^5.  So n <= T takes one pass and
    n <= 2T - logw two.  The first log_n - log_k forward stages act on
    zero odd halves and are not run: the first pass reads the compact
    input."""
    assert 1 <= k <= n <= 30 and not (inverse and k < n), (k, n, inverse)
    assert 0 <= logw < T, (T, logw)
    e = n - k
    h = min(n, T)
    passes = [(0, h, 0, e)] if h > e else []
    lo = h if h > e else e
    rest = n - lo
    m = -(-rest // (T - logw))
    for i in range(m):
        st = rest // m + (i < rest % m)
        passes.append((lo, lo + st, min(lo, T - st, _LOG_W_MAX), lo))
        lo += st
    return passes[::-1] if inverse else passes


def _transform_cuda(x: torch.Tensor, n: int, inverse: bool,
                    out=None) -> torch.Tensor:
    """One K1 launch: the inverse FFT of x (..., 2^n), or the forward FFT
    of x (..., 2^k) on 2^n points; ``out`` may be ``x`` itself."""
    kernels.check_cuda_tensor(x, "cfft input")
    k = _log2(x.shape[-1])
    rows = x.numel() >> k
    shape = x.shape[:-1] + (1 << n,)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=x.device)
    kernels.check_cuda_tensor(out, "cfft output")
    if out.shape != shape:
        raise ValueError(f"output {tuple(out.shape)} for input "
                         f"{tuple(x.shape)} on 2^{n} points")
    plan = _pass_plan(k, n, inverse)
    flat = (ctypes.c_int * (4 * len(plan)))(*[v for p in plan for v in p])
    tw = twiddle_table(n, inverse, x.device)
    if inverse:
        kernels.launch("circle_ifft", x.data_ptr(), out.data_ptr(),
                       tw.data_ptr(), rows, n, pow(1 << n, P - 2, P),
                       len(plan), flat, device=x.device)
    else:
        kernels.launch("circle_fft", x.data_ptr(), out.data_ptr(),
                       tw.data_ptr(), rows, k, n, len(plan), flat,
                       device=x.device)
    return out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def interpolate(evals: torch.Tensor, out=None) -> torch.Tensor:
    """(..., N) int32 evals (layout order) -> bit-reversed coefficients,
    into ``out`` (contiguous, the same shape; ``evals`` itself is allowed)
    when given."""
    if evals.is_cuda:
        return _transform_cuda(evals, _log2(evals.shape[-1]), True, out)
    if evals.device.type == "cpu":
        cf = interpolate_plain(evals)
        return cf if out is None else out.copy_(cf)
    raise ValueError(f"unsupported device {evals.device}")


def extend_coeffs(coeffs: torch.Tensor, log_size: int) -> torch.Tensor:
    """Embed bit-reversed coeffs of a 2^k basis into a 2^log_size basis
    (zero-interleave with stride 2^(log_size - k))."""
    stride = (1 << log_size) // coeffs.shape[-1]
    if stride == 1:
        return coeffs
    out = torch.zeros(coeffs.shape[:-1] + (1 << log_size,),
                      dtype=coeffs.dtype, device=coeffs.device)
    out[..., ::stride] = coeffs
    return out


def evaluate(coeffs: torch.Tensor, log_size: int | None = None
             ) -> torch.Tensor:
    """Bit-reversed coefficients -> evals on domain(log_size), layout
    order, zero-extending first when log_size exceeds the input basis (on
    the card, inside the kernel's first pass)."""
    k = _log2(coeffs.shape[-1])
    n = k if log_size is None else max(k, log_size)
    if coeffs.is_cuda:
        return _transform_cuda(coeffs.contiguous(), n, False)
    if coeffs.device.type == "cpu":
        return evaluate_plain(extend_coeffs(coeffs, n))
    raise ValueError(f"unsupported device {coeffs.device}")


def lde(evals: torch.Tensor, log_blowup: int) -> torch.Tensor:
    n = _log2(evals.shape[-1])
    return evaluate(interpolate(evals), n + log_blowup)
