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

On a CUDA tensor each stage is one launch of ``csrc/cfft.cu``; on a CPU
tensor the plain PyTorch version below runs the same stages.
"""

from __future__ import annotations

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

def _stages_cuda(x: torch.Tensor, inverse: bool, out=None) -> torch.Tensor:
    kernels.check_cuda_tensor(x, "cfft input")
    n = _log2(x.shape[-1])
    rows = x.numel() >> n
    if out is None:
        out = torch.empty_like(x)
    kernels.check_cuda_tensor(out, "cfft output")
    if out.shape != x.shape:
        raise ValueError(f"output {tuple(out.shape)} for input "
                         f"{tuple(x.shape)}")
    tw = twiddle_table(n, inverse, x.device)
    src = x
    order = range(1, n + 1) if inverse else range(n, 0, -1)
    inv_n = pow(1 << n, P - 2, P)
    for j in order:
        twp = tw.data_ptr() + 4 * _stage_off(n, j)
        if inverse:
            kernels.launch("circle_ifft", src.data_ptr(), out.data_ptr(),
                           twp, rows, n, j, inv_n if j == n else 1,
                           device=x.device)
        else:
            kernels.launch("circle_fft", src.data_ptr(), out.data_ptr(),
                           twp, rows, n, j, device=x.device)
        src = out
    return out


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def interpolate(evals: torch.Tensor, out=None) -> torch.Tensor:
    """(..., N) int32 evals (layout order) -> bit-reversed coefficients,
    into ``out`` (contiguous, the same shape) when given: the first stage
    reads ``evals``, every later one runs in place in ``out``."""
    if evals.is_cuda:
        return _stages_cuda(evals, inverse=True, out=out)
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
    order, zero-extending first when log_size exceeds the input basis."""
    k = _log2(coeffs.shape[-1])
    if log_size is not None and log_size > k:
        coeffs = extend_coeffs(coeffs, log_size)
    if coeffs.is_cuda:
        return _stages_cuda(coeffs.contiguous(), inverse=False)
    if coeffs.device.type == "cpu":
        return evaluate_plain(coeffs)
    raise ValueError(f"unsupported device {coeffs.device}")


def lde(evals: torch.Tensor, log_blowup: int) -> torch.Tensor:
    n = _log2(evals.shape[-1])
    return evaluate(interpolate(evals), n + log_blowup)
