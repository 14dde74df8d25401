"""Circle FFT and inverse FFT in plain PyTorch, on any device.

``interpolate_plain`` maps evals on domain(n) (layout order) to
coefficients in bit-reversed order, scaled by 1/N; ``evaluate_plain``
runs the stages in reverse; extending to a larger basis is a
zero-interleave (``extend_coeffs``).

Interpolation stage j (j = 1..n) views the row as (2^(j-1), 2, half),
half = N / 2^j, and computes f0 = a + b, f1 = (a - b)·t[k] with the
inverse y-twiddles at stage 1 and the inverse x-twiddles of stage j
after.  Evaluation stage j computes a = f0 + t·f1, b = f0 - t·f1, from
j = n down to 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import dev_const
from .circle import domain
from .field import P, m31_add, m31_sub, m31_mul

__all__ = ["twiddle_table", "interpolate_plain", "evaluate_plain",
           "extend_coeffs"]


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
# Public entry points
# ---------------------------------------------------------------------------


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

