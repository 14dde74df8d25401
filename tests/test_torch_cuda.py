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


@pytest.mark.parametrize("n", [1, 2, 5, 11])
def test_cfft(dev, n):
    x = rand(dev, (3, 1 << n), seed=n)
    assert torch.equal(cfft.interpolate(x), cfft.interpolate_plain(x))
    assert torch.equal(cfft.evaluate(x), cfft.evaluate_plain(x))


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


def test_quotients(dev):
    s, rows = 9, (1, 7, 8)
    blocks = [rand(dev, (r, 1 << s), seed=i) for i, r in enumerate(rows)]
    gcs_np = np.random.default_rng(3).integers(0, P, (2, 16, 4),
                                               dtype=np.uint32)
    gcs_np[1, ::2] = 0
    gcs = from_u32(gcs_np, dev)
    consts = rand(dev, (2, 6, 4), seed=4)
    xs, ys = circle.dev_committed_points(s, dev)
    assert torch.equal(
        quotients.accumulate_blocks(blocks, xs, ys, consts, gcs),
        quotients.accumulate_blocks_plain(blocks, xs, ys, consts, gcs))


def test_fri_fold(dev):
    v, inj = rand(dev, (256, 4), seed=5), rand(dev, (256, 4), seed=6)
    alpha = np.array([1, 2, 3, 4], np.uint64)
    w2 = np.array([5, 6, 7, P - 1], np.uint64)
    tw = fri.dev_line_fold_twiddles(8, dev)
    ctw = fri.dev_circle_fold_twiddles(8, dev)
    assert torch.equal(fri.fold(v, alpha, tw), fri.fold_plain(v, alpha, tw))
    assert torch.equal(fri.fold(v, alpha, tw, inj, ctw, w2),
                       fri.fold_plain(v, alpha, tw, inj, ctw, w2))
