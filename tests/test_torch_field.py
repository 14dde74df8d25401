"""M31/CM31/QM31 arithmetic of the PyTorch port against the JAX package.

Seeded numpy inputs, edge values included, go through both; results
must be equal as uint32 (exact).
"""

import numpy as np
import pytest
import torch

from nexus_zkvm_tpu.ops import field as RF
from nexus_zkvm_tpu_torch.ops import field as TF

P = RF.P
RNG = np.random.default_rng(1234)
EDGES = np.array([0, 1, 2, P - 2, P - 1], np.uint32)


def m31_inputs(n=64):
    """Canonical values: edges crossed with edges, then random."""
    a = np.concatenate([np.repeat(EDGES, len(EDGES)),
                        RNG.integers(0, P, n, dtype=np.uint32)])
    b = np.concatenate([np.tile(EDGES, len(EDGES)),
                        RNG.integers(0, P, n, dtype=np.uint32)])
    return a, b


def qm31_inputs(n=48):
    a = RNG.integers(0, P, (n, 4), dtype=np.uint32)
    b = RNG.integers(0, P, (n, 4), dtype=np.uint32)
    a[:4] = [[0, 0, 0, 1], [1, 0, 0, 0], [P - 1] * 4, [0, P - 1, 1, 0]]
    b[:4] = [[P - 1] * 4, [0, 0, 1, 0], [P - 1] * 4, [1, 1, 1, 1]]
    return a, b


def t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def ref(x):
    return np.asarray(x, np.uint64)


def port(x):
    return x.numpy().astype(np.uint64)


BINARY_M31 = ["m31_add", "m31_sub", "m31_mul"]
UNARY_M31 = ["m31_neg", "m31_inv"]


@pytest.mark.parametrize("name", BINARY_M31)
def test_m31_binary(name):
    a, b = m31_inputs()
    want = ref(getattr(RF, name)(a, b))
    got = port(getattr(TF, name)(t(a), t(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", UNARY_M31)
def test_m31_unary(name):
    a, _ = m31_inputs()
    assert np.array_equal(port(getattr(TF, name)(t(a))),
                          ref(getattr(RF, name)(a)))


def test_m31_reduce_non_canonical():
    x = np.array([0, 1, P - 1, P, P + 1, 2 * P, 2 * P + 1, 0xFFFFFFFF],
                 np.uint32)
    got = port(TF.m31_reduce(torch.from_numpy(x.astype(np.int64))))
    assert np.array_equal(got, ref(RF.m31_reduce(x)))
    assert np.array_equal(got, x.astype(np.uint64) % P)


def test_m31_mul_square_of_p_minus_one():
    # (p-1)^2 folded once gives exactly 2^31 = p + 1: the final
    # conditional subtract must bring it to 1
    x = t([P - 1])
    assert int(TF.m31_mul(x, x)[0]) == 1
    assert int(TF._fold(torch.tensor([(P - 1) ** 2]))[0]) == 1


def test_m31_inv_zero_is_zero_and_inverts():
    a, _ = m31_inputs()
    inv = TF.m31_inv(t(a))
    assert int(TF.m31_inv(t([0]))[0]) == 0
    nz = a != 0
    assert np.all(port(TF.m31_mul(inv, t(a)))[nz] == 1)


def test_m31_fold_sum():
    x = RNG.integers(0, P, (37, 5), dtype=np.uint32)
    x[:, 0] = P - 1
    for axis in (0, 1):
        assert np.array_equal(port(TF.m31_fold_sum(t(x), dim=axis)),
                              ref(RF.m31_fold_sum(x, axis=axis)))


@pytest.mark.parametrize("name", ["cm31_mul", "cm31_inv"])
def test_cm31(name):
    a, b = qm31_inputs()
    a, b = a[:, :2], b[:, :2]
    args_r = (a, b) if name == "cm31_mul" else (a,)
    args_t = tuple(t(x) for x in args_r)
    assert np.array_equal(port(getattr(TF, name)(*args_t)),
                          ref(getattr(RF, name)(*args_r)))


@pytest.mark.parametrize("name", ["qm31_mul", "qm31_inv", "qm31_add",
                                  "qm31_sub", "qm31_mul_m31"])
def test_qm31(name):
    a, b = qm31_inputs()
    if name == "qm31_inv":
        args = (a,)
    elif name == "qm31_mul_m31":
        args = (a, b[:, 0])
    else:
        args = (a, b)
    got = port(getattr(TF, name)(*(t(x) for x in args)))
    assert np.array_equal(got, ref(getattr(RF, name)(*args)))


def test_qm31_inv_roundtrip():
    a, _ = qm31_inputs()
    prod = port(TF.qm31_mul(TF.qm31_inv(t(a)), t(a)))
    nz = a.any(axis=1)
    assert np.array_equal(prod[nz], np.tile([1, 0, 0, 0], (nz.sum(), 1)))


@pytest.mark.parametrize("name", ["np_qm31_mul", "np_qm31_inv",
                                  "np_qm31_conj", "np_cm31_mul"])
def test_host_mirrors(name):
    a, b = qm31_inputs()
    a, b = a.astype(np.uint64), b.astype(np.uint64)
    if name == "np_cm31_mul":
        args = (a[:, :2], b[:, :2])
    elif name in ("np_qm31_inv", "np_qm31_conj"):
        args = (a,)
    else:
        args = (a, b)
    assert np.array_equal(getattr(TF, name)(*args), getattr(RF, name)(*args))
    # the (4,) scalar fast path agrees with the array path
    one = tuple(x[5] for x in args)
    assert np.array_equal(getattr(TF, name)(*one), getattr(RF, name)(*one))


def test_int32_storage_roundtrip():
    from nexus_zkvm_tpu_torch.utils.device import from_u32, to_u32
    x = np.array([0, 1, P - 1, 1 << 31, 0xFFFFFFFF], np.uint32)
    tt = from_u32(x, "cpu")
    assert tt.dtype == torch.int32
    assert np.array_equal(to_u32(tt), x)
