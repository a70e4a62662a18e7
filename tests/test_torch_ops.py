"""The port's ``ops/nn.py`` against its JAX twin, on the CPU.

Same seeded numpy inputs through both; tolerance 1e-5 absolute (f32
summation order only), for float32 and for the ``compute_dtype`` rungs,
whose bf16-rounded operands multiply exactly in f32.  A ``bfloat16_full``
convolution returns bf16: there the two may differ by one bf16 ulp where
the f32 sums fall on two sides of a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.ops import nn as jnn
from cut_detection_tpu_torch.ops import nn as tnn

ATOL = 1e-5


def _rng(*key):
    return np.random.default_rng(hash(key) % 2**31)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,cout", [((2, 7, 9, 4), 5), ((1, 12, 10, 3), 8)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv2d_same(shape, cout, with_bias):
    rng = _rng("conv", shape, cout)
    x = rng.normal(0, 1, shape).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, shape[3], cout)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32) if with_bias else None
    want = jnn.conv2d_same(jnp.asarray(x), jnp.asarray(k),
                           None if b is None else jnp.asarray(b))
    got = tnn.conv2d_same(torch.from_numpy(x), torch.from_numpy(k),
                          None if b is None else torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_full"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv2d_same_compute_dtype(compute_dtype, with_bias):
    rng = _rng("conv_bf16", compute_dtype, with_bias)
    x = rng.normal(0, 1, (2, 9, 11, 6)).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 6, 5)).astype(np.float32)
    b = rng.normal(0, 0.1, 5).astype(np.float32) if with_bias else None
    want = np.asarray(jnn.conv2d_same(
        jnp.asarray(x), jnp.asarray(k), None if b is None else jnp.asarray(b),
        compute_dtype=compute_dtype)).astype(np.float32)
    got = tnn.conv2d_same(torch.from_numpy(x), torch.from_numpy(k),
                          None if b is None else torch.from_numpy(b),
                          compute_dtype=compute_dtype)
    if compute_dtype == "bfloat16":
        assert got.dtype == torch.float32
        _close(got, want)
        return
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    diff = np.abs(got - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + ATOL).all()
    assert np.count_nonzero(diff > ATOL) <= 1e-2 * want.size


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_full"])
def test_linear_compute_dtype(compute_dtype):
    rng = _rng("linear_bf16", compute_dtype)
    x = rng.normal(0, 1, (4, 768)).astype(np.float32)
    w = rng.normal(0, 0.05, (768, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, 32).astype(np.float32)
    want = jnn.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      compute_dtype=compute_dtype)
    got = tnn.linear(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), compute_dtype=compute_dtype)
    assert got.dtype == torch.float32
    _close(got, want)


def test_bn_scale_offset_forms():
    """``gamma * rsqrt`` (``batch_norm_infer``) and the Pallas kernels'
    ``gamma / sqrt`` (``rsqrt=False``) agree to an f32 ulp or two."""
    rng = _rng("bn_forms")
    mean, gamma, beta = (rng.normal(0, 1, 48).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.1, 3, 48).astype(np.float32)
    args = [torch.from_numpy(a) for a in (mean, var, gamma, beta)]
    s1, t1 = tnn.bn_scale_offset(*args)
    s2, t2 = tnn.bn_scale_offset(*args, rsqrt=False)
    np.testing.assert_array_equal(
        s2.numpy(), (torch.from_numpy(gamma)
                     / torch.sqrt(torch.from_numpy(var) + tnn.BN_EPS)).numpy())
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)
    torch.testing.assert_close(t1, t2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 9, 12, 3), (1, 10, 11, 4),
                                   (2, 5, 3, 2)])
def test_max_pool_floor(shape):
    x = _rng("pool", shape).normal(0, 1, shape).astype(np.float32)
    _close(tnn.max_pool(torch.from_numpy(x), 3),
           jnn.max_pool(jnp.asarray(x), 3))


@pytest.mark.parametrize("in_size,out_size", [(5, 4), (9, 4), (7, 3),
                                              (4, 4)])
def test_adaptive_pool_matrix(in_size, out_size):
    np.testing.assert_array_equal(
        tnn._adaptive_pool_matrix(in_size, out_size),
        jnn._adaptive_pool_matrix(in_size, out_size))


@pytest.mark.parametrize("shape,out_size", [((2, 5, 9, 6), 4),
                                            ((1, 4, 7, 3), 2)])
def test_adaptive_avg_pool(shape, out_size):
    """5x9 -> 4x4 is the prod net's overlapping-bin case."""
    x = _rng("aap", shape).normal(0, 1, shape).astype(np.float32)
    _close(tnn.adaptive_avg_pool(torch.from_numpy(x), out_size),
           jnn.adaptive_avg_pool(jnp.asarray(x), out_size))


def test_flatten_nchw_order():
    x = _rng("flat").normal(0, 1, (2, 4, 4, 5)).astype(np.float32)
    got = tnn.flatten_nchw_order(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnn.flatten_nchw_order(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(2, 3, 4, 6), (5, 6)])
def test_batch_norm_infer(shape):
    rng = _rng("bn", shape)
    c = shape[-1]
    x = rng.normal(0, 2, shape).astype(np.float32)
    mean = rng.normal(0, 1, c).astype(np.float32)
    var = rng.uniform(0.1, 3, c).astype(np.float32)
    gamma = rng.normal(1, 0.2, c).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    want = jnn.batch_norm_infer(*map(jnp.asarray, (x, mean, var, gamma,
                                                   beta)))
    got = tnn.batch_norm_infer(*map(torch.from_numpy, (x, mean, var, gamma,
                                                       beta)))
    _close(got, want)


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear(with_bias):
    rng = _rng("linear", with_bias)
    x = rng.normal(0, 1, (4, 768)).astype(np.float32)
    w = rng.normal(0, 0.05, (768, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, 32).astype(np.float32) if with_bias else None
    want = jnn.linear(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b))
    got = tnn.linear(torch.from_numpy(x), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b))
    _close(got, want)


def test_bn_eps_matches():
    assert tnn.BN_EPS == jnn.BN_EPS
