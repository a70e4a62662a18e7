"""The bf16 instances of the port's block kernels: plain versions against
the JAX package on the CPU.  The CUDA kernels are held to these plain
versions on the card by ``tests/test_torch_cuda.py``.

- K1 (``fused_conv1_pool``, run with ``interpret=True``) against
  ``conv1_block_plain(compute_dtype="bfloat16_full")``, at K1's own test
  tolerance, atol 2e-4 / rtol 2e-3 (``tests/test_fused_conv1.py:57``),
  after both are widened to f32.  K1 asserts H % 3 == 0; the port's
  instance takes any H, so H = 143 is held against the XLA oracle of
  that test, its f32 output cast to bf16 as K1's default output is.
- K3 with its default bf16 output (``fused_conv_block_pm``,
  ``interpret=True``) against the ``bf16_out`` instance, at the bf16
  block's 2e-5.
- ``apply_conv_block(compute_dtype="bfloat16")`` against the
  ``bf16_operands`` instance at 1e-5: the same bf16-rounded operands and
  f32 activations, f32 summation order only.

Where the two f32 sums of a bf16 instance put a post-ReLU activation on
two sides of a bf16 rounding boundary, the outputs may differ by that
ulp (and, with a bf16 output, by one ulp of the output's own rounding);
such elements must be rare (at most 0.1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.models.assembly import (
    fold_preprocess as jax_fold_preprocess,
)
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.models.layers import apply_conv_block
from cut_detection_tpu.ops.nn import batch_norm_infer, max_pool
from cut_detection_tpu.ops.pallas.fused_block_pm import fused_conv_block_pm
from cut_detection_tpu.ops.pallas.fused_conv1 import fused_conv1_pool
from cut_detection_tpu_torch.ops.kernels.conv1_block import (
    conv1_block,
    conv1_block_plain,
)
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    CM_INSTANCES,
    INSTANCES,
    conv_block,
    conv_block_plain,
    instance,
)
from cut_detection_tpu_torch.ops.nn import bn_scale_offset

T = torch.from_numpy
K1_ATOL, K1_RTOL = 2e-4, 2e-3


def _params(rng, cin, cout):
    p = {"kernel": rng.normal(0, 0.1, (3, 3, cin, cout)),
         "bias": rng.normal(0, 0.1, cout),
         "gamma": rng.normal(1, 0.1, cout),
         "beta": rng.normal(0, 0.1, cout)}
    s = {"mean": rng.normal(0, 0.5, cout), "var": rng.uniform(0.5, 2, cout)}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return f32(p), f32(s)


@pytest.fixture(scope="module")
def prod_layer1():
    """The prod net's preprocess-folded layer 1, as numpy."""
    net, _ = jax_default()
    fb = jax_fold_preprocess(jax.device_get(net.bundle))
    return ({k: np.array(v) for k, v in fb["conv"]["params"][0].items()},
            {k: np.array(v) for k, v in fb["conv"]["state"][0].items()})


def _affine(p, s, *, rsqrt):
    return bn_scale_offset(T(s["mean"]), T(s["var"]), T(p["gamma"]),
                           T(p["beta"]), rsqrt=rsqrt)


def _jax_args(p, s):
    return tuple(jnp.asarray(a) for a in (
        p["kernel"], p["bias"], p["gamma"], p["beta"], s["mean"], s["var"]))


def _assert_bf16_close(got, want, offset, atol, rtol):
    """Within ``atol + rtol |want|`` except for rare one-ulp crossings:
    one bf16 ulp of the pooled activation moves ``y = m*s + t`` by at most
    ``2^-7 |m*s|``, and a bf16 output's own rounding by one ulp of ``y``,
    at most ``2^-7 |y|``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    one_ulp = 2.0 ** -7 * (np.abs(want - offset) + np.abs(want)) * 1.001
    assert (diff <= one_ulp + atol).all(), f"max diff {diff.max()}"
    crossings = int(np.count_nonzero(diff > atol + rtol * np.abs(want)))
    assert crossings <= 1e-3 * want.size, (
        f"{crossings} of {want.size} elements outside atol {atol}, "
        f"rtol {rtol}")


@pytest.mark.parametrize("b,h,w,which", [(2, 36, 128, "random"),
                                         (1, 144, 256, "random"),
                                         (3, 45, 96, "random"),
                                         (2, 36, 128, "prod")])
def test_conv1_block_bf16_matches_k1(prod_layer1, b, h, w, which):
    """K1's test shapes, with seeded parameters and with the prod net's
    folded layer 1."""
    rng = np.random.default_rng(hash((b, h, w)) % 2**31)
    x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    p, s = prod_layer1 if which == "prod" else _params(rng, 3, 48)
    want = fused_conv1_pool(jnp.asarray(x), *_jax_args(p, s),
                            interpret=True)
    assert want.dtype == jnp.bfloat16
    scale, offset = _affine(p, s, rsqrt=False)
    got = conv1_block_plain(T(x), T(p["kernel"]).to(torch.bfloat16),
                            T(p["bias"]), scale, offset,
                            compute_dtype="bfloat16_full")
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (b, h // 3, (w - 3) // 3 + 1, 48)
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32),
                       offset.numpy(), K1_ATOL, K1_RTOL)


def _k1_oracle(x_u8, p, s):
    """The XLA oracle of ``tests/test_fused_conv1.py``: bf16 operands, f32
    accumulation, the ReLU output rounded to bf16, the pool and the BN in
    f32; then K1's default output cast to bf16."""
    conv = jax.lax.conv_general_dilated(
        jnp.asarray(x_u8, jnp.float32).astype(jnp.bfloat16),
        jnp.asarray(p["kernel"]).astype(jnp.bfloat16), (1, 1),
        ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    z = jnp.maximum(conv + p["bias"], 0).astype(jnp.bfloat16)
    pooled = max_pool(z.astype(jnp.float32), 3)
    y = batch_norm_infer(pooled, *(jnp.asarray(a) for a in (
        s["mean"], s["var"], p["gamma"], p["beta"])))
    return y.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.mark.parametrize("b,h,w", [(2, 143, 256), (1, 37, 64)])
def test_conv1_block_bf16_any_height_matches_oracle(prod_layer1, b, h, w):
    """An H that 3 does not divide (the odd golden clip's 256x143), which
    K1 itself refuses, against the XLA oracle."""
    x = np.random.default_rng(h).integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)
    p, s = prod_layer1
    want = _k1_oracle(x, p, s)
    scale, offset = _affine(p, s, rsqrt=False)
    got = conv1_block_plain(T(x), T(p["kernel"]).to(torch.bfloat16),
                            T(p["bias"]), scale, offset,
                            compute_dtype="bfloat16_full")
    assert tuple(got.shape) == (b, h // 3, (w - 3) // 3 + 1, 48)
    _assert_bf16_close(got.float().numpy(), want, offset.numpy(), K1_ATOL,
                       K1_RTOL)


def _bf16_input(rng, shape):
    x = rng.normal(0, 1, shape).astype(np.float32)
    return T(x).to(torch.bfloat16)


@pytest.mark.parametrize("h,w,cin", [(48, 85, 48), (16, 28, 48),
                                     (144, 256, 3)])
def test_conv_block_bf16_out_matches_k3(h, w, cin):
    """K3 with its default bf16 output: layers 2 and 3 of the
    ``bfloat16_full`` rung, and its unfolded layer 1 (Cin = 3)."""
    rng = np.random.default_rng(h + cin)
    b = 1 if cin == 3 else 2
    x = _bf16_input(rng, (b, h, w, cin))
    p, s = _params(rng, cin, 48)
    want = fused_conv_block_pm(jnp.asarray(x.float().numpy()),
                               *_jax_args(p, s), interpret=True)
    assert want.dtype == jnp.bfloat16
    scale, offset = _affine(p, s, rsqrt=False)
    got = conv_block_plain(x, T(p["kernel"]).to(torch.bfloat16),
                           T(p["bias"]), scale, offset,
                           compute_dtype="bfloat16_full",
                           out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), want.astype(jnp.float32),
                       offset.numpy(), 2e-5, 2e-5)


@pytest.mark.parametrize("b,h,w,cin", [(2, 48, 85, 48), (2, 16, 28, 48),
                                       (1, 12, 20, 3), (1, 10, 9, 8)])
def test_conv_block_bf16_operands_matches_apply_conv_block(b, h, w, cin):
    """The ``bfloat16`` rung's block on f32 activations that are not
    bf16 values: both sides round them to bf16 and never round the
    activation after the ReLU."""
    rng = np.random.default_rng(hash((h, w, cin)) % 2**31)
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    p, s = _params(rng, cin, 48)
    want, _ = apply_conv_block(p, s, jnp.asarray(x), train=False,
                               compute_dtype="bfloat16")
    scale, offset = _affine(p, s, rsqrt=True)
    got = conv_block_plain(T(x), T(p["kernel"]), T(p["bias"]), scale,
                           offset, compute_dtype="bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_instances_by_compute_dtype():
    """Each (compute_dtype, out_dtype) names one instance; others raise.
    The launch counts hold those and K4's channel-major instances."""
    names = [instance(*key)[0] for key in INSTANCES]
    assert names == ["f32", "bf16_operands", "bf16_out"]
    assert sorted(conv_block.instance_launches) == sorted(
        names + list(CM_INSTANCES.values()))
    assert sorted(conv1_block.instance_launches) == ["bf16", "f32"]
    for key in (("bfloat16", torch.bfloat16),
                ("bfloat16_full", torch.float32)):
        with pytest.raises(ValueError, match="no instance"):
            instance(*key)
    x = torch.zeros(1, 6, 6, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="no instance"):
        conv1_block(x, torch.zeros(3, 3, 3, 4), *torch.zeros(3, 4),
                    compute_dtype="bfloat16")


def test_bf16_wrappers_on_cpu_take_the_plain_version(prod_layer1):
    """A CPU tensor runs the plain version of every instance and counts
    no launch."""
    p, s = prod_layer1
    rng = np.random.default_rng(4)
    x = T(rng.integers(0, 256, (1, 9, 12, 3), dtype=np.uint8))
    scale, offset = _affine(p, s, rsqrt=False)
    k = T(p["kernel"]).to(torch.bfloat16)
    before = (dict(conv1_block.instance_launches),
              dict(conv_block.instance_launches))
    got = conv1_block(x, k, T(p["bias"]), scale, offset,
                      compute_dtype="bfloat16_full")
    torch.testing.assert_close(
        got, conv1_block_plain(x, k, T(p["bias"]), scale, offset,
                               compute_dtype="bfloat16_full"), rtol=0, atol=0)
    xf = T(rng.normal(0, 1, (1, 9, 12, 3)).astype(np.float32))
    for compute_dtype, out_dtype in INSTANCES:
        xk = xf.to(torch.bfloat16) if compute_dtype == "bfloat16_full" else xf
        kk = k if compute_dtype == "bfloat16_full" else k.float()
        args = (xk, kk, T(p["bias"]), scale, offset)
        got = conv_block(*args, compute_dtype=compute_dtype,
                         out_dtype=out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(
            got, conv_block_plain(*args, compute_dtype=compute_dtype,
                                  out_dtype=out_dtype), rtol=0, atol=0)
    assert (dict(conv1_block.instance_launches),
            dict(conv_block.instance_launches)) == before
    assert set(before[0].values()) | set(before[1].values()) == {0}
