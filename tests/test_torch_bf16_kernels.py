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
- ``apply_conv_block(compute_dtype="bfloat16_full")`` (XLA's rung) against
  the ``bf16_xla`` instances of ``conv1_block`` and ``conv_block``, per
  layer of the prod net on the JAX layer's own input, and on seeded
  blocks, by ``tolerance.xla_check``; 0 crossings measured on the prod
  layers, so the outputs are bit-identical there.  The ``bf16_xla_f32``
  instance (the last block's, f32 out) against the same block with its
  BN sum read before XLA's last rounding.

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
from cut_detection_tpu_torch.ops.kernels.conv1_block import (
    instance as conv1_instance,
)
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    CM_INSTANCES,
    INSTANCES,
    conv_block,
    conv_block_plain,
    instance,
)
from cut_detection_tpu_torch.ops.kernels.tolerance import xla_check
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
    """Each (compute_dtype, out_dtype, numerics) names one instance, the
    numerics counting only at ``bfloat16_full``; others raise.  The launch
    counts hold those and K4's channel-major instances."""
    names = [instance(c, o, n or "pallas")[0] for c, o, n in INSTANCES]
    assert names == ["f32", "bf16_operands", "bf16_xla", "bf16_xla_f32",
                     "bf16_out"]
    assert instance(None, numerics="xla")[0] == "f32"
    assert sorted(conv_block.instance_launches) == sorted(
        names + list(CM_INSTANCES.values()))
    assert sorted(conv1_block.instance_launches) == ["bf16", "bf16_xla",
                                                     "f32"]
    assert conv1_instance("bfloat16_full", "xla")[0] == "bf16_xla"
    for key in (("bfloat16", torch.bfloat16),
                ("bfloat16_full", torch.float32)):
        with pytest.raises(ValueError, match="no instance"):
            instance(*key)
    with pytest.raises(ValueError, match="numerics"):
        instance("bfloat16_full", torch.bfloat16, "tpu")
    x = torch.zeros(1, 6, 6, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="no instance"):
        conv1_block(x, torch.zeros(3, 3, 3, 4), *torch.zeros(3, 4),
                    compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def prod_xla_layers():
    """The prod net's folded layers at ``bfloat16_full`` and each JAX
    layer's input and output (``apply_conv_block``, XLA's rung) on seeded
    frames: [(params, state, input, output)] as numpy, f32."""
    net, _ = jax_default(precision="bfloat16_full")
    fb = jax_fold_preprocess(jax.device_get(net.bundle))
    x = np.random.default_rng(11).integers(0, 256, (4, 144, 256, 3),
                                           dtype=np.uint8)
    a = jnp.asarray(x, jnp.float32)
    out = []
    for p, s in zip(fb["conv"]["params"], fb["conv"]["state"]):
        y, _ = apply_conv_block(p, s, a, train=False,
                                compute_dtype="bfloat16_full")
        out.append(({k: np.array(v) for k, v in p.items()},
                    {k: np.array(v) for k, v in s.items()},
                    np.array(a.astype(jnp.float32)),
                    np.array(y.astype(jnp.float32))))
        a = y
    return out


def _xla_args(p, s):
    scale, offset = _affine(p, s, rsqrt=True)
    return T(p["kernel"]).to(torch.bfloat16), T(p["bias"]), scale, offset


def _assert_xla_block(got, want, args):
    """``tolerance.xla_check`` of ``got`` against the JAX block's
    ``want`` with the block's arguments (kernel, bias, scale, offset);
    returns the crossings it counts."""
    _, bias, scale, offset = args
    ok, worst, crossings = xla_check(got, T(want).to(got.dtype), offset,
                                     scale, bias)
    assert ok, (worst, crossings)
    return crossings


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_bf16_xla_matches_jax_rung_per_prod_layer(prod_xla_layers, layer):
    """The folded layer 1 (``conv1_block[bf16_xla]`` on the raw frames)
    and layers 2 and 3 (``conv_block[bf16_xla]`` on the JAX layer's bf16
    input) against ``apply_conv_block(compute_dtype="bfloat16_full")`` by
    ``xla_check``: 0 crossings, so bit-identical, on these frames."""
    p, s, x, want = prod_xla_layers[layer]
    args = _xla_args(p, s)
    if layer == 0:
        got = conv1_block(T(x.astype(np.uint8)), *args,
                          compute_dtype="bfloat16_full", numerics="xla")
    else:
        got = conv_block(T(x).to(torch.bfloat16), *args,
                         compute_dtype="bfloat16_full",
                         out_dtype=torch.bfloat16, numerics="xla")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _assert_xla_block(got, want, args) == 0


def test_bf16_xla_unfolded_layer1_matches_jax_rung():
    """The unfolded layer 1 (Cin = 3, the ``--pallas-preprocess`` path) on
    normalized frames: ``conv_block[bf16_xla]`` against the JAX rung's
    block, 0 crossings measured."""
    net, _ = jax_default(precision="bfloat16_full")
    bundle = jax.device_get(net.bundle)
    p = {k: np.array(v) for k, v in bundle["conv"]["params"][0].items()}
    s = {k: np.array(v) for k, v in bundle["conv"]["state"][0].items()}
    x = np.random.default_rng(12).uniform(0, 1, (2, 144, 256, 3)) \
        .astype(np.float32)
    want, _ = apply_conv_block(p, s, jnp.asarray(x), train=False,
                               compute_dtype="bfloat16_full")
    args = _xla_args(p, s)
    got = conv_block(T(x).to(torch.bfloat16), *args,
                     compute_dtype="bfloat16_full", out_dtype=torch.bfloat16,
                     numerics="xla")
    assert _assert_xla_block(got, np.array(want.astype(jnp.float32)),
                             args) == 0


@pytest.mark.parametrize("b,h,w,cin", [(2, 48, 85, 48), (2, 16, 28, 48),
                                       (1, 13, 20, 8), (2, 10, 9, 3)])
def test_bf16_xla_matches_apply_conv_block(b, h, w, cin):
    """Seeded blocks, H % 3 != 0 and Cin < 16 among them: the ``bf16_xla``
    plain version against JAX's block by ``xla_check`` (at most 0.1% of
    the elements crossed); the ``bf16_xla_f32`` output, rounded to bf16,
    is the same block's."""
    rng = np.random.default_rng(hash((b, h, w, cin)) % 2**31)
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    p, s = _params(rng, cin, 48)
    want, _ = apply_conv_block(p, s, jnp.asarray(x), train=False,
                               compute_dtype="bfloat16_full")
    want = np.array(want.astype(jnp.float32))
    args = (T(x).to(torch.bfloat16), *_xla_args(p, s))
    got = conv_block_plain(*args, compute_dtype="bfloat16_full",
                           out_dtype=torch.bfloat16, numerics="xla")
    _assert_xla_block(got, want, args[1:])
    got32 = conv_block_plain(*args, compute_dtype="bfloat16_full",
                             out_dtype=torch.float32, numerics="xla")
    assert got32.dtype == torch.float32
    assert torch.equal(got32.to(torch.bfloat16), got)


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
    for compute_dtype, out_dtype, numerics in INSTANCES:
        xk = xf.to(torch.bfloat16) if compute_dtype == "bfloat16_full" else xf
        kk = k if compute_dtype == "bfloat16_full" else k.float()
        args = (xk, kk, T(p["bias"]), scale, offset)
        kw = {"compute_dtype": compute_dtype, "out_dtype": out_dtype,
              "numerics": numerics or "pallas"}
        got = conv_block(*args, **kw)
        assert got.dtype == out_dtype
        torch.testing.assert_close(got, conv_block_plain(*args, **kw),
                                   rtol=0, atol=0)
    assert (dict(conv1_block.instance_launches),
            dict(conv_block.instance_launches)) == before
    assert set(before[0].values()) | set(before[1].values()) == {0}
