"""The port's quantized rungs, ``uint8_pool`` and ``uint8_chain``, against
the JAX package's on the CPU.

The JAX package computes both in XLA (``models/layers.py:95-106,
126-226``, ``models/frame_conv.py:57-80``); the port in plain PyTorch.
A conv output one bf16 ulp apart (summation order) can land in another
``rint`` bucket, so a block is held by its uint8 codes: every code within
1 of JAX's, and at most 0.1% of them off by 1.  The whole net on 32
seeded frames, folded (raw uint8 into layer 1) and unfolded: identical
argmax and logits within 2e-2 (at most 9.3e-3 measured when written);
then the JAX package's own gate (``tests/test_precision_modes.py:27-31``):
within 0.5 of float32 with float32's classes.  The ring constants are
bit-exact: the strip against the full canvas, as
``test_const_conv_ring_strip_matches_full_canvas`` holds JAX, and
``precompute_rings`` against the rings computed in the forward, as
``test_precompute_rings_bitexact_vs_in_graph`` does.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu.models import layers as jax_layers
from cut_detection_tpu.models.assembly import _glued_apply
from cut_detection_tpu.models.assembly import fold_preprocess as jax_fold
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.ops import nn as jax_nn
from cut_detection_tpu.pipeline import make_classify_step as jax_make_step
from cut_detection_tpu_torch.models import layers
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    load_default_net,
    precompute_rings,
    warn_if_stats_unconverged,
)
from cut_detection_tpu_torch.ops.nn import conv2d_same
from cut_detection_tpu_torch.pipeline import make_classify_step

T = torch.from_numpy
RUNGS = ["uint8_pool", "uint8_chain"]
LOGIT_TOL = 2e-2


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (32, 144, 256, 3),
                                             dtype=np.uint8)


def _folded(net: GluedNet) -> GluedNet:
    out = GluedNet(net.model_params, net.precision)
    out.load_state_dict(fold_preprocess(net.state_dict()))
    return out


def _jax_logits(jnet, x, *, fold):
    bundle = jax_fold(jnet.bundle) if fold else jnet.bundle
    return np.asarray(_glued_apply(
        bundle, jnp.asarray(x, jnp.float32), conv_cfg=jnet.conv_cfg,
        linear_cfg=jnet.linear_cfg, compute_dtype=jnet.compute_dtype))


def _assert_codes(got, want):
    """uint8 codes: all within 1, at most 0.1% of them off by 1."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


def test_conv_quantize_scale_matches_jax():
    net, _ = load_default_net("cpu", "uint8_pool")
    jnet, _ = jax_default(precision="uint8_pool")
    for layer, s in zip(net.conv.conv_layers, jnet.bundle["conv"]["state"]):
        np.testing.assert_array_equal(
            layer.quantize_scale().numpy(),
            np.asarray(jax_layers.conv_quantize_scale(s)))


def _jax_pool_codes(p, s, x):
    """The codes of the JAX uint8_pool block (``layers.py:96-101``)."""
    z = jax_nn.conv2d_same(jnp.asarray(x, jnp.float32), p["kernel"],
                           p["bias"], compute_dtype="bfloat16_full")
    z = jnp.maximum(z, 0).astype(jnp.float32)
    scale = jax_layers.conv_quantize_scale(s)
    q = jnp.clip(jnp.rint(z / scale), 0, 255).astype(jnp.uint8)
    return jax_nn.max_pool(q, 3)


def test_uint8_pool_blocks_match_jax(frames):
    """Per block, from the same input (JAX's previous block output): the
    codes as above, and the block's bf16 output within one code step
    (``scale * s``) plus one bf16 ulp, beyond one ulp on at most 0.1%."""
    jnet, _ = jax_default(precision="uint8_pool")
    bundle = jax_fold(jnet.bundle)
    net = _folded(load_default_net("cpu", "uint8_pool")[0])
    x = frames[:8]
    for layer, p, s in zip(net.conv.conv_layers, bundle["conv"]["params"],
                           bundle["conv"]["state"]):
        want_q = _jax_pool_codes(p, s, x)
        z = conv2d_same(T(np.asarray(x, np.float32)), layer.hwio(),
                        layer.conv.bias, compute_dtype="bfloat16_full")
        got_q = layers.quantize_pool_u8(torch.relu(z).float(),
                                        layer.quantize_scale())
        _assert_codes(got_q.numpy(), want_q)

        want, _ = jax_layers.apply_conv_block(
            p, s, jnp.asarray(x, jnp.float32), compute_dtype="uint8_pool")
        got = layer(T(np.asarray(x)))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        bn = layer.bn
        step = (layer.quantize_scale() * bn.weight
                * torch.rsqrt(bn.running_var + bn.eps)).abs().numpy()
        ulp = 2.0 ** -7 * np.abs(want) + 1e-6
        d = np.abs(got - want)
        assert (d <= step + ulp).all()
        assert (d > ulp).mean() <= 1e-3
        x = want


def test_uint8_chain_blocks_match_jax(frames):
    """Per block of the chain, from JAX's previous codes: the codes as
    above and the pending affine within f32 rounding."""
    jnet, _ = jax_default(precision="uint8_chain")
    bundle = jax_fold(jnet.bundle)
    net = _folded(load_default_net("cpu", "uint8_chain")[0])
    x, jaffine, affine = frames[:8].astype(np.float32), None, None
    for layer, p, s in zip(net.conv.conv_layers, bundle["conv"]["params"],
                           bundle["conv"]["state"]):
        want_q, jaffine = jax_layers.apply_conv_block_u8(
            p, s, jnp.asarray(x), jaffine)
        got_q, affine = layer.forward_u8_chain(T(np.asarray(x)), affine)
        _assert_codes(got_q.numpy(), want_q)
        for g, w in zip(affine, jaffine):
            # t = beta - mean * s cancels: absolute f32 rounding.
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        x = np.array(want_q)
    dense = layers.dequantize_u8(T(x), affine)
    assert dense.dtype == torch.bfloat16
    np.testing.assert_allclose(
        dense.float().numpy(),
        np.asarray(jax_layers.dequantize_u8(jnp.asarray(x), jaffine),
                   np.float32), rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("precision", RUNGS)
def test_quantized_logits_match_jax(frames, precision, fold):
    jnet, _ = jax_default(precision=precision)
    net, _ = load_default_net("cpu", precision)
    if fold:
        got, x = _folded(net)(T(frames)), frames
    else:
        x = frames.astype(np.float32) / 255.0
        got = net(T(x))
    want = _jax_logits(jnet, x, fold=fold)
    got = got.numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("precision", RUNGS)
def test_quantized_rungs_hold_the_float32_gate(frames, precision):
    """``tests/test_precision_modes.py:27-31`` on the port: within 0.5 of
    float32's logits, with its classes."""
    x = T(frames[:8].astype(np.float32) / 255.0)
    ref = load_default_net("cpu", "float32")[0](x).numpy()
    got = load_default_net("cpu", precision)[0](x).numpy()
    assert np.abs(got - ref).max() < 0.5
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_uint8_chain_interlayer_tensors_are_uint8():
    """The chain's inter-block activations are uint8 at their pooled
    shapes (144x256 -> 48x85 -> 16x28 -> 5x9, 48 channels)."""
    net = _folded(load_default_net("cpu", "uint8_chain")[0])
    x, affine = torch.zeros((2, 144, 256, 3), dtype=torch.uint8), None
    shapes = []
    for layer in net.conv.conv_layers:
        x, affine = layer.forward_u8_chain(x, affine)
        assert x.dtype == torch.uint8
        shapes.append(tuple(x.shape))
    assert shapes == [(2, 48, 85, 48), (2, 16, 28, 48), (2, 5, 9, 48)]


def test_deferred_affine_identity():
    """``conv(q*a + b, W) == conv(q, W*diag(a)) + conv(b*1, W)`` in f32,
    including the zero-padding border (the JAX test's case and bound)."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, size=(2, 11, 13, 5)).astype(np.float32)
    a = rng.random(5, dtype=np.float32) + 0.1
    b = rng.standard_normal(5).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    dense = conv2d_same(T(q * a + b), T(w), T(bias))
    folded = conv2d_same(T(q), T(w * a[None, None, :, None]))
    ring = conv2d_same(T(b).reshape(1, 1, 1, 5).expand(1, 11, 13, 5), T(w),
                       T(bias))
    np.testing.assert_allclose((folded + ring).numpy(), dense.numpy(),
                               rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("h,w,cdt", [
    (11, 13, "float32"), (12, 9, "bfloat16_full"), (3, 5, "float32"),
    (2, 5, "float32"), (48, 85, "bfloat16_full")])
def test_const_conv_ring_strip_matches_full_canvas(h, w, cdt):
    """The 3-row strip is bit-exact against the full batch-1 canvas conv
    (the h < 3 case takes the canvas itself), and within one bf16 ulp of
    the JAX ring (f32 rounding where the output stays f32).  The JAX
    test's cases: its ``"float32"`` names a compute dtype, so the
    operands are rounded to bf16 there too."""
    rng = np.random.default_rng(7 + h)
    b = rng.standard_normal(5).astype(np.float32)
    k = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    full = conv2d_same(T(b).reshape(1, 1, 1, 5).expand(1, h, w, 5), T(k),
                       T(bias), compute_dtype=cdt)
    strip = layers.const_conv_ring(T(b), T(k), T(bias), h, w,
                                   compute_dtype=cdt)
    assert strip.shape == full.shape == (1, h, w, 7)
    assert torch.equal(strip, full)
    want = np.asarray(jax_layers.const_conv_ring(
        jnp.asarray(b), jnp.asarray(k), jnp.asarray(bias), h, w,
        compute_dtype=cdt), np.float32)
    full_bf16 = cdt == "bfloat16_full"
    np.testing.assert_allclose(strip.float().numpy(), want,
                               rtol=2.0 ** -7 if full_bf16 else 1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("h,w", [(144, 256), (72, 128), (143, 256)])
def test_precompute_rings_bitexact_vs_in_forward(h, w, fold):
    """Logits with the precomputed rings equal those with the rings
    computed in the forward, bit for bit, on the folded net (raw uint8)
    and the unfolded one (RGB in [0, 1]); 143 rows pool to 47 and 15, so
    a ring taken at the wrong height after floor pooling would show."""
    net, _ = load_default_net("cpu", "uint8_chain")
    x = np.random.default_rng(11).integers(0, 256, (3, h, w, 3),
                                           dtype=np.uint8)
    if fold:
        net, inp = _folded(net), T(x)
    else:
        inp = T(x.astype(np.float32) / 255.0)
    rings = precompute_rings(net, h, w)
    assert len(rings) == 3 and rings[0] is None
    assert rings[1].shape == (1, h // 3, w // 3, 48)
    assert rings[2].shape == (1, h // 9, w // 9, 48)
    assert torch.equal(net(inp, rings), net(inp))


def test_rings_belong_to_their_net():
    """Rings are uint8_chain's and their own net's: a dense rung has none,
    and rings of another net (even an unfolded copy) raise."""
    for precision in ("float32", "bfloat16_full", "uint8_pool"):
        assert precompute_rings(load_default_net("cpu", precision)[0],
                                144, 256) is None
    net, _ = load_default_net("cpu", "uint8_chain")
    other = _folded(net)
    x = torch.zeros((1, 144, 256, 3))
    with pytest.raises(ValueError, match="another net"):
        net(x, precompute_rings(other, 144, 256))
    with pytest.raises(ValueError, match="uint8_chain's"):
        load_default_net("cpu", "uint8_pool")[0](
            x, precompute_rings(net, 144, 256))


def test_unconverged_bn_stats_warn(caplog):
    """A quantized rung warns on conv BN statistics at their initial
    values (``cut_detection_tpu/models/assembly.py:65-89``); the prod
    checkpoint and the dense rungs do not."""
    fresh = GluedNet(load_default_net("cpu")[0].model_params).state_dict()
    prod = load_default_net("cpu")[0].state_dict()
    with caplog.at_level(logging.WARNING):
        assert warn_if_stats_unconverged(fresh, "uint8_chain")
        assert warn_if_stats_unconverged(fresh, "uint8_pool")
        assert not warn_if_stats_unconverged(fresh, "bfloat16_full")
        assert not warn_if_stats_unconverged(prod, "uint8_chain")
    assert sum("uninitialized" in r.message for r in caplog.records) == 2


STEP_OPTS = [{}, {"device_resize": (144, 256)},
             {"device_resize": (144, 256), "pallas_preprocess": True}]


@pytest.mark.parametrize("opts", STEP_OPTS,
                         ids=["default", "device_resize", "pallas"])
@pytest.mark.parametrize("precision", RUNGS)
def test_step_matches_jax(precision, opts):
    """The classify step on 4 seeded frames (144x256, or 360x640 resized
    by the step; K5 in interpret mode on the JAX side) against the JAX
    step of the same rung and options: equal classes, confidences within
    the logit bar.  Called twice, the step gives the same answer with
    the rings it cached at the first call."""
    shape = (4, 360, 640, 3) if opts else (4, 144, 256, 3)
    x = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    jnet, _ = jax_default(precision=precision)
    with pltpu.force_tpu_interpret_mode():
        jconf, jpred = (np.asarray(a) for a in jax_make_step(jnet, **opts)(
            jnet.bundle, x))
    net, _ = load_default_net("cpu", precision)
    step = make_classify_step(net, **opts)
    conf, pred = step(T(x))
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=LOGIT_TOL)
    conf2, pred2 = step(T(x))
    assert torch.equal(conf2, conf) and torch.equal(pred2, pred)
