"""The port's ``int8_mxu`` rung against the JAX package's, on the CPU.

The JAX package computes the rung in XLA (``ops/nn.py:73-106``,
``models/layers.py:171-175, 229-280``, ``models/frame_conv.py:57-80``,
``models/assembly.py:160-235``); the port runs the int8 blocks as the
``conv1_block_i8`` / ``conv_block_i8`` kernels on the card and as their
plain versions here.  Bars:

- the weight quantization and the int32 sums are exact: max diff 0;
- a block's int8 codes, from JAX's previous codes: all within 1 of
  JAX's, at most 0.1% off by 1 (the bar of ``test_torch_quantized.py``:
  the ring is a bf16 conv, and a summation order one ulp apart moves a
  code across a ``rint`` boundary);
- the rings within one bf16 ulp of JAX's (the same bf16 conv), and the
  precomputed rings bit-exact against the rings computed in the forward;
- the whole net's logits within 2e-2 of JAX's with the same classes,
  folded (raw uint8 into layer 1) and unfolded (dense layer 1), then the
  JAX package's own gate against float32
  (``tests/test_precision_modes.py:34-67``): within 0.7, same classes;
- the CLI's CSV byte for byte the reference's and the JAX CLI's, and the
  eval corpus at the JAX gates (``tests/test_eval_corpus.py``).

The kernel itself cannot run here; ``test_pool_first_epilogue_equals_plain``
holds its order of operations (pool ``z``, then ReLU and quantize once a
window) to the plain version's on the same sums.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu.models import layers as jax_layers
from cut_detection_tpu.models.assembly import _glued_apply
from cut_detection_tpu.models.assembly import fold_preprocess as jax_fold
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.models.assembly import (
    precompute_rings as jax_precompute_rings,
)
from cut_detection_tpu.ops import nn as jax_nn
from cut_detection_tpu.pipeline import classify_video as jax_classify
from cut_detection_tpu.pipeline import make_classify_step as jax_make_step
from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.cli.evaluate import evaluate
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    load_default_net,
    precompute_rings,
    warn_if_stats_unconverged,
)
from cut_detection_tpu_torch.models.layers import dequantize_u8
from cut_detection_tpu_torch.ops.kernels import conv_block_i8 as k8
from cut_detection_tpu_torch.ops.nn import (
    conv2d_same_i8_plain,
    max_pool,
    quantize_kernel_i8,
)
from cut_detection_tpu_torch.pipeline import classify_video, make_classify_step

T = torch.from_numpy
LOGIT_TOL = 2e-2
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CORPUS = os.path.join(os.path.dirname(__file__), "eval_corpus")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (16, 144, 256, 3),
                                             dtype=np.uint8)


def _folded(net: GluedNet) -> GluedNet:
    out = GluedNet(net.model_params, net.precision)
    out.load_state_dict(fold_preprocess(net.state_dict()))
    return out


def _assert_codes(got, want):
    """int8 codes: all within 1, at most 0.1% of them off by 1."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()


@pytest.mark.parametrize("case", ["random", "layer1", "layer2", "layer3"])
def test_quantize_kernel_i8_matches_jax(case):
    """Bit for bit: a seeded kernel with a dead output channel (as
    ``test_quantize_kernel_i8_roundtrip``), and each prod layer's kernel
    as the rung quantizes it (layer 1 folded, the others with the
    previous block's pending scale folded in)."""
    if case == "random":
        k = np.random.default_rng(5).standard_normal(
            (3, 3, 8, 16)).astype(np.float32)
        k[..., 0] = 0.0
    else:
        jnet, _ = jax_default(precision="int8_mxu")
        bundle = jax_fold(jnet.bundle)
        i = int(case[-1]) - 1
        k = np.array(bundle["conv"]["params"][i]["kernel"], np.float32)
        if i:
            a, _ = jax_layers.i8_pending_affine(
                bundle["conv"]["params"][i - 1],
                bundle["conv"]["state"][i - 1])
            k = k * np.asarray(a)[None, None, :, None]
    want_k, want_s = jax_nn.quantize_kernel_i8(jnp.asarray(k))
    got_k, got_s = quantize_kernel_i8(T(k))
    assert got_k.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "random":  # the dead channel: scale 1e-12, codes 0
        assert got_s[0] == torch.tensor(1e-12)
        assert (got_k[..., 0] == 0).all()


@pytest.mark.parametrize("source", ["int8", "shifted_uint8"])
@pytest.mark.parametrize("shape", [(3, 9, 11, 48, 48), (2, 144, 256, 3, 48),
                                   (2, 4, 5, 4, 8)])
def test_conv2d_same_i8_plain_matches_jax(source, shape):
    """The int32 sums equal ``conv2d_same_i8``'s with a max diff of 0, on
    int8 input and on uint8 frames shifted by -128 (layer 1's input),
    including the extreme codes -128 and 127."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(h + cin)
    if source == "int8":
        x = rng.integers(-128, 128, (b, h, w, cin), dtype=np.int8)
        x[0, 0, 0, :] = -128
        x[0, -1, -1, :] = 127
    else:
        u8 = rng.integers(0, 256, (b, h, w, cin), dtype=np.uint8)
        x = (u8.astype(np.int32) - 128).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    k[..., 0] = 127
    want = np.asarray(jax_nn.conv2d_same_i8(jnp.asarray(x), jnp.asarray(k)))
    got = conv2d_same_i8_plain(T(x), T(k))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_first_epilogue_equals_plain():
    """The kernel's epilogue order (the max of ``z = zi * so + ring`` over
    each window, then ReLU and one quantization) gives the plain version's
    codes (every conv pixel quantized, then pooled) exactly, on sums and
    rings that put windows below zero and above the top code."""
    rng = np.random.default_rng(9)
    b, h, w, c = 4, 13, 17, 8
    x = T(rng.integers(-128, 128, (b, h, w, 12), dtype=np.int8))
    k = T(rng.integers(-127, 128, (3, 3, 12, c), dtype=np.int8))
    so = T(rng.uniform(1e-4, 3e-3, c).astype(np.float32))
    strip = T(rng.normal(0, 2, (3, w, c)).astype(np.float32))
    scale = T(rng.uniform(0.01, 0.05, c).astype(np.float32))
    want = k8.conv_block_i8(x, k, so, strip, scale)  # plain on the CPU
    zi = conv2d_same_i8_plain(x, k)
    z = zi.float() * so + k8.ring_canvas(strip, h)
    m = max_pool(z, 3)
    q = torch.clamp(torch.round(torch.relu(m) / scale) - 128.0, -128.0,
                    127.0).to(torch.int8)
    assert want.shape == (b, h // 3, (w - 3) // 3 + 1, c)
    assert torch.equal(q, want)
    assert (want == -128).any() and (want == 127).any()
    assert ((want > -128) & (want < 127)).any()


def test_ring_canvas_and_strip():
    """``ring_canvas`` expands a strip into the canvas ``const_conv_ring``
    builds, and the block's own strip is that canvas's rows 0, 1, H-1."""
    from cut_detection_tpu_torch.models.layers import const_conv_ring

    rng = np.random.default_rng(4)
    b = T(rng.standard_normal(5).astype(np.float32))
    k = T(rng.standard_normal((3, 3, 5, 8)).astype(np.float32))
    bias = T(rng.standard_normal(8).astype(np.float32))
    full = const_conv_ring(b, k, bias, 11, 13)
    strip = const_conv_ring(b, k, bias, 3, 13)[0].float()
    assert torch.equal(strip, full[0, [0, 1, 10]].float())
    assert torch.equal(k8.ring_canvas(strip, 11), full.float())


def test_int8_blocks_match_jax(frames):
    """Per block of the chain, from JAX's previous codes (raw uint8 into
    the folded layer 1): the codes as above and the pending affine within
    f32 rounding; the last codes dequantized to bf16 as JAX does."""
    jnet, _ = jax_default(precision="int8_mxu")
    bundle = jax_fold(jnet.bundle)
    net = _folded(load_default_net("cpu", "int8_mxu")[0])
    x, jaffine, affine = frames[:8], None, None
    for layer, p, s in zip(net.conv.conv_layers, bundle["conv"]["params"],
                           bundle["conv"]["state"]):
        want_q, jaffine = jax_layers.apply_conv_block_i8(
            p, s, jnp.asarray(x), jaffine)
        got_q, affine = layer.forward_i8_chain(T(np.asarray(x)), affine)
        _assert_codes(got_q.numpy(), want_q)
        for g, w in zip(affine, jaffine):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-5)
        x = np.array(want_q)
    got = dequantize_u8(T(x), affine)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jax_layers.dequantize_u8(jnp.asarray(x), jaffine),
                   np.float32), rtol=2.0 ** -7, atol=1e-5)


def test_int8_dense_layer1_matches_jax(frames):
    """The unfolded layer 1 (RGB in [0, 1], the fused preprocess's
    output) runs ``uint8_chain``'s bf16 conv into int8 codes, as JAX's
    ``affine=None`` float branch does."""
    jnet, _ = jax_default(precision="int8_mxu")
    net, _ = load_default_net("cpu", "int8_mxu")
    x = frames[:4].astype(np.float32) / 255.0
    p, s = jnet.bundle["conv"]["params"][0], jnet.bundle["conv"]["state"][0]
    want, _ = jax_layers.apply_conv_block_i8(p, s, jnp.asarray(x), None)
    got, _ = net.conv.conv_layers[0].forward_i8_chain(T(x))
    _assert_codes(got.numpy(), want)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("h,w", [(144, 256), (72, 128)])
def test_int8_rings_match_jax(h, w, fold):
    """``precompute_rings`` against JAX's at ``int8_mxu``: layer 1 has a
    ring exactly when it reads raw pixels (folded: ``b = 128`` and the
    f32 kernel, ``test_precision_modes.py:177-190``), and every ring's
    canvas is within one bf16 ulp of JAX's (the same bf16 conv); then
    the logits with them equal the logits with the rings computed in
    the forward, bit for bit."""
    jnet, _ = jax_default(precision="int8_mxu")
    want = jax_precompute_rings(jnet.bundle, jnet.conv_cfg, h, w,
                                "int8_mxu", fold=fold)
    base, _ = load_default_net("cpu", "int8_mxu")
    net = _folded(base) if fold else base
    got = precompute_rings(net, h, w, fold=fold)
    assert len(got) == len(want) == 3 and got.source is net.conv
    assert (got[0] is not None) == fold == (want[0] is not None)
    hh, ww = h, w
    for g, wr in zip(got, want):
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == (3, ww, 48)
            canvas = k8.ring_canvas(g, hh)[0].numpy()
            np.testing.assert_allclose(canvas, np.asarray(wr, np.float32)[0],
                                       rtol=2.0 ** -7, atol=1e-6)
        hh, ww = hh // 3, ww // 3
    x = np.random.default_rng(11).integers(0, 256, (3, h, w, 3),
                                           dtype=np.uint8)
    inp = T(x) if fold else T(x.astype(np.float32) / 255.0)
    assert torch.equal(net(inp, got), net(inp))


def test_int8_rings_belong_to_their_net():
    """An ``int8_mxu`` net refuses another net's rings, as the chain rung
    does."""
    net, _ = load_default_net("cpu", "int8_mxu")
    other = _folded(net)
    with pytest.raises(ValueError, match="another net"):
        net(torch.zeros((1, 144, 256, 3)),
            precompute_rings(other, 144, 256))


def test_int8_interlayer_tensors_are_int8():
    """The chain's inter-block activations are int8 at their pooled shapes
    (``test_int8_mxu_interlayer_tensor_is_int8``)."""
    net = _folded(load_default_net("cpu", "int8_mxu")[0])
    x, affine = torch.zeros((2, 144, 256, 3), dtype=torch.uint8), None
    shapes = []
    for layer in net.conv.conv_layers:
        x, affine = layer.forward_i8_chain(x, affine)
        assert x.dtype == torch.int8
        shapes.append(tuple(x.shape))
    assert shapes == [(2, 48, 85, 48), (2, 16, 28, 48), (2, 5, 9, 48)]


def _jax_logits(jnet, x, *, fold):
    bundle = jax_fold(jnet.bundle) if fold else jnet.bundle
    x = jnp.asarray(x) if fold else jnp.asarray(x, jnp.float32)
    return np.asarray(_glued_apply(
        bundle, x, conv_cfg=jnet.conv_cfg, linear_cfg=jnet.linear_cfg,
        compute_dtype=jnet.compute_dtype))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_int8_logits_match_jax(frames, fold):
    jnet, _ = jax_default(precision="int8_mxu")
    net, _ = load_default_net("cpu", "int8_mxu")
    if fold:
        got, x = _folded(net)(T(frames)), frames
    else:
        x = frames.astype(np.float32) / 255.0
        got = net(T(x))
    want = _jax_logits(jnet, x, fold=fold)
    got = got.numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    ref = load_default_net("cpu", "float32")[0]
    ref = (_folded(ref)(T(frames)) if fold
           else ref(T(frames.astype(np.float32) / 255.0))).numpy()
    assert np.abs(got - ref).max() < 0.7
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


STEP_OPTS = [{}, {"device_resize": (144, 256)},
             {"device_resize": (144, 256), "pallas_preprocess": True}]


@pytest.mark.parametrize("opts", STEP_OPTS,
                         ids=["default", "device_resize", "pallas"])
def test_int8_step_matches_jax(opts):
    """The classify step at ``int8_mxu`` on 4 seeded frames (144x256, or
    360x640 resized by the step; K5 in interpret mode on the JAX side)
    against the JAX step: equal classes, confidences within the logit
    bar; called again (with its cached rings and frozen int8 weights) it
    gives the same answer."""
    shape = (4, 360, 640, 3) if opts else (4, 144, 256, 3)
    x = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    jnet, _ = jax_default(precision="int8_mxu")
    with pltpu.force_tpu_interpret_mode():
        jconf, jpred = (np.asarray(a) for a in jax_make_step(jnet, **opts)(
            jnet.bundle, x))
    net, _ = load_default_net("cpu", "int8_mxu")
    step = make_classify_step(net, **opts)
    conf, pred = step(T(x))
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=LOGIT_TOL)
    conf2, pred2 = step(T(x))
    assert torch.equal(conf2, conf) and torch.equal(pred2, pred)


def test_frozen_block_keeps_its_int8_weights():
    """A frozen block quantizes its weights once per input branch (raw
    pixels, or the previous block's codes) and takes its pending affine
    once; an unfrozen one every call; ``freeze`` starts over."""
    net = _folded(load_default_net("cpu", "int8_mxu")[0])
    layer = net.conv.conv_layers[0]
    x = torch.zeros((1, 9, 9, 3), dtype=torch.uint8)
    layer.forward_i8_chain(x)
    assert layer._i8_frozen == {}
    layer.freeze()
    q, _ = layer.forward_i8_chain(x)
    assert set(layer._i8_frozen) == {"pixels", "affine"}
    cached = layer._i8_frozen["pixels"]
    assert torch.equal(layer.forward_i8_chain(x)[0], q)
    assert layer._i8_frozen["pixels"] is cached
    layer.freeze()
    assert layer._i8_frozen == {}


def test_unconverged_bn_stats_warn_at_int8(caplog):
    """``warn_if_stats_unconverged`` covers ``int8_mxu``
    (``cut_detection_tpu/models/assembly.py:52``)."""
    fresh = GluedNet(load_default_net("cpu")[0].model_params).state_dict()
    with caplog.at_level(logging.WARNING):
        assert warn_if_stats_unconverged(fresh, "int8_mxu")
    assert any("int8_mxu" in r.message for r in caplog.records)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_int8_matches_golden_and_jax_csv(tmp_path, clip, ref):
    """``--cpu --precision int8_mxu`` writes the reference CSV byte for
    byte (``tests/test_golden.py:22-35`` pins the JAX rung on
    ``clip.mp4``), and the JAX CLI's at the same rung."""
    out, theirs = str(tmp_path / "out.csv"), str(tmp_path / "jax.csv")
    cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "bgr",
              "--precision", "int8_mxu", "--output_path", out,
              "--print-every", "0"])
    jax_segment(os.path.join(GOLDEN, clip), theirs, print_every=0,
                precision="int8_mxu", transfer="bgr")
    assert _read(out) == _read(theirs) == _read(os.path.join(GOLDEN, ref))


@pytest.mark.parametrize("name,n,frame_min", [
    ("corpus_a", 590, 0.99), ("corpus_adv", 593, 0.96),
    ("corpus_nat", 590, 1.0)])
def test_int8_holds_the_corpus_gates(tmp_path, name, n, frame_min):
    """The JAX package's gates at ``int8_mxu``
    (``tests/test_eval_corpus.py:61-66, 132-142, 147-165``): frame
    accuracy >= 0.99 on ``corpus_a``, >= 0.96 on ``corpus_adv``, every
    frame on ``corpus_nat``; boundary precision and recall >= 0.90."""
    out = str(tmp_path / "out.csv")
    cli.main([os.path.join(CORPUS, f"{name}.mp4"), "--cpu", "--transfer",
              "bgr", "--precision", "int8_mxu", "--output_path", out,
              "--print-every", "0"])
    res = evaluate(out, os.path.join(CORPUS, f"{name}_truth.csv"), n,
                   tolerance=30)
    assert res["frame_accuracy"] >= frame_min, res
    assert res["boundary_precision"] >= 0.90, res
    assert res["boundary_recall"] >= 0.90, res


def test_adversarial_clip_probes_int8_weight_quantization():
    """``tests/test_eval_corpus.py:101-117`` on the port: before
    smoothing, ``int8_mxu``'s classes differ from float32's on at least
    one frame of ``corpus_adv``, and only inside its two designed
    near-boundary blocks; the frames that differ are the JAX rung's."""
    clip = os.path.join(CORPUS, "corpus_adv.mp4")
    cpu = torch.device("cpu")
    _, p32, _ = classify_video(clip, device=cpu, print_every=0,
                               transfer="bgr", precision="float32")
    _, pi8, _ = classify_video(clip, device=cpu, print_every=0,
                               transfer="bgr", precision="int8_mxu")
    diff = np.nonzero(p32 != pi8)[0]
    assert diff.size >= 1, "corpus_adv no longer probes int8_mxu"
    for f in diff:
        assert any(lo <= f < hi for lo, hi in [(150, 159), (319, 328)]), f
    _, jp32, _ = jax_classify(clip, print_every=0, precision="float32",
                              transfer="bgr")
    _, jpi8, _ = jax_classify(clip, print_every=0, precision="int8_mxu",
                              transfer="bgr")
    np.testing.assert_array_equal(diff, np.nonzero(jp32 != jpi8)[0])
