"""The port's classifier against JAX ``GluedNet`` (float32), on the CPU.

Same weights (``params_from_jax``) and the same seeded numpy frames go
through both.  Bar: logits within 1e-4 and no argmax flips, with the
preprocess unfolded (float RGB frames) and folded into layer 1 (raw
uint8 BGR frames).
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.checkpoint.convert import export_torch_state_dicts
from cut_detection_tpu.checkpoint.io import save_bundle
from cut_detection_tpu.config import ModelParams
from cut_detection_tpu.models.assembly import (
    GluedNet as JaxGluedNet,
    _glued_apply,
    fold_preprocess as jax_fold,
    folded_input as jax_folded_input,
    load_default_net as jax_default,
)
from cut_detection_tpu.ops.preprocess import normalize_frames
from cut_detection_tpu.pipeline import make_classify_step as jax_step
from cut_detection_tpu_torch.checkpoint.convert import params_from_jax
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    folded_input,
    load_default_net,
    load_triplet_or_default,
)
from cut_detection_tpu_torch.pipeline import make_classify_step

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 1e-4


def _small_params() -> ModelParams:
    return ModelParams(conv_layers=2, conv_channels=8, avg_pool_size=2,
                       linear_layers=2, linear_size=16, linear_output_size=3)


def _small_bundle(mp: ModelParams, seed: int = 0):
    """Random weights and BN statistics, as numpy, in the bundle layout."""
    rng = np.random.default_rng(seed)

    def f32(*shape, loc=0.0, scale=0.2):
        return rng.normal(loc, scale, shape).astype(np.float32)

    def bn(c):
        return ({"gamma": f32(c, loc=1.0), "beta": f32(c)},
                {"mean": f32(c, scale=0.3),
                 "var": rng.uniform(0.2, 2, c).astype(np.float32)})

    conv_p, conv_s = [], []
    cin = mp.conv_config().input_channels
    for _ in range(mp.conv_layers):
        g, s = bn(mp.conv_channels)
        conv_p.append({"kernel": f32(3, 3, cin, mp.conv_channels),
                       "bias": f32(mp.conv_channels), **g})
        conv_s.append(s)
        cin = mp.conv_channels
    lin_p, lin_s = [], []
    sizes = mp.linear_config().layer_sizes()
    for k, (i, o) in enumerate(sizes):
        p, s = {"kernel": f32(i, o), "bias": f32(o)}, {}
        if k != len(sizes) - 1:
            g, s = bn(o)
            p.update(g)
        lin_p.append(p)
        lin_s.append(s)
    return {"conv": {"params": conv_p, "state": conv_s},
            "linear": {"params": lin_p, "state": lin_s}}


@pytest.fixture(scope="module")
def prod():
    jnet, _ = jax_default()
    tnet, _ = load_default_net("cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def small():
    mp = _small_params()
    bundle = _small_bundle(mp)
    jnet = JaxGluedNet(bundle, mp)
    tnet = GluedNet(mp)
    tnet.load_state_dict(params_from_jax(bundle))
    return jnet, tnet


def _frames(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _assert_logits(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _jax_folded_logits(jnet, x_u8):
    return _glued_apply(jax_fold(jnet.bundle), jax_folded_input(x_u8, None),
                        conv_cfg=jnet.conv_cfg, linear_cfg=jnet.linear_cfg)


def _port_folded(tnet) -> GluedNet:
    net = GluedNet(tnet.model_params)
    net.load_state_dict(fold_preprocess(tnet.state_dict()))
    return net


@pytest.mark.parametrize("which,shape", [("prod", (8, 144, 256)),
                                         ("small", (4, 36, 64))])
def test_logits_unfolded(request, which, shape):
    jnet, tnet = request.getfixturevalue(which)
    x = np.array(normalize_frames(jnp.asarray(_frames(*shape))))
    _assert_logits(tnet(torch.from_numpy(x)), jnet(x))


@pytest.mark.parametrize("which,shape", [("prod", (8, 144, 256)),
                                         ("small", (4, 36, 64)),
                                         ("prod", (2, 143, 256))])
def test_logits_folded(request, which, shape):
    jnet, tnet = request.getfixturevalue(which)
    x = _frames(*shape, seed=1)
    got = _port_folded(tnet)(folded_input(torch.from_numpy(x)))
    _assert_logits(got, _jax_folded_logits(jnet, jnp.asarray(x)))


def test_classify_step_matches_jax(prod):
    jnet, tnet = prod
    x = _frames(8, 144, 256, seed=2)
    jconf, jpred = jax_step(jnet)(jnet.bundle, jnp.asarray(x))
    conf, pred = make_classify_step(tnet)(torch.from_numpy(x))
    assert pred.dtype == torch.int32 and conf.dtype == torch.float32
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0,
                               atol=ATOL)
    assert make_classify_step(tnet) is make_classify_step(tnet)


def test_frozen_kernel_args_match(small):
    """``ConvBlock.freeze`` stores the kernel arguments it would compute,
    and the net's output does not change."""
    _, tnet = small
    net = _port_folded(tnet)
    x = folded_input(torch.from_numpy(_frames(2, 36, 64, seed=4)))
    want = net(x)
    layers = list(net.conv.conv_layers)
    fresh = [layer.kernel_args() for layer in layers]
    for layer in layers:
        layer.freeze()
    for layer, args in zip(layers, fresh):
        assert layer.kernel_args() is layer.kernel_args()
        for got, ref in zip(layer.kernel_args(), args):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(net(x), want, rtol=0, atol=0)


def test_golden_logits(prod):
    from cut_detection_tpu.data.video import VideoFrameSource

    _, tnet = prod
    frames = np.stack(list(itertools.islice(
        VideoFrameSource(os.path.join(GOLDEN, "clip.mp4"), resize=256), 32)))
    ref = np.load(os.path.join(GOLDEN, "ref_logits_first32.npy"))
    x = np.array(normalize_frames(jnp.asarray(frames)))
    _assert_logits(tnet(torch.from_numpy(x)), ref)
    _assert_logits(_port_folded(tnet)(torch.from_numpy(frames)), ref)


def test_params_from_jax_matches_reference_layout(prod):
    """The converted state dict is the reference's torch layout under the
    ``conv.`` / ``linear.`` prefixes of ``GluedNet``."""
    jnet, tnet = prod
    bundle = jax.device_get(jnet.bundle)
    conv_sd, linear_sd = export_torch_state_dicts(bundle)
    want = {**{"conv." + k: v for k, v in conv_sd.items()},
            **{"linear." + k: v for k, v in linear_sd.items()}}
    got = params_from_jax(bundle)
    assert got.keys() == want.keys() == tnet.state_dict().keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert tnet.num_params() == jnet.num_params() == 67_971


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_triplet(tmp_path, prod, fmt):
    jnet, tnet = prod
    bundle = jax.device_get(jnet.bundle)
    jnet.model_params.to_json(str(tmp_path / "m_model_params.json"))
    if fmt == "npz":
        save_bundle(str(tmp_path / "m_classifier_conv.npz"), bundle["conv"])
        save_bundle(str(tmp_path / "m_classifier_linear.npz"),
                    bundle["linear"])
    else:
        conv_sd, linear_sd = export_torch_state_dicts(bundle)
        torch.save(conv_sd, tmp_path / "m_classifier_conv.pt")
        torch.save(linear_sd, tmp_path / "m_classifier_linear.pt")
    net, params = load_triplet_or_default(str(tmp_path), "m", "cpu")
    assert params == jnet.model_params.to_dict()
    x = torch.from_numpy(_frames(2, 36, 64, seed=3)).float() / 255.0
    torch.testing.assert_close(net(x), tnet(x), rtol=0, atol=0)
