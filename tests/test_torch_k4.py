"""K4, ``fused_conv_block``, on the CPU: the port's plain version against
the Pallas kernel in interpret mode, and the prod layers 2 + 3 through it.

The port's wrapper takes a CPU tensor to its plain version (the CUDA
instances ``conv_block[cm_bf16]`` and ``[cm_f32]`` are held to it on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Tolerances
are the JAX test's own (``tests/test_fused_conv_block.py:58-64``): the
two sum the 9*C_in taps in different orders, so a post-ReLU activation
near a bf16 rounding boundary may land one bf16 ulp away (2^-8
relative): atol 1e-3 / rtol 1e-2 on every element, and more than 99.9%
of them within 3e-4 / 3e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut_detection_tpu.models.assembly import _glued_apply
from cut_detection_tpu.models.assembly import fold_preprocess as jax_fold
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.ops.pallas.fused_conv_block import (
    fused_conv_block as jax_k4,
)
from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    load_default_net,
)
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    CM_INSTANCES,
    conv_block,
    fused_conv_block,
)
from cut_detection_tpu_torch.ops.nn import (
    adaptive_avg_pool,
    flatten_nchw_order,
)

T = torch.from_numpy

# The JAX test's shapes (tests/test_fused_conv_block.py:41-46).
SHAPES = [
    (2, 48, 85, 48, 48),   # prod layer 2
    (2, 16, 28, 48, 48),   # prod layer 3 (H % 3 != 0: floor pooling)
    (1, 36, 40, 8, 16),    # rectangular channel counts
    (1, 10, 9, 8, 8),      # tiny, H % 3 == 1
]
DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]


def _inputs(b, h, w, cin, cout):
    rng = np.random.default_rng(b * 1000003 + h * 1009 + w * 101 + cin)
    x = rng.normal(0, 1, size=(b, h, w, cin)).astype(np.float32)
    params = (
        rng.normal(0, 0.1, size=(3, 3, cin, cout)).astype(np.float32),
        rng.normal(0, 0.1, cout).astype(np.float32),
        rng.normal(1, 0.1, cout).astype(np.float32),
        rng.normal(0, 0.1, cout).astype(np.float32),
        rng.normal(0, 0.5, cout).astype(np.float32),
        rng.uniform(0.5, 2, cout).astype(np.float32),
    )
    return x, params


@pytest.mark.parametrize("nhwc_out", [True, False])
@pytest.mark.parametrize("channel_major_in", [False, True])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_k4_plain_matches_pallas_interpret(b, h, w, cin, cout, dtypes,
                                           channel_major_in, nhwc_out):
    jdtype, tdtype = dtypes
    x, params = _inputs(b, h, w, cin, cout)
    if channel_major_in:
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want = np.asarray(jax_k4(
        jnp.asarray(x), *(jnp.asarray(p) for p in params), out_dtype=jdtype,
        nhwc_out=nhwc_out, channel_major_in=channel_major_in,
        interpret=True), dtype=np.float32)
    got = fused_conv_block(T(x), *(T(p) for p in params), out_dtype=tdtype,
                           nhwc_out=nhwc_out,
                           channel_major_in=channel_major_in)
    assert got.dtype == tdtype
    hp, wp = h // 3, (w - 3) // 3 + 1
    assert tuple(got.shape) == ((b, hp, wp, cout) if nhwc_out
                                else (b, cout, hp, wp)) == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-2)
    assert np.isclose(got, want, atol=3e-4, rtol=3e-3).mean() > 0.999


def test_k4_instances_and_refusals():
    """Each out dtype has its channel-major instance, counted under the
    mid-stack block's launches; what K4 does not take raises before any
    kernel is reached."""
    assert CM_INSTANCES == {torch.bfloat16: "cm_bf16",
                            torch.float32: "cm_f32"}
    assert {"cm_bf16", "cm_f32"} <= set(conv_block.instance_launches)
    x, params = _inputs(1, 10, 9, 8, 8)
    args = [T(p) for p in params]
    with pytest.raises(ValueError, match="out_dtype"):
        fused_conv_block(T(x), *args, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="C_in"):
        fused_conv_block(T(x), *args, channel_major_in=True)
    small = np.zeros((1, 10, 9, 3), np.float32)
    with pytest.raises(ValueError, match="C_in >= 8"):
        fused_conv_block(T(small), T(params[0][:, :, :3]), *args[1:])


def test_k4_prod_layers23_chain_matches_jax():
    """The prod net's layers 2 and 3 through K4's plain version (the
    16-row layer-3 input takes floor pooling), after the shipped
    ``bfloat16_full`` layer 1, feed the head to the JAX graph's classes,
    logits within 0.05 (``tests/test_fused_conv_block.py:67-105``)."""
    jnet, _ = jax_default(precision="bfloat16_full")
    x = np.random.default_rng(5).integers(0, 256, size=(4, 144, 256, 3),
                                          dtype=np.uint8)
    want = np.asarray(_glued_apply(
        jax_fold(jnet.bundle), jnp.asarray(x, jnp.float32),
        conv_cfg=jnet.conv_cfg, linear_cfg=jnet.linear_cfg,
        compute_dtype="bfloat16_full"))

    base, _ = load_default_net("cpu", "bfloat16_full")
    net = GluedNet(base.model_params, "bfloat16_full")
    net.load_state_dict(fold_preprocess(base.state_dict()))
    layers = net.conv.conv_layers
    acts = layers[0](T(x))
    for layer in layers[1:]:
        bn = layer.bn
        acts = fused_conv_block(acts, layer.hwio(), layer.conv.bias,
                                bn.weight, bn.bias, bn.running_mean,
                                bn.running_var)
    got = net.linear(flatten_nchw_order(adaptive_avg_pool(
        acts.float(), net.conv.cfg.average_pool_size))).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert np.abs(got - want).max() < 0.05
