"""The port's CUDA kernels and its main path on the card.

Every test here needs a CUDA device and skips without one.  The module
imports no jax, so it runs on a machine that has none; there, skip the
repository's ``conftest.py`` (which imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: 1e-4 for f32 block kernels and the ``bf16_operands``
instance against their plain versions (f32 summation order only, on the
same bf16-rounded operands); for the instances that round activations to
bf16 (K1, K3's ``bf16_out``, K4's ``cm_bf16`` and ``cm_f32``),
``tolerance.bf16_check`` (``xla_check``, the same rule for XLA's
roundings, for the ``bf16_xla`` instances of both kernels):
one bf16 ulp of the pooled activation, since summation order may move a
value across a bf16 rounding boundary, plus one ulp of a bf16 output's
own rounding, and such crossings on at most 0.1% of the elements; 1e-5
for the resize + normalize kernel on outputs in [0, 1] (two-tap sums
against the plain version's dense matmuls); 0 for the YUV -> BGR kernel
(integer arithmetic) and for the yuv420 step against the step on the
same planes converted on the host.  The slice at the bf16 rungs:
identical classes, conf within 2e-2 — such crossings, where a bf16
activation or a bf16-rounded layer input lands one ulp apart, move logits
by a few 1e-3 (6.3e-3 at most on ``chip_smoke.py``'s slice stream).
The slice at the quantized rungs: identical classes, conf within
``QUANT_CONF_TOL`` of ``chip_smoke.py`` (cuDNN's summation order against
the CPU's moves a few uint8 codes by one), and no kernel launched on the
default path at ``uint8_pool`` and ``uint8_chain``, which are plain
PyTorch; at ``int8_mxu`` the int8 block kernels, whose codes equal their
plain versions' with a max diff of 0 (exact int32 sums, the same IEEE
roundings), and nothing else.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cut_detection_tpu_torch.models.assembly import (
    fold_preprocess,
    load_default_net,
)
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
    fused_conv_block,
    fused_conv_block_plain,
)
from cut_detection_tpu_torch.ops.kernels.conv_block_i8 import (
    conv1_block_i8,
    conv1_block_i8_plain,
    conv_block_i8,
    conv_block_i8_plain,
)
from cut_detection_tpu_torch.ops.kernels.resize_normalize import (
    resize_normalize,
    resize_normalize_plain,
)
from cut_detection_tpu_torch.ops.nn import bn_scale_offset
from cut_detection_tpu_torch.ops.kernels.tolerance import (
    bf16_check,
    xla_check,
)
from cut_detection_tpu_torch.ops.kernels.yuv420_to_bgr import (
    yuv420_to_bgr,
    yuv420_to_bgr_plain,
)
from cut_detection_tpu_torch.ops.resize import resize_bilinear
from cut_detection_tpu_torch.ops.yuv import yuv420_to_bgr_np
from cut_detection_tpu_torch.geometry import yuv420_nbytes
from cut_detection_tpu_torch.pipeline import (
    batch_frames,
    classify_batches,
    make_classify_step,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
T = torch.from_numpy
QUANT_CONF_TOL = 2e-2  # chip_smoke.QUANT_CONF_TOL
BENCH_XLA_TOL = 5e-2  # chip_smoke.BENCH_XLA_TOL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cut_detection_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _layer1_args(dev, precision="float32", rsqrt=True):
    """The prod net's folded layer-1 kernel arguments at ``precision``,
    with the BN's ``gamma * rsqrt`` or (``rsqrt=False``) K1's ``gamma /
    sqrt``."""
    net, _ = load_default_net(dev, precision)
    layer = net.conv.conv_layers[0]
    bias = layer.conv.bias
    scale, offset = bn_scale_offset(layer.bn.running_mean,
                                    layer.bn.running_var, layer.bn.weight,
                                    layer.bn.bias, rsqrt=rsqrt)
    kernel = (fold_preprocess(net.state_dict())
              ["conv.conv_layers.0.conv.weight"].permute(2, 3, 1, 0)
              .contiguous())
    if precision == "bfloat16_full":
        kernel = kernel.to(torch.bfloat16)
    return kernel, bias, scale, offset


def _block_args(rng, dev, cin=48, cout=48):
    k = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = rng.normal(0, 0.1, cout).astype(np.float32)
    return [T(a).to(dev) for a in (k, bias, scale, offset)]


def _assert_within_bf16_crossing(got, want, offset, xla=None):
    """``tolerance.bf16_check``: one bf16 ulp of the pooled activation m
    (y = m*s + t), plus one ulp of y where the output is bf16, on every
    element, and more than 1e-5 apart on at most 0.1% of them; with
    ``xla`` = (scale, bias), ``tolerance.xla_check``."""
    ok, worst, crossings = (bf16_check(got, want, offset) if xla is None
                            else xla_check(got, want, offset, *xla))
    assert ok, (f"worst err / one-ulp bound {worst}, {crossings} of "
                f"{got.numel()} elements crossed")


def _i8_layers(dev, h=144, w=256):
    """The prod net's folded ``int8_mxu`` chain at an input of ``h`` x
    ``w``: per layer (int8 kernel, its scale, ring strip, activation
    scale), as the classify step hands them to the kernels."""
    from cut_detection_tpu_torch.models.assembly import (
        GluedNet,
        precompute_rings,
    )

    base, _ = load_default_net(dev, "int8_mxu")
    net = GluedNet(base.model_params, "int8_mxu")
    net.load_state_dict(fold_preprocess(base.state_dict()))
    net.to(dev)
    rings = precompute_rings(net, h, w)
    out, affine = [], None
    for layer, ring in zip(net.conv.conv_layers, rings):
        k, so, scale = layer.i8_args(affine)
        out.append((k, so, ring, scale))
        affine = layer.i8_pending_affine()
    return out


@pytest.mark.parametrize("h,w", [(144, 256), (143, 256), (3, 3), (7, 10)])
def test_conv1_block_i8_kernel(cuda_dev, h, w):
    """Layer 1 of ``int8_mxu`` from raw pixels: the kernel's codes equal
    the plain version's (max diff 0), with the prod net's folded weights
    and ring."""
    k, so, ring, scale = _i8_layers(cuda_dev, h, w)[0]
    x = T(np.random.default_rng(h + w).integers(
        0, 256, (16, h, w, 3), dtype=np.uint8)).to(cuda_dev)
    n = conv1_block_i8.launches
    got = conv1_block_i8(x, k, so, ring, scale)
    want = conv1_block_i8_plain(x, k, so, ring, scale)
    assert conv1_block_i8.launches == n + 1
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("layer,h,w", [(1, 48, 85), (2, 16, 28), (1, 47, 85),
                                       (2, 5, 9), (1, 3, 3)])
def test_conv_block_i8_kernel(cuda_dev, layer, h, w):
    """A mid-stack ``int8_mxu`` block on seeded int8 codes with the prod
    net's weights and rings (taken at the input size that gives ``h`` x
    ``w`` at this layer): codes equal to the plain version's."""
    k, so, ring, scale = _i8_layers(cuda_dev, h * 3 ** layer,
                                    w * 3 ** layer)[layer]
    assert ring.shape == (3, w, 48)
    x = T(np.random.default_rng(h).integers(-128, 128, (16, h, w, 48),
                                            dtype=np.int8)).to(cuda_dev)
    n = conv_block_i8.launches
    got = conv_block_i8(x, k, so, ring, scale)
    assert conv_block_i8.launches == n + 1
    assert torch.equal(got, conv_block_i8_plain(x, k, so, ring, scale))


@pytest.mark.parametrize("cin,cout", [(4, 8), (8, 16), (12, 48), (64, 64),
                                      (4, 4), (48, 12), (16, 20)])
def test_conv_block_i8_kernel_widths(cuda_dev, cin, cout):
    """Other widths (Cin % 4 == 0, Cout % 4 == 0), with random weights,
    scales and rings that drive codes to both ends."""
    rng = np.random.default_rng(cin + cout)
    h, w = 20, 31
    x = T(rng.integers(-128, 128, (5, h, w, cin), dtype=np.int8))
    k = T(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    so = T(rng.uniform(1e-4, 2e-3, cout).astype(np.float32))
    ring = T(rng.normal(0, 1, (3, w, cout)).astype(np.float32))
    scale = T(rng.uniform(0.005, 0.05, cout).astype(np.float32))
    args = [t.to(cuda_dev) for t in (x, k, so, ring, scale)]
    got = conv_block_i8(*args)
    assert torch.equal(got, conv_block_i8_plain(*args))
    assert torch.equal(got.cpu(), conv_block_i8(x, k, so, ring, scale))


def _i8_random_args(rng, x, cout, uniform=False):
    """Seeded int8 weights and a weight scale, ring and activation scale
    for input ``x`` that spread z = sum * so + ring over the codes' range
    (sums of unit spread, rings of 0.5, scales of about 1/100).  With
    ``uniform`` the ring is the same across each row's inner columns (as
    a conv of a constant canvas gives it, where the layer-1 kernel pools
    the sums before it dequantizes) and a quarter of the weight scales
    are negative (where it must not)."""
    cin = x.shape[-1]
    k = T(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
    spread = np.sqrt(9 * cin) * 74.0 * 73.0  # of a sum of random products
    so = rng.uniform(0.5, 1.5, cout) / spread
    ring = rng.normal(0, 0.5, (3, x.shape[2], cout))
    if uniform:
        so *= np.where(rng.uniform(size=cout) < 0.25, -1.0, 1.0)
        ring[:, 1:-1] = ring[:, 1:2]
    scale = T(rng.uniform(0.004, 0.012, cout).astype(np.float32))
    return (k, T(so.astype(np.float32)), T(ring.astype(np.float32)),
            scale)


def _offset_copy(x, nbytes):
    """A contiguous copy of ``x`` whose data starts ``nbytes`` past an
    aligned allocation (the kernels' narrower staging paths)."""
    buf = torch.empty(x.numel() + nbytes, dtype=x.dtype, device=x.device)
    out = buf[nbytes:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == nbytes % 16
    return out


# (B, H, W, Cin, Cout) at the edges of the mid-stack int8 tiling (3 x 21
# conv-pixel bands, 7 windows each): W = 85, 86 and 87 (Wp = 28, 28 and
# 29: the last band full, full with a column no window reads, and one
# window into a fifth band), so the last pixel's read 16 bytes past its
# kernel row falls in the buffer's slack; H % 3 = 0, 2 and 1; batches of
# 1 and 2, fewer items than the persistent grid has blocks; Cout = 40,
# no s8 wgmma width (a 48-wide tile with zero weight columns), and 16.
CONV_I8_TILING = [(3, 20, 85, 48, 48), (3, 20, 86, 48, 48),
                  (3, 20, 87, 48, 48), (1, 47, 85, 48, 48),
                  (2, 46, 85, 48, 40), (2, 6, 31, 48, 16)]


@pytest.mark.parametrize("shape", CONV_I8_TILING)
def test_conv_block_i8_kernel_tiling(cuda_dev, shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = T(rng.integers(-128, 128, (b, h, w, cin), dtype=np.int8))
    args = [t.to(cuda_dev) for t in (x, *_i8_random_args(rng, x, cout))]
    n = conv_block_i8.launches
    got = conv_block_i8(*args)
    assert conv_block_i8.launches == n + 1
    assert torch.equal(got, conv_block_i8_plain(*args))


@pytest.mark.parametrize("cin", [*range(4, 68, 4), 96, 128])
def test_conv_block_i8_kernel_every_cin(cuda_dev, cin):
    """Every input width the wrapper takes (Cin % 4 == 0): the staged
    stride padded to an odd number of 16-byte units, staged by 16-byte
    copies where Cin % 16 == 0 and by 4-byte ones otherwise."""
    rng = np.random.default_rng(cin)
    x = T(rng.integers(-128, 128, (2, 11, 25, cin), dtype=np.int8))
    args = [t.to(cuda_dev) for t in (x, *_i8_random_args(rng, x, 48))]
    assert torch.equal(conv_block_i8(*args), conv_block_i8_plain(*args))


def test_conv_block_i8_kernel_unaligned_input(cuda_dev):
    """Codes whose data starts 4 bytes past a 16-byte boundary: Cin = 48
    staged by 4-byte copies."""
    rng = np.random.default_rng(4)
    x = T(rng.integers(-128, 128, (3, 48, 85, 48), dtype=np.int8))
    k, so, ring, scale = (t.to(cuda_dev) for t in _i8_random_args(rng, x, 48))
    xo = _offset_copy(x.to(cuda_dev), 4)
    assert torch.equal(conv_block_i8(xo, k, so, ring, scale),
                       conv_block_i8_plain(xo, k, so, ring, scale))


# (B, H, W, Cout) at the edges of layer 1's int8 tiling (16 windows a
# tile): W = 256, 40, 22, 48 and 99 (Wp = 85, 13, 7, 16 and 33: the last
# tile partly filled, exactly full, or one window into a third tile; raw
# rows by 16-byte copies where 3W % 16 == 0, else byte by byte); H % 3 =
# 0, 2 and 1 and a 3 x 3 frame; batches of 1 and 133; Cout = 32, 40, 48
# and 64 of a 64-channel group.
CONV1_I8_TILING = [(1, 144, 256, 48), (133, 143, 40, 48), (2, 142, 22, 64),
                   (2, 144, 48, 32), (3, 145, 99, 40), (2, 3, 3, 48)]


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("shape", CONV1_I8_TILING)
def test_conv1_block_i8_kernel_tiling(cuda_dev, shape, uniform):
    b, h, w, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = T(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    args = [t.to(cuda_dev)
            for t in (x, *_i8_random_args(rng, x, cout, uniform))]
    n = conv1_block_i8.launches
    got = conv1_block_i8(*args)
    assert conv1_block_i8.launches == n + 1
    assert torch.equal(got, conv1_block_i8_plain(*args))


def test_conv1_block_i8_kernel_unaligned_input(cuda_dev):
    """Frames whose data starts 4 bytes past a 16-byte boundary: raw rows
    copied byte by byte at W = 256."""
    x = T(np.random.default_rng(1).integers(0, 256, (3, 144, 256, 3),
                                            dtype=np.uint8)).to(cuda_dev)
    k, so, ring, scale = _i8_layers(cuda_dev)[0]
    xo = _offset_copy(x, 4)
    assert torch.equal(conv1_block_i8(xo, k, so, ring, scale),
                       conv1_block_i8_plain(xo, k, so, ring, scale))


def test_i8_wrappers_refuse_a_width_off_4(cuda_dev):
    """The int8 kernels store four channels' codes as a word and read the
    ring and scales as float4: a Cout that is no multiple of 4 raises."""
    rng = np.random.default_rng(10)
    for fn, cin, dtype in ((conv_block_i8, 8, torch.int8),
                           (conv1_block_i8, 3, torch.uint8)):
        x = torch.zeros(1, 6, 9, cin, dtype=dtype, device=cuda_dev)
        k, so, ring, scale = (t.to(cuda_dev) for t in _i8_random_args(
            rng, x, 10))
        with pytest.raises(ValueError, match="multiple of 4 output"):
            fn(x, k, so, ring, scale)


def test_i8_wrappers_reject_bad_arguments(cuda_dev):
    k, so, ring, scale = _i8_layers(cuda_dev, 48, 84)[1]
    x = torch.zeros(2, 16, 28, 48, dtype=torch.int8, device=cuda_dev)
    with pytest.raises(TypeError):
        conv_block_i8(x.float(), k, so, ring, scale)
    with pytest.raises(ValueError):
        conv_block_i8(x, k, so, ring[:, :5].contiguous(), scale)
    with pytest.raises(ValueError):
        conv_block_i8(x[..., :6].contiguous(), k[:, :, :6].contiguous(), so,
                      ring, scale)
    with pytest.raises(ValueError):
        conv1_block_i8(x, k, so, ring, scale)
    with pytest.raises(TypeError):
        conv_block_i8(x, k.float(), so, ring, scale)


@pytest.mark.parametrize("h,w", [(144, 256), (143, 256), (3, 3)])
def test_conv1_block_kernel(cuda_dev, h, w):
    x = T(np.random.default_rng(h).integers(0, 256, (4, h, w, 3),
                                            dtype=np.uint8)).to(cuda_dev)
    args = (x, *_layer1_args(cuda_dev))
    n = conv1_block.launches
    got = conv1_block(*args)
    torch.cuda.synchronize()
    assert conv1_block.launches == n + 1
    assert got.shape == (4, h // 3, (w - 3) // 3 + 1, 48)
    torch.testing.assert_close(got, conv1_block_plain(*args), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("h,w", [(144, 256), (143, 256), (3, 3)])
def test_conv1_block_bf16_xla_kernel(cuda_dev, h, w):
    """XLA's instance, on the prod net's folded layer 1 at bfloat16_full
    with its kernel arguments (``gamma * rsqrt``)."""
    x = T(np.random.default_rng(h).integers(0, 256, (4, h, w, 3),
                                            dtype=np.uint8)).to(cuda_dev)
    args = (x, *_layer1_args(cuda_dev, "bfloat16_full"))
    kw = {"compute_dtype": "bfloat16_full", "numerics": "xla"}
    n = dict(conv1_block.instance_launches)
    got = conv1_block(*args, **kw)
    torch.cuda.synchronize()
    assert conv1_block.instance_launches == {
        **n, "bf16_xla": n["bf16_xla"] + 1}
    assert got.dtype == torch.bfloat16
    _assert_within_bf16_crossing(got, conv1_block_plain(*args, **kw),
                                 args[4], (args[3], args[2]))


@pytest.mark.parametrize("h,w", [(144, 256), (143, 256), (3, 3)])
def test_conv1_block_bf16_kernel(cuda_dev, h, w):
    """K1's instance, on the prod net's folded layer 1 at bfloat16_full
    (K1's ``gamma / sqrt`` BN)."""
    x = T(np.random.default_rng(h).integers(0, 256, (4, h, w, 3),
                                            dtype=np.uint8)).to(cuda_dev)
    args = (x, *_layer1_args(cuda_dev, "bfloat16_full", rsqrt=False))
    n = dict(conv1_block.instance_launches)
    got = conv1_block(*args, compute_dtype="bfloat16_full")
    torch.cuda.synchronize()
    assert conv1_block.instance_launches == {**n, "bf16": n["bf16"] + 1}
    assert got.shape == (4, h // 3, (w - 3) // 3 + 1, 48)
    assert got.dtype == torch.bfloat16
    want = conv1_block_plain(*args, compute_dtype="bfloat16_full")
    _assert_within_bf16_crossing(got, want, args[-1])


# (B, H, W, Cout) layer 1's tilings must survive: W = 256, 40, 22 and 48
# (Wp = 85, 13, 7, 16: the tensor-core route's last 8-window tile partly
# filled or exactly full; raw rows copied by 16-byte cp.async where 3W is
# a multiple of 16, else byte by byte), H % 3 = 0, 2 and 1, a 3x3 frame,
# batches of 1 and 133 (not a multiple of the persistent grid), and Cout
# = 32, 48 and 64 (half, three quarters and all of a 64-channel group).
CONV1_TILING = [(1, 144, 256, 32), (133, 143, 40, 48), (2, 142, 22, 64),
                (133, 142, 256, 48), (1, 3, 3, 64), (3, 143, 22, 32),
                (2, 144, 48, 48)]
# conv1_block's instances: (compute_dtype, numerics, rsqrt BN).
CONV1_KEYS = [(None, "pallas", True), ("bfloat16_full", "xla", True),
              ("bfloat16_full", "pallas", False)]


@pytest.mark.parametrize("shape", CONV1_TILING)
@pytest.mark.parametrize("key", CONV1_KEYS)
def test_conv1_block_kernel_tiling(cuda_dev, key, shape):
    """Every layer-1 instance against its plain version on seeded uint8
    frames and a seeded kernel at the folded layer's scale (weights of
    a few 1e-3 on pixels up to 255), one launch on its own counter."""
    compute_dtype, numerics, rsqrt = key
    b, h, w, cout = shape
    rng = np.random.default_rng(b * h * w + cout)
    x = T(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(cuda_dev)
    k = T((rng.normal(0, 0.1, (3, 3, 3, cout)) / 64).astype(np.float32))
    bias, gamma, beta, mean = (T(rng.normal(m, 0.1, cout)
                                 .astype(np.float32)).to(cuda_dev)
                               for m in (0, 1, 0, 0.5))
    var = T(rng.uniform(0.5, 2, cout).astype(np.float32)).to(cuda_dev)
    scale, offset = bn_scale_offset(mean, var, gamma, beta, rsqrt=rsqrt)
    k = k.to(cuda_dev, torch.bfloat16 if compute_dtype else torch.float32)
    args = (x, k, bias, scale, offset)
    kw = {"compute_dtype": compute_dtype, "numerics": numerics}
    name = conv1_instance(compute_dtype, numerics)[0]
    n = dict(conv1_block.instance_launches)
    got = conv1_block(*args, **kw)
    want = conv1_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert conv1_block.instance_launches == {**n, name: n[name] + 1}
    assert got.shape == want.shape == (b, h // 3, (w - 3) // 3 + 1, cout)
    assert got.dtype == want.dtype
    if compute_dtype is None:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        _assert_within_bf16_crossing(
            got, want, offset, (scale, bias) if numerics == "xla" else None)


def _check_instance(key, b, h, w, cin, cout, dev):
    """Instance ``key`` of ``conv_block`` against its plain version on a
    seeded block, with one launch counted on its own name."""
    compute_dtype, out_dtype, numerics = key
    rng = np.random.default_rng(b * h * w + cin + cout)
    x = T(rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)).to(dev)
    k, bias, scale, offset = _block_args(rng, dev, cin=cin, cout=cout)
    name, dtype = INSTANCES[key]
    x, k = x.to(dtype), k.to(dtype)
    n = dict(conv_block.instance_launches)
    kw = {"compute_dtype": compute_dtype, "out_dtype": out_dtype,
          "numerics": numerics or "pallas"}
    got = conv_block(x, k, bias, scale, offset, **kw)
    want = conv_block_plain(x, k, bias, scale, offset, **kw)
    torch.cuda.synchronize()
    assert conv_block.instance_launches == {**n, name: n[name] + 1}
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == (b, h // 3, (w - 3) // 3 + 1, cout)
    if compute_dtype == "bfloat16_full":
        _assert_within_bf16_crossing(
            got, want, offset, (scale, bias) if numerics == "xla" else None)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w,cin", [(48, 85, 48), (16, 28, 48),
                                     (10, 9, 8), (144, 256, 3)])
@pytest.mark.parametrize("key", list(INSTANCES))
def test_conv_block_kernel(cuda_dev, h, w, cin, key):
    """Every instance at the main path's shapes and two small ones."""
    _check_instance(key, 4, h, w, cin, 48, cuda_dev)


# (B, H, W, Cin, Cout) the tiling must survive: batches of 1 and 133 (not
# a multiple of the persistent grid), pooled widths that leave a partial
# 7-window tile (W = 40, 22), H % 3 = 1 and 2, Cin = 3, 8, 48 and Cout =
# 32, 48, 128 (two channel groups).
TILING_SHAPES = [(1, 48, 85, 48, 32), (2, 16, 28, 48, 128),
                 (133, 7, 22, 8, 48), (3, 11, 40, 48, 48),
                 (2, 14, 40, 3, 128), (1, 8, 22, 3, 32)]


@pytest.mark.parametrize("shape", TILING_SHAPES)
@pytest.mark.parametrize("key", list(INSTANCES))
def test_conv_block_kernel_tiling(cuda_dev, key, shape):
    _check_instance(key, *shape, cuda_dev)


@pytest.mark.parametrize("shape", [s for s in TILING_SHAPES if s[3] >= 8])
@pytest.mark.parametrize("out_dtype", list(CM_INSTANCES))
def test_fused_conv_block_kernel_tiling(cuda_dev, out_dtype, shape):
    """K4's wrapper (channel-major in and out) on the tiling shapes."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(b + h + w + cout)
    x = T(rng.normal(0, 1, (b, cin, h, w)).astype(np.float32)).to(cuda_dev)
    k = T(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32))
    bn = [rng.normal(0, 0.1, cout), rng.normal(1, 0.1, cout),
          rng.normal(0, 0.1, cout), rng.normal(0, 0.5, cout),
          rng.uniform(0.5, 2, cout)]
    args = [k.to(cuda_dev)] + [T(a.astype(np.float32)).to(cuda_dev)
                               for a in bn]
    kw = {"out_dtype": out_dtype, "nhwc_out": True, "channel_major_in": True}
    got = fused_conv_block(x, *args, **kw)
    want = fused_conv_block_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, h // 3, (w - 3) // 3 + 1, cout)
    _, gamma, beta, mean, var = args[1:]
    s = gamma / torch.sqrt(var + 1e-5)
    _assert_within_bf16_crossing(got, want, beta - mean * s)


@pytest.mark.parametrize("nhwc_out", [True, False])
@pytest.mark.parametrize("channel_major_in", [False, True])
@pytest.mark.parametrize("out_dtype", list(CM_INSTANCES))
@pytest.mark.parametrize("h,w,cin", [(48, 85, 48), (16, 28, 48),
                                     (36, 40, 8), (10, 9, 8)])
def test_fused_conv_block_kernel(cuda_dev, h, w, cin, out_dtype,
                                 channel_major_in, nhwc_out):
    """K4's channel-major instances through its wrapper, every layout,
    with one launch counted on the instance's name."""
    rng = np.random.default_rng(h + w)
    x = T(rng.normal(0, 1, (4, h, w, cin)).astype(np.float32)).to(cuda_dev)
    if channel_major_in:
        x = x.permute(0, 3, 1, 2).contiguous()
    k = T(rng.normal(0, 0.1, (3, 3, cin, 48)).astype(np.float32))
    bn = [rng.normal(0, 0.1, 48), rng.normal(1, 0.1, 48),
          rng.normal(0, 0.1, 48), rng.normal(0, 0.5, 48),
          rng.uniform(0.5, 2, 48)]
    args = [k.to(cuda_dev)] + [T(a.astype(np.float32)).to(cuda_dev)
                               for a in bn]
    kw = {"out_dtype": out_dtype, "nhwc_out": nhwc_out,
          "channel_major_in": channel_major_in}
    name = CM_INSTANCES[out_dtype]
    n = dict(conv_block.instance_launches)
    got = fused_conv_block(x, *args, **kw)
    want = fused_conv_block_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert conv_block.instance_launches == {**n, name: n[name] + 1}
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == want.shape
    if not nhwc_out:
        got, want = got.permute(0, 2, 3, 1), want.permute(0, 2, 3, 1)
    _, gamma, beta, mean, var = args[1:]
    s = gamma / torch.sqrt(var + 1e-5)
    _assert_within_bf16_crossing(got, want, beta - mean * s)


@pytest.mark.parametrize("in_h,in_w,out_h,out_w", [
    (720, 1280, 144, 256), (240, 427, 143, 256), (77, 100, 55, 77),
    (17, 33, 55, 99)])
def test_resize_normalize_kernel(cuda_dev, in_h, in_w, out_h, out_w):
    x = T(np.random.default_rng(in_w).integers(
        0, 256, (4, in_h, in_w, 3), dtype=np.uint8)).to(cuda_dev)
    n = resize_normalize.launches
    got = resize_normalize(x, out_h, out_w)
    torch.cuda.synchronize()
    assert resize_normalize.launches == n + 1
    assert got.shape == (4, out_h, out_w, 3)
    torch.testing.assert_close(got, resize_normalize_plain(x, out_h, out_w),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,h,w,offset", [
    (128, 144, 256, 0), (3, 2, 2, 0), (5, 146, 254, 0), (4, 144, 426, 0),
    (3, 2, 18, 0), (4, 2, 6, 0), (133, 144, 256, 0), (6, 144, 256, 2),
    (3, 16, 32, 2), (7, 10, 48, 0), (2, 4, 1056, 0)])
def test_yuv420_to_bgr_kernel(cuda_dev, b, h, w, offset):
    """The kernel equals its plain version exactly, one launch: the
    vector route (W % 16 == 0, 16-aligned planes; blocks that span whole
    rows, part of a row at 1056, or hang past the row at 48) and the
    scalar one (a width off 16, a frame stride off 16 at B > 1, planes
    ``offset`` bytes into a larger buffer)."""
    n_bytes = yuv420_nbytes(h, w)
    buf = T(np.random.default_rng(h * w).integers(
        0, 256, b * n_bytes + offset, dtype=np.uint8)).to(cuda_dev)
    x = buf[offset:].view(b, n_bytes)
    n = yuv420_to_bgr.launches
    got = yuv420_to_bgr(x, h, w)
    torch.cuda.synchronize()
    assert yuv420_to_bgr.launches == n + 1
    assert got.shape == (b, h, w, 3) and got.dtype == torch.uint8
    assert torch.equal(got, yuv420_to_bgr_plain(x, h, w))
    assert torch.equal(got.cpu(), yuv420_to_bgr_plain(x.cpu(), h, w))


def test_yuv420_to_bgr_kernel_refuses_bad_input(cuda_dev):
    n = yuv420_to_bgr.launches
    for h, w in ((145, 256), (144, 255)):
        x = torch.zeros((2, yuv420_nbytes(h, w)), dtype=torch.uint8,
                        device=cuda_dev)
        with pytest.raises(ValueError, match="even dims"):
            yuv420_to_bgr(x, h, w)
    good = torch.zeros((2, yuv420_nbytes(4, 4)), dtype=torch.uint8,
                       device=cuda_dev)
    with pytest.raises(TypeError):
        yuv420_to_bgr(good.int(), 4, 4)
    with pytest.raises(ValueError):
        yuv420_to_bgr(good[:, :-2], 4, 4)
    assert yuv420_to_bgr.launches == n


@pytest.mark.parametrize("precision", ["float32", "bfloat16",
                                       "bfloat16_full", "uint8_pool",
                                       "uint8_chain"])
def test_yuv_loop_on_card_equals_host_converted(cuda_dev, precision):
    """The device loop on YUV batches equals the same loop on the batches
    converted on the host, exactly, with one YUV -> BGR launch a batch;
    at float32 it also agrees with the CPU within 1e-4."""
    rng = np.random.default_rng(9)
    planes = rng.integers(0, 256, (40, yuv420_nbytes(144, 256)),
                          dtype=np.uint8)
    bgr = yuv420_to_bgr_np(planes, 144, 256)
    net, _ = load_default_net(cuda_dev, precision)

    def run(stream, net=net, **opts):
        return classify_batches(batch_frames(iter(stream), 16), net,
                                batch_size=16, length=40, print_every=0,
                                **opts)

    n = yuv420_to_bgr.launches
    conf, pred, stats = run(planes, yuv_dims=(144, 256))
    assert stats.batches == 3 and yuv420_to_bgr.launches == n + 3
    want_conf, want_pred, _ = run(bgr)
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_array_equal(conf, want_conf)
    if precision == "float32":
        cpu_conf, cpu_pred, _ = run(planes, load_default_net("cpu")[0],
                                    yuv_dims=(144, 256))
        np.testing.assert_array_equal(pred, cpu_pred)
        np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=1e-4)
    step = make_classify_step(net, yuv_dims=(144, 256))
    step(T(planes[:16]).to(cuda_dev))
    assert yuv420_to_bgr.launches == n + 4


def test_exact_resize_on_card_matches_cpu(cuda_dev):
    """The int32 cv2 emulation gives the same bytes on the card."""
    x = T(np.random.default_rng(2).integers(0, 256, (4, 720, 1280, 3),
                                            dtype=np.uint8))
    got = resize_bilinear(x.to(cuda_dev), 144, 256, exact=True)
    assert torch.equal(got.cpu(), resize_bilinear(x, 144, 256, exact=True))


def test_wrappers_reject_bad_arguments(cuda_dev):
    rng = np.random.default_rng(0)
    k, bias, scale, offset = _block_args(rng, cuda_dev)
    x = torch.zeros(2, 9, 12, 48, device=cuda_dev)
    with pytest.raises(TypeError):
        conv_block(x.double(), k, bias, scale, offset)
    with pytest.raises(ValueError):
        conv_block(x.transpose(1, 2), k, bias, scale, offset)
    with pytest.raises(ValueError):
        conv_block(x, k, bias.cpu(), scale, offset)
    with pytest.raises(TypeError):
        conv1_block(x[..., :3].contiguous(), *_layer1_args(cuda_dev))
    with pytest.raises(TypeError):
        resize_normalize(x[..., :3].contiguous(), 4, 4)
    frames = torch.zeros(2, 9, 12, 3, dtype=torch.uint8, device=cuda_dev)
    with pytest.raises(ValueError):
        resize_normalize(frames.transpose(1, 2), 4, 4)


def test_slice_on_card_matches_cpu(cuda_dev):
    """The pipeline's device loop on the card against the same loop on
    the CPU (plain versions): identical classes, conf within 1e-4, and
    one layer-1 plus two mid-stack launches per batch."""
    frames = np.random.default_rng(1).integers(0, 256, (40, 144, 256, 3),
                                               dtype=np.uint8)

    def run(dev):
        net, _ = load_default_net(dev)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    c1, cb = conv1_block.launches, conv_block.launches
    conf, pred, stats = run(cuda_dev)
    assert stats.batches == 3
    assert (conv1_block.launches - c1, conv_block.launches - cb) == (3, 6)
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=1e-4)


# Launches per batch by instance of each rung's default path (conv1_block,
# conv_block) and --pallas-preprocess path (conv_block; plus the resize
# kernel).
RUNG_LAUNCHES = {
    "bfloat16": ({"f32": 1}, {"bf16_operands": 2}, {"bf16_operands": 3}),
    "bfloat16_full": ({"bf16_xla": 1}, {"bf16_xla": 1, "bf16_xla_f32": 1},
                      {"bf16_xla": 2, "bf16_xla_f32": 1}),
}


@pytest.mark.parametrize("pallas_preprocess", [False, True])
@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_full"])
def test_bf16_slice_on_card_matches_cpu(cuda_dev, precision,
                                        pallas_preprocess):
    """The device loop at a bf16 rung on the card against the CPU:
    identical classes, conf within 2e-2, and the rung's instances
    launched (default path: layer 1 + two mid-stack blocks a batch;
    --pallas-preprocess: the resize kernel + three mid-stack blocks)."""
    shape = (40, 360, 640, 3) if pallas_preprocess else (40, 144, 256, 3)
    frames = np.random.default_rng(4).integers(0, 256, shape,
                                               dtype=np.uint8)
    opts = ({"device_resize": (144, 256), "pallas_preprocess": True}
            if pallas_preprocess else {})

    def run(dev):
        net, _ = load_default_net(dev, precision)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0,
                                **opts)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    c1, cb = (dict(conv1_block.instance_launches),
              dict(conv_block.instance_launches))
    k5 = resize_normalize.launches
    conf, pred, stats = run(cuda_dev)
    assert stats.batches == 3
    first, mids, fused_mids = RUNG_LAUNCHES[precision]
    want_c1 = dict(c1)
    want_cb = dict(cb)
    for inst, k in (fused_mids if pallas_preprocess else mids).items():
        want_cb[inst] += 3 * k
    if not pallas_preprocess:
        for inst, k in first.items():
            want_c1[inst] += 3 * k
    assert conv1_block.instance_launches == want_c1
    assert conv_block.instance_launches == want_cb
    assert resize_normalize.launches - k5 == (3 if pallas_preprocess else 0)
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=2e-2)


@pytest.mark.parametrize("pallas_preprocess", [False, True])
@pytest.mark.parametrize("precision", ["uint8_pool", "uint8_chain"])
def test_quantized_slice_on_card_matches_cpu(cuda_dev, precision,
                                             pallas_preprocess):
    """The device loop at a quantized rung on the card against the CPU:
    identical classes, conf within QUANT_CONF_TOL, no block kernel
    launched (the resize kernel alone with --pallas-preprocess)."""
    shape = (40, 360, 640, 3) if pallas_preprocess else (40, 144, 256, 3)
    frames = np.random.default_rng(4).integers(0, 256, shape,
                                               dtype=np.uint8)
    opts = ({"device_resize": (144, 256), "pallas_preprocess": True}
            if pallas_preprocess else {})

    def run(dev):
        net, _ = load_default_net(dev, precision)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0,
                                **opts)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    before = (resize_normalize.launches, conv1_block.launches,
              conv_block.launches)
    conf, pred, stats = run(cuda_dev)
    after = (resize_normalize.launches, conv1_block.launches,
             conv_block.launches)
    assert stats.batches == 3
    assert tuple(a - b for a, b in zip(after, before)) == (
        (3 if pallas_preprocess else 0), 0, 0)
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=QUANT_CONF_TOL)


@pytest.mark.parametrize("pallas_preprocess", [False, True])
def test_int8_slice_on_card_matches_cpu(cuda_dev, pallas_preprocess):
    """The device loop at ``int8_mxu`` on the card against the CPU:
    identical classes, conf within QUANT_CONF_TOL (the rings are a bf16
    conv, cuDNN's summation order against the CPU's), and the int8 block
    kernels launched (default: layer 1 and two mid-stack blocks a batch;
    --pallas-preprocess: the resize kernel, a dense layer 1 in plain
    PyTorch and two mid-stack blocks), no other block kernel."""
    shape = (40, 360, 640, 3) if pallas_preprocess else (40, 144, 256, 3)
    frames = np.random.default_rng(4).integers(0, 256, shape,
                                               dtype=np.uint8)
    opts = ({"device_resize": (144, 256), "pallas_preprocess": True}
            if pallas_preprocess else {})

    def run(dev):
        net, _ = load_default_net(dev, "int8_mxu")
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0,
                                **opts)

    def counts():
        return (resize_normalize.launches, conv1_block.launches,
                conv_block.launches, conv1_block_i8.launches,
                conv_block_i8.launches)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    before = counts()
    conf, pred, stats = run(cuda_dev)
    assert stats.batches == 3
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        (3, 0, 0, 0, 6) if pallas_preprocess else (0, 0, 0, 3, 6))
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=QUANT_CONF_TOL)


def test_device_smooth_on_card_matches_cpu(cuda_dev):
    """The smoother on the card gives the CPU's table, means bit for bit
    (each f32 operation rounds the same on both)."""
    from cut_detection_tpu_torch.segmentation.device_glue import device_smooth

    rng = np.random.default_rng(3)
    pred = np.repeat(rng.integers(0, 3, 900), rng.integers(1, 40, 900))
    pred = pred.astype(np.int32)
    conf = rng.uniform(1, 6, pred.size).astype(np.float32)
    cpu = device_smooth(T(conf), T(pred), max_segments=1024)
    card = device_smooth(T(conf).to(cuda_dev), T(pred).to(cuda_dev),
                         max_segments=1024)
    assert card[3] == cpu[3]
    for i in (0, 1, 2, 4, 5):
        assert torch.equal(card[i].cpu(), cpu[i]), i


def test_profile_on_card_traces_the_kernels(cuda_dev, tmp_path):
    """``--profile DIR`` on the card writes a trace that holds the card's
    kernels, and the CSV is the reference's."""
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("needs cv2 to decode the golden clips")
    from cut_detection_tpu_torch.cli.segment_video import main

    out, trace = str(tmp_path / "out.csv"), tmp_path / "trace"
    main([os.path.join(GOLDEN, "clip.mp4"), "--transfer", "bgr",
          "--output_path", out, "--print-every", "0", "--profile",
          str(trace)])
    (name,) = os.listdir(trace)
    with open(trace / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    with open(out, "rb") as f, open(os.path.join(GOLDEN,
                                                 "ref_segments.csv"),
                                    "rb") as g:
        assert f.read() == g.read()


def test_bench_block_stage_on_card(cuda_dev):
    """The bench entry point's block stage at batch 16: K1 -> K4 -> K4 ->
    head equals K1 -> K3 -> K3 -> head and holds the shipped net's classes
    (XLA's numerics) within ``chip_smoke.BENCH_XLA_TOL``, with K4
    launched twice per call of that graph."""
    from cut_detection_tpu_torch.scripts import bench_fused_conv1 as bench

    graphs = bench.build_graphs(cuda_dev)
    x = bench.seeded_frames(16, cuda_dev)
    with torch.inference_mode():
        assert torch.equal(graphs["e2e_allfused"](x), graphs["e2e_k3"](x))
    n = dict(conv_block.instance_launches)
    out = bench.run(batch=16, steps=1, stage="block", device=cuda_dev)
    calls = 2 + 3 * 1
    assert conv_block.instance_launches["cm_bf16"] - n["cm_bf16"] == \
        2 * calls
    assert out["full_argmax_flips"] == 0
    assert out["full_max_logit_diff"] < BENCH_XLA_TOL
    assert out["e2e_allfused_fps"] > 0


def test_bfloat16_full_step_launches_only_xla_instances(cuda_dev):
    """One ``bfloat16_full`` step at the prod shape (128 frames of
    144x256) launches XLA's instances and no other kernel: layer 1's
    ``bf16_xla``, layer 2's ``bf16_xla`` and layer 3's ``bf16_xla_f32``,
    once each."""
    from cut_detection_tpu_torch.pipeline import make_classify_step

    net, _ = load_default_net(cuda_dev, "bfloat16_full")
    step = make_classify_step(net)
    frames = T(np.random.default_rng(8).integers(
        0, 256, (128, 144, 256, 3), dtype=np.uint8)).to(cuda_dev)
    step(frames)  # build and freeze outside the count
    torch.cuda.synchronize()
    before = (dict(conv1_block.instance_launches),
              dict(conv_block.instance_launches), resize_normalize.launches)
    step(frames)
    torch.cuda.synchronize()
    c1 = {k: v - before[0][k]
          for k, v in conv1_block.instance_launches.items()}
    cb = {k: v - before[1][k]
          for k, v in conv_block.instance_launches.items()}
    assert {k: v for k, v in c1.items() if v} == {"bf16_xla": 1}
    assert {k: v for k, v in cb.items() if v} == {"bf16_xla": 1,
                                                  "bf16_xla_f32": 1}
    assert resize_normalize.launches == before[2]


@pytest.mark.parametrize("pallas_preprocess", [False, True])
def test_on_device_preprocess_on_card_matches_cpu(cuda_dev,
                                                  pallas_preprocess):
    """Raw 360x640 frames resized by the step on the card against the
    same step on the CPU: identical classes, conf within 1e-4, and the
    launches per batch of each path (exact: layer 1 on uint8 plus two
    mid-stack blocks; fused: the resize kernel plus three f32 blocks)."""
    frames = np.random.default_rng(3).integers(0, 256, (40, 360, 640, 3),
                                               dtype=np.uint8)

    def run(dev):
        net, _ = load_default_net(dev)
        return classify_batches(batch_frames(iter(frames), 16), net,
                                batch_size=16, length=40, print_every=0,
                                device_resize=(144, 256),
                                pallas_preprocess=pallas_preprocess)

    cpu_conf, cpu_pred, _ = run(torch.device("cpu"))
    before = (resize_normalize.launches, conv1_block.launches,
              conv_block.launches)
    conf, pred, stats = run(cuda_dev)
    after = (resize_normalize.launches, conv1_block.launches,
             conv_block.launches)
    assert stats.batches == 3
    assert tuple(a - b for a, b in zip(after, before)) == (
        (3, 0, 9) if pallas_preprocess else (0, 3, 6))
    np.testing.assert_array_equal(pred, cpu_pred)
    np.testing.assert_allclose(conf, cpu_conf, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flags", [
    [], ["--device-resize"], ["--device-resize", "--pallas-preprocess"],
    ["--precision", "bfloat16"], ["--precision", "bfloat16_full"],
    ["--precision", "uint8_pool"], ["--precision", "uint8_chain"],
    ["--precision", "int8_mxu"], ["--device-glue"]])
@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_on_card_matches_golden_csv(cuda_dev, tmp_path, clip, ref,
                                        flags):
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("needs cv2 to decode the golden clips")
    from cut_detection_tpu_torch.cli.segment_video import main

    out = str(tmp_path / "out.csv")
    main([os.path.join(GOLDEN, clip), "--transfer", "bgr", "--output_path",
          out, "--print-every", "0", *flags])
    with open(out, "rb") as f, open(os.path.join(GOLDEN, ref), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("transfer", ["yuv420", "auto"])
@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_cli_yuv420_on_card_matches_golden_csv(cuda_dev, tmp_path, clip, ref,
                                               transfer):
    """The golden clips under ``--transfer yuv420`` and ``auto`` (which
    resolves to yuv420 on the card with the native YUV decoder) give the
    reference CSVs at float32, through the YUV -> BGR kernel."""
    from cut_detection_tpu_torch.data import native_video

    if not native_video.yuv_available():
        pytest.skip("native decoder with YUV entry points not built")
    from cut_detection_tpu_torch.cli.segment_video import main

    out = str(tmp_path / "out.csv")
    n = yuv420_to_bgr.launches
    main([os.path.join(GOLDEN, clip), "--transfer", transfer,
          "--output_path", out, "--print-every", "0"])
    assert yuv420_to_bgr.launches == n + 2  # 200-220 frames, batch 128
    with open(out, "rb") as f, open(os.path.join(GOLDEN, ref), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("stage", ["cast", "taps", "dotn", "dott", "tpose",
                                   "full"])
def test_conv1_stages_kernel(cuda_dev, stage):
    """Each stage of the layer-1 stage-bisection kernel against its plain
    version at batch 3 of the profiling script's seeded inputs, by
    ``conv1_stages.check_stage`` (``cast`` and ``taps`` exact, the sums
    within the tolerances stated there), one launch a call."""
    from cut_detection_tpu_torch.ops.kernels import conv1_stages as cs
    from cut_detection_tpu_torch.scripts.profile_fused_conv1 import (
        seeded_inputs,
    )

    x, w = seeded_inputs(3, cuda_dev)
    before = cs.conv1_stages.instance_launches[stage]
    got = cs.conv1_stages(x, w, stage)
    torch.cuda.synchronize()
    assert cs.conv1_stages.instance_launches[stage] == before + 1
    cs.check_stage(stage, x, w, got, cs.conv1_stages_plain(x, w, stage))
    assert torch.isfinite(got[0]).all()
    if stage in ("dotn", "tpose", "full"):
        assert got[0].abs().max() > 10.0


def test_served_request_launches_the_block_kernels(cuda_dev, tmp_path):
    """One ``/segment`` request to the daemon on the card: the reference's
    CSV bytes (float32, bgr), and the request's two batches launched
    ``conv1_block[f32]`` twice and ``conv_block[f32]`` four times."""
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("needs cv2 to decode the golden clips")
    import threading
    import urllib.request

    from cut_detection_tpu_torch.cli import serve

    srv, state = serve.make_server("127.0.0.1", 0, device=cuda_dev)
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    out = str(tmp_path / "served.csv")
    before = (dict(conv1_block.instance_launches),
              dict(conv_block.instance_launches))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/segment",
            data=json.dumps({"input_path": os.path.join(GOLDEN, "clip.mp4"),
                             "output_path": out,
                             "transfer": "bgr"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            data = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert data["stats"]["batches"] == 2
    assert conv1_block.instance_launches["f32"] - before[0]["f32"] == 2
    assert conv_block.instance_launches["f32"] - before[1]["f32"] == 4
    with open(out, "rb") as f, open(os.path.join(GOLDEN, "ref_segments.csv"),
                                    "rb") as g:
        assert f.read() == g.read()


def test_every_kernel_launches_on_its_tensors_card(cuda_dev):
    """With ``cuda:0`` current, every kernel route launched on tensors on
    ``cuda:1`` (``chip_smoke.off_device_kernels``: layer 1 and the
    mid-stack block at f32, the int8 blocks, resize + normalize, YUV ->
    BGR, the layer-1 stage bisection) writes there and equals its plain
    version; ``cuda:0`` stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(GOLDEN), "..",
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with torch.cuda.device(0):
        errs = chip_smoke.off_device_kernels(torch.device("cuda", 1))
        assert torch.cuda.current_device() == 0
    assert len(errs) == 9


@pytest.mark.parametrize("precision", ["float32", "int8_mxu"])
def test_sharded_step_over_one_card_twice(cuda_dev, precision):
    """``make_classify_step(net, mesh=[cuda:0, cuda:0])``: each batch split
    in two, each half on a replica of its own, the outputs gathered in
    frame order; the same classes, each instance launched once a shard,
    and conf within ``chip_smoke.PARALLEL_CONF_TOL`` of the unsharded
    step: 1e-5 at float32; ``QUANT_CONF_TOL`` at ``int8_mxu``, whose
    pooled features and hidden layer are rounded to bf16 after cuBLAS
    sums 64 rows in another order than 128 (1.24e-5 measured)."""
    from cut_detection_tpu_torch.parallel import make_mesh

    net, _ = load_default_net(cuda_dev, precision)
    x = T(np.random.default_rng(9).integers(0, 256, (128, 144, 256, 3),
                                            dtype=np.uint8))
    conf1, pred1 = make_classify_step(net)(x.to(cuda_dev))
    step = make_classify_step(net, mesh=make_mesh([cuda_dev, cuda_dev]))
    kernels = ((conv1_block_i8, conv_block_i8) if precision == "int8_mxu"
               else (conv1_block, conv_block))
    before = [k.launches for k in kernels]
    conf, pred = step(x)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 4]
    assert conf.device == conf1.device and pred.dtype == torch.int32
    torch.testing.assert_close(conf, conf1, rtol=0,
                               atol=1e-5 if precision == "float32"
                               else QUANT_CONF_TOL)
    assert torch.equal(pred, pred1)


def test_full_game_bench_on_card_matches_cpu(cuda_dev, tmp_path,
                                             monkeypatch):
    """``bench_full_game`` at 512 frames in ``bgr:float32`` on the card:
    its CSV is the same run's ``--cpu`` CSV byte for byte, every frame is
    decoded, and the record names the card."""
    import tempfile

    from cut_detection_tpu_torch.scripts import bench_full_game
    from cut_detection_tpu_torch.utils.device import card_info

    monkeypatch.setenv("FULL_GAME_FRAMES", "512")
    monkeypatch.setenv("FULL_GAME_MODES", "bgr:float32")
    monkeypatch.delenv("FULL_GAME_WORKERS", raising=False)
    csvs, records = {}, {}
    for where, argv in (("card", []), ("cpu", ["--cpu"])):
        d = tmp_path / where
        d.mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(d))
        monkeypatch.setenv("FULL_GAME_OUT", str(d / "game.json"))
        records[where] = bench_full_game.main(argv)
        with open(bench_full_game.csv_path(512, "bgr_float32"), "rb") as f:
            csvs[where] = f.read()
    assert csvs["card"] == csvs["cpu"]
    assert records["card"]["hardware"] == card_info()
    assert records["card"]["hardware"].startswith(
        torch.cuda.get_device_name(0))
    assert records["cpu"]["hardware"].startswith("cpu")
    mode = records["card"]["modes"]["bgr_float32"]
    assert mode["frames"] == 512 and mode["decode_failures"] == 0


# The output channels of the tensor-parallel step's block slices: the
# prod net's 48 over 2 and over 4 model columns.
TP_WIDTHS = [24, 12]
# The mid-stack instances that step launches (its rungs' own).
TP_KEYS = [key for key, (name, _) in INSTANCES.items()
           if name in ("f32", "bf16_operands", "bf16_xla", "bf16_xla_f32")]


def _tp_slice(args, cout):
    """Model column 1's slice of ``cout`` output channels of a block's
    kernel arguments (each cut on its last axis)."""
    return [t[..., cout:2 * cout].contiguous() for t in args]


@pytest.mark.parametrize("cout", TP_WIDTHS)
@pytest.mark.parametrize("precision", ["float32", "bfloat16_full"])
def test_conv1_block_kernel_at_tensor_parallel_widths(cuda_dev, precision,
                                                      cout):
    """Layer 1's ``f32`` and ``bf16_xla`` instances on a slice of the prod
    net's folded layer 1, as a tensor-parallel column holds it, against
    their plain versions at the main path's shape."""
    kernel, bias, scale, offset = _tp_slice(
        _layer1_args(cuda_dev, precision), cout)
    x = T(np.random.default_rng(cout).integers(
        0, 256, (16, 144, 256, 3), dtype=np.uint8)).to(cuda_dev)
    kw = {"compute_dtype": None if precision == "float32" else precision,
          "numerics": "xla"}
    n = conv1_block.launches
    got = conv1_block(x, kernel, bias, scale, offset, **kw)
    want = conv1_block_plain(x, kernel, bias, scale, offset, **kw)
    torch.cuda.synchronize()
    assert conv1_block.launches == n + 1
    assert got.shape == (16, 48, 85, cout)
    if precision == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    else:
        _assert_within_bf16_crossing(got, want, offset, (scale, bias))


@pytest.mark.parametrize("cout", TP_WIDTHS)
@pytest.mark.parametrize("h,w", [(48, 85), (16, 28)])
@pytest.mark.parametrize("key", TP_KEYS)
def test_conv_block_kernel_at_tensor_parallel_widths(cuda_dev, key, h, w,
                                                     cout):
    """The mid-stack instances the tensor-parallel step launches, on the
    whole 48 input channels and ``cout`` output channels."""
    _check_instance(key, 4, h, w, 48, cout, cuda_dev)


@pytest.mark.parametrize("cout", TP_WIDTHS)
def test_conv1_block_i8_kernel_at_tensor_parallel_widths(cuda_dev, cout):
    """``conv1_block[i8]`` on a column's slice of the prod net's folded
    int8 layer 1 (weights, scales and ring from the whole layer): codes
    equal to the plain version's."""
    args = _tp_slice(_i8_layers(cuda_dev)[0], cout)
    x = T(np.random.default_rng(cout).integers(
        0, 256, (16, 144, 256, 3), dtype=np.uint8)).to(cuda_dev)
    n = conv1_block_i8.launches
    got = conv1_block_i8(x, *args)
    assert conv1_block_i8.launches == n + 1
    assert got.shape == (16, 48, 85, cout)
    assert torch.equal(got, conv1_block_i8_plain(x, *args))


@pytest.mark.parametrize("cout", TP_WIDTHS)
@pytest.mark.parametrize("layer,h,w", [(1, 48, 85), (2, 16, 28)])
def test_conv_block_i8_kernel_at_tensor_parallel_widths(cuda_dev, layer, h,
                                                        w, cout):
    """``conv_block[i8]`` on the whole layer's 48 input codes and a
    column's ``cout`` output channels of the prod net's int8 layer."""
    args = _tp_slice(_i8_layers(cuda_dev)[layer], cout)
    x = T(np.random.default_rng(h + cout).integers(
        -128, 128, (16, h, w, 48), dtype=np.int8)).to(cuda_dev)
    n = conv_block_i8.launches
    got = conv_block_i8(x, *args)
    assert conv_block_i8.launches == n + 1
    assert torch.equal(got, conv_block_i8_plain(x, *args))


@pytest.mark.parametrize("precision", ["float32", "int8_mxu"])
def test_tensor_parallel_over_one_card(cuda_dev, precision):
    """``make_sharded_classify_step(..., tensor_parallel=True)`` over
    ``[cuda:0] * 2`` at model 2: each block runs on two 24-channel slices
    and the channels are gathered after it; the classes of the unsharded
    step, conf within ``chip_smoke.PARALLEL_CONF_TOL``, each layer's
    kernel launched once a column."""
    from cut_detection_tpu_torch.parallel import (
        make_mesh,
        make_sharded_classify_step,
    )

    net, _ = load_default_net(cuda_dev, precision)
    x = T(np.random.default_rng(9).integers(0, 256, (128, 144, 256, 3),
                                            dtype=np.uint8))
    conf1, pred1 = make_classify_step(net)(x.to(cuda_dev))
    step = make_sharded_classify_step(
        net, make_mesh([cuda_dev, cuda_dev], model_parallel=2),
        tensor_parallel=True)
    kernels = ((conv1_block_i8, conv_block_i8) if precision == "int8_mxu"
               else (conv1_block, conv_block))
    before = [k.launches for k in kernels]
    conf, pred = step(x)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 4]
    assert conf.device == conf1.device and pred.dtype == torch.int32
    torch.testing.assert_close(conf, conf1, rtol=0,
                               atol=1e-5 if precision == "float32"
                               else QUANT_CONF_TOL)
    assert torch.equal(pred, pred1)
