"""``tolerance.bf16_check``, the bar that holds the bf16-activation kernel
instances (K1's ``conv1_block[bf16]`` and ``conv_block[bf16_out]``)
against their plain versions on the card, fails a wrong kernel.

Each plain version is held on the CPU against three stand-ins for a
kernel, on the main path's inputs (the prod net's folded layer 1 on
uint8 frames; a 48-channel block on bf16 activations at 48x85):

- the right numerics in another summation order (the convolution in
  float64, then rounded to f32): passes (0 and 1 one-ulp crossings in
  391,680 and 43,008 elements when written);
- the post-ReLU rounding to bf16 left out (31% and 27% crossed);
- that rounding toward zero instead of to nearest (33% and 45%).

Both wrong ones stay within the one-ulp bound on every element, which
alone would pass them; the cap on crossings (0.1% of the elements)
fails them.

The XLA-numerics instances (``conv1_block[bf16_xla]``,
``conv_block[bf16_xla]`` and ``[bf16_xla_f32]``) are held by
``xla_check`` the same way: their recipe in another summation order
passes, and the recipe with its bf16 roundings left out or made toward
zero fails.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cut_detection_tpu_torch.models.assembly import (
    fold_preprocess,
    load_default_net,
)
from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block_plain
from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block_plain
from cut_detection_tpu_torch.ops.kernels.tolerance import (
    MAX_CROSSING_SHARE,
    bf16_check,
    xla_check,
)
from cut_detection_tpu_torch.ops.nn import bf16_round, bn_scale_offset

T = torch.from_numpy


def _toward_zero(z):
    """f32 ``z`` rounded to bf16 toward zero (the low 16 bits dropped)."""
    return (z.view(torch.int32) & ~0xFFFF).view(torch.float32)


ROUNDINGS = {"nearest": bf16_round, "none": lambda z: z,
             "toward_zero": _toward_zero}


def _stand_in(x, kernel, bias, scale, offset, rounding):
    """The bf16-activation block with its conv summed in float64 and its
    post-ReLU activation rounded by ``rounding``; bf16 output."""
    z = F.conv2d(x.double().permute(0, 3, 1, 2),
                 kernel.double().permute(3, 2, 0, 1), bias.double(),
                 padding=1).float().permute(0, 2, 3, 1)
    z = ROUNDINGS[rounding](torch.relu(z))
    pooled = F.max_pool2d(z.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    return (pooled * scale + offset).to(torch.bfloat16)


def _layer1():
    """Seeded frames and the prod net's folded layer 1 at bfloat16_full:
    (plain output, kernel arguments)."""
    net, _ = load_default_net("cpu", "bfloat16_full")
    _, bias, scale, offset = net.conv.conv_layers[0].kernel_args()
    kernel = (fold_preprocess(net.state_dict())
              ["conv.conv_layers.0.conv.weight"].permute(2, 3, 1, 0)
              .contiguous().to(torch.bfloat16))
    x = T(np.random.default_rng(0).integers(0, 256, (2, 144, 256, 3),
                                            dtype=np.uint8))
    args = (x, kernel, bias, scale, offset)
    return conv1_block_plain(*args, compute_dtype="bfloat16_full"), args


def _block():
    """A seeded 48-channel block on bf16 activations at 48x85."""
    rng = np.random.default_rng(1)
    x = T(rng.normal(0, 1, (2, 48, 85, 48)).astype(np.float32)) \
        .to(torch.bfloat16)
    kernel = T(rng.normal(0, 0.1, (3, 3, 48, 48)).astype(np.float32)) \
        .to(torch.bfloat16)
    bias = T(rng.normal(0, 0.1, 48).astype(np.float32))
    f32 = lambda a: T(a.astype(np.float32))  # noqa: E731
    scale, offset = bn_scale_offset(
        f32(rng.normal(0, 0.5, 48)), f32(rng.uniform(0.5, 2, 48)),
        f32(rng.normal(1, 0.1, 48)), f32(rng.normal(0, 0.1, 48)),
        rsqrt=False)
    args = (x, kernel, bias, scale, offset)
    return conv_block_plain(*args, compute_dtype="bfloat16_full",
                            out_dtype=torch.bfloat16), args


CASES = {"conv1_block[bf16]": _layer1, "conv_block[bf16_out]": _block}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return CASES[request.param]()


def test_right_numerics_in_another_order_pass(case):
    want, args = case
    got = _stand_in(*args, "nearest")
    ok, worst, crossings = bf16_check(got, want, args[-1])
    assert ok, (worst, crossings)
    assert crossings <= MAX_CROSSING_SHARE * want.numel()


@pytest.mark.parametrize("rounding", ["none", "toward_zero"])
def test_wrong_rounding_fails_by_its_crossings(case, rounding):
    want, args = case
    got = _stand_in(*args, rounding)
    ok, worst, crossings = bf16_check(got, want, args[-1])
    assert not ok
    # Within the one-ulp bound everywhere: the share alone fails it.
    assert worst <= 1.001
    assert crossings > 50 * MAX_CROSSING_SHARE * want.numel()


def _xla_stand_in(x, kernel, bias, scale, offset, rounding, out_dtype):
    """XLA's block recipe with its conv summed in float64 and every bf16
    rounding done by ``rounding``: the accumulator, the bias sum, the BN
    product and (with a bf16 output) the BN sum."""
    r = ROUNDINGS[rounding]
    acc = F.conv2d(x.double().permute(0, 3, 1, 2),
                   kernel.double().permute(3, 2, 0, 1),
                   padding=1).float().permute(0, 2, 3, 1)
    z = torch.relu(r(r(acc) + r(bias.float())))
    m = F.max_pool2d(z.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    y = r(m * r(scale)) + r(offset)
    return r(y).to(torch.bfloat16) if out_dtype == torch.bfloat16 else y


def _xla_layer1():
    """The prod net's folded layer 1 at bfloat16_full (its ``gamma *
    rsqrt`` BN), XLA's numerics: (plain output, kernel arguments)."""
    net, _ = load_default_net("cpu", "bfloat16_full")
    _, bias, scale, offset = net.conv.conv_layers[0].kernel_args()
    kernel = (fold_preprocess(net.state_dict())
              ["conv.conv_layers.0.conv.weight"].permute(2, 3, 1, 0)
              .contiguous().to(torch.bfloat16))
    x = T(np.random.default_rng(0).integers(0, 256, (2, 144, 256, 3),
                                            dtype=np.uint8))
    args = (x, kernel, bias, scale, offset)
    return conv1_block_plain(*args, compute_dtype="bfloat16_full",
                             numerics="xla"), args


def _xla_block(out_dtype):
    def build():
        _, args = _block()
        return conv_block_plain(*args, compute_dtype="bfloat16_full",
                                out_dtype=out_dtype, numerics="xla"), args
    return build


XLA_CASES = {"conv1_block[bf16_xla]": (_xla_layer1, torch.bfloat16),
             "conv_block[bf16_xla]": (_xla_block(torch.bfloat16),
                                      torch.bfloat16),
             "conv_block[bf16_xla_f32]": (_xla_block(torch.float32),
                                          torch.float32)}


@pytest.fixture(scope="module", params=sorted(XLA_CASES))
def xla_case(request):
    build, out_dtype = XLA_CASES[request.param]
    want, args = build()
    return want, args, out_dtype


def _xla_check(got, want, args):
    _, _, bias, scale, offset = args
    return xla_check(got, want, offset, scale, bias)


def test_xla_numerics_in_another_order_pass(xla_case):
    want, args, out_dtype = xla_case
    got = _xla_stand_in(*args, "nearest", out_dtype)
    ok, worst, crossings = _xla_check(got, want, args)
    assert ok, (worst, crossings)


@pytest.mark.parametrize("rounding", ["none", "toward_zero"])
def test_xla_wrong_rounding_fails_by_its_crossings(xla_case, rounding):
    want, args, out_dtype = xla_case
    got = _xla_stand_in(*args, rounding, out_dtype)
    ok, _, crossings = _xla_check(got, want, args)
    assert not ok
    assert crossings > 50 * MAX_CROSSING_SHARE * want.numel()
