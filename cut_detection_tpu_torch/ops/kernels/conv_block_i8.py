"""The ``int8_mxu`` block: the int8 instances of ``csrc/conv_block.cu``.

int8 x int8 -> int32 conv3x3 (zero pad 1) -> ``z = zi * so + ring`` ->
ReLU -> ``clip(rint(z / scale) - 128, -128, 127)`` int8 codes -> max
pool 3x3/3 (floor).  The JAX package leaves this block to XLA
(``cut_detection_tpu/models/layers.py:229-280``, the conv
``cut_detection_tpu/ops/nn.py:73``, ``conv2d_same_i8``): no Pallas
kernel lies behind it, and PyTorch has no int8 convolution with int32
sums on CUDA, so the card runs hand-written kernels, the int8 instances
of the block kernel's two tensor-core routes (s8 ``wgmma``, exact int32
sums).  Two entry points, two rows of the kernel table:

- ``conv1_block_i8``: layer 1 from raw uint8 BGR ``[B, H, W, 3]``, as
  int8 after a shift by -128 (the shift's constant 128 is in the ring),
  on layer 1's route (``conv1_block_mma``);
- ``conv_block_i8``: the previous block's int8 codes ``[B, H, W, Cin]``,
  on the mid-stack route (``conv_block_mma``).

``kernel`` is the HWIO int8 kernel and ``so`` its per-output-channel
scale (``ops.nn.quantize_kernel_i8`` of the kernel with the pending
affine's scale folded in); ``scale`` the block's activation scale
(``models.layers.conv_quantize_scale``); ``ring`` the constant term as a
strip f32 ``[3, W, Cout]``: the top row, any interior row and the bottom
row of the ``[H, W, Cout]`` canvas that ``const_conv_ring`` builds
(``ring_canvas`` builds it back).

The plain version computes the sums with ``ops.nn.conv2d_same_i8_plain``
(float32 im2col, exact) and the epilogue in torch ops, quantizing each
conv pixel before the pool; the kernel pools ``z`` first (ReLU and the
quantization are nondecreasing) and rounds the same IEEE operations, so
the two agree with a max diff of 0.  What bounds it on an H100, and the
design: see the .cu header.  Each wrapper's ``launches`` counts its
kernel launches.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops.kernels import _build
from cut_detection_tpu_torch.ops.nn import conv2d_same_i8_plain, max_pool

__all__ = ["conv1_block_i8", "conv1_block_i8_plain", "conv_block_i8",
           "conv_block_i8_plain", "quantize_pool_i8", "ring_canvas"]


def ring_canvas(strip: torch.Tensor, h: int) -> torch.Tensor:
    """The ``[1, h, W, C]`` canvas of a ring strip ``[3, W, C]`` (``h >=
    3``): row 0, ``h - 2`` copies of row 1, row 2."""
    mid = strip[1:2].expand(h - 2, *strip.shape[1:])
    return torch.cat([strip[0:1], mid, strip[2:3]]).unsqueeze(0)


def quantize_pool_i8(z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Post-ReLU activation ``z`` -> int8 codes ``clip(rint(z / scale) -
    128, -128, 127)``, max-pooled 3x3/3 (floor).  ``torch.round`` rounds
    half to even, as ``jnp.rint``; the codes are pooled as exact f32
    integers.  ``z`` may be bf16 (the dense layer 1), promoted to f32 by
    the division as JAX promotes it."""
    q = z / scale
    q.round_().sub_(128.0).clamp_(-128.0, 127.0)
    return max_pool(q, 3).to(torch.int8)


def _block_plain(x_i8, kernel, so, ring, scale):
    b, h, w, _ = x_i8.shape
    cout = kernel.shape[-1]
    out = torch.empty((b, h // 3, w // 3, cout), dtype=torch.int8,
                      device=x_i8.device)
    if h < 3 or w < 3:
        return out
    canvas = ring_canvas(ring.float(), h)
    # A few frames at a time: layer 1's float32 im2col columns take 4 MB a
    # frame and its f32 activations 7 MB.  The epilogue works in place on
    # one f32 buffer a chunk (the same IEEE operations): a fresh buffer an
    # operation made it several times slower on the CPU.
    chunk = 32
    for lo in range(0, b, chunk):
        z = conv2d_same_i8_plain(x_i8[lo:lo + chunk], kernel).float()
        z.mul_(so).add_(canvas).relu_()
        out[lo:lo + chunk] = quantize_pool_i8(z, scale)
    return out


def conv1_block_i8_plain(x_u8, kernel, so, ring, scale):
    """Plain version of ``conv1_block_i8``: the frames shifted to int8 by
    -128, then ``conv_block_i8_plain``."""
    return _block_plain((x_u8.to(torch.int32) - 128).to(torch.int8), kernel,
                        so, ring, scale)


def conv_block_i8_plain(x_i8, kernel, so, ring, scale):
    """Plain version of ``conv_block_i8``: exact int32 sums
    (``conv2d_same_i8_plain``), ``z = zi * so + ring``, ReLU, the codes of
    every conv pixel, then the max pool."""
    return _block_plain(x_i8, kernel, so, ring, scale)


def _launch(entry, x, kernel, so, ring, scale, *, cin_words: bool):
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    dev = x.device
    out = torch.empty((b, h // 3, w // 3, cout), dtype=torch.int8,
                      device=dev)
    if b == 0 or h < 3 or w < 3:
        return out, False  # no pool window: nothing to launch
    # The mid-stack route stores four channels' codes as one word and
    # reads the ring, so and scale as float4 (the .cu's Cout % 4 == 0).
    if cout % 4:
        raise ValueError(f"{entry} needs a multiple of 4 output channels, "
                         f"got {cout}")
    if cin_words and cin % 4:
        raise ValueError(f"{entry} needs a multiple of 4 input channels, "
                         f"got {cin}")
    _build.expect(kernel, "kernel", torch.int8, (3, 3, cin, cout), dev)
    _build.expect(ring, "ring", torch.float32, (3, w, cout), dev)
    for pname, t in (("so", so), ("scale", scale)):
        _build.expect(t, pname, torch.float32, (cout,), dev)
    # float4 loads of the ring, so and scale; int loads of int8 x.
    for pname, t, align in (("ring", ring, 16), ("so", so, 16),
                            ("scale", scale, 16), ("x", x, 4)):
        if t.data_ptr() % align:
            raise ValueError(f"{entry}: {pname} must be {align}-byte "
                             "aligned")
    args = (x.data_ptr(), kernel.data_ptr(), so.data_ptr(), ring.data_ptr(),
            scale.data_ptr(), out.data_ptr(), b, h, w)
    lib = _build.library()
    if cin_words:
        rc = _build.launch(lib.cutdet_conv_block_i8, dev, *args, cin, cout)
    else:
        rc = _build.launch(lib.cutdet_conv1_block_i8, dev, *args, cout)
    _build.check(rc, f"{entry} launch")
    return out, True


def conv1_block_i8(x_u8, kernel, so, ring, scale):
    """Layer 1 of ``int8_mxu`` from raw pixels: uint8 ``[B, H, W, 3]``
    BGR -> int8 ``[B, H//3, (W-3)//3+1, Cout]``; the plain version on the
    CPU, the kernel on CUDA.  ``kernel``: int8 HWIO ``[3, 3, 3, Cout]``
    of the preprocess-folded weights."""
    if x_u8.device.type == "cpu":
        return conv1_block_i8_plain(x_u8, kernel, so, ring, scale)
    if x_u8.device.type != "cuda":
        raise ValueError(f"conv1_block_i8: unsupported device {x_u8.device}")
    if x_u8.dim() != 4 or x_u8.shape[3] != 3:
        raise ValueError(f"conv1_block_i8 takes [B, H, W, 3] frames, got "
                         f"{tuple(x_u8.shape)}")
    _build.expect(x_u8, "x", torch.uint8, tuple(x_u8.shape), x_u8.device)
    out, launched = _launch("conv1_block_i8", x_u8, kernel, so, ring,
                            scale, cin_words=False)
    conv1_block_i8.launches += launched
    return out


def conv_block_i8(x_i8, kernel, so, ring, scale):
    """A mid-stack block of ``int8_mxu``: int8 ``[B, H, W, Cin]`` codes
    (``Cin % 4 == 0``) -> int8 ``[B, H//3, (W-3)//3+1, Cout]``; the plain
    version on the CPU, the kernel on CUDA."""
    if x_i8.device.type == "cpu":
        return conv_block_i8_plain(x_i8, kernel, so, ring, scale)
    if x_i8.device.type != "cuda":
        raise ValueError(f"conv_block_i8: unsupported device {x_i8.device}")
    if x_i8.dim() != 4:
        raise ValueError(f"conv_block_i8 takes NHWC [B, H, W, C], got "
                         f"{tuple(x_i8.shape)}")
    _build.expect(x_i8, "x", torch.int8, tuple(x_i8.shape), x_i8.device)
    out, launched = _launch("conv_block_i8", x_i8, kernel, so, ring,
                            scale, cin_words=True)
    conv_block_i8.launches += launched
    return out


conv1_block_i8.launches = 0
conv_block_i8.launches = 0
