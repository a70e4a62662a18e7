"""Layer-1 CNN block from raw uint8 BGR: ``csrc/conv_block.cu``'s uint8
instances (``cutdet_conv1_block*``).

conv3x3 (zero pad 1) + bias -> ReLU -> maxpool 3x3/3 (floor) -> eval BN,
from raw pixels: pass the preprocess-folded kernel
(``models.assembly.fold_preprocess``).  Three instances, chosen by
``compute_dtype`` and, at ``"bfloat16_full"``, ``numerics``:

- ``f32`` (``None``) replaces the Pallas kernel ``conv1_pool_fused``
  (``cut_detection_tpu/ops/pallas/conv1_kernel.py:97``): f32 pixels,
  weights, accumulation and output.  The ``bfloat16`` rung runs it too,
  on weights rounded to bf16: uint8 pixels are exact in bf16, so that is
  the rung's own numerics.
- ``bf16_xla`` (``"bfloat16_full"``, ``numerics="xla"``): the JAX
  package's ``bfloat16_full`` rung as XLA computes layer 1 (the same
  recipe as ``conv_block[bf16_xla]``: a bf16 rounding after the
  accumulator, the bias sum and each BN op) — the port's folded layer 1
  at that rung.
- ``bf16`` (``"bfloat16_full"``, ``numerics="pallas"``) replaces K1,
  ``fused_conv1_pool``
  (``cut_detection_tpu/ops/pallas/fused_conv1.py:174``): bf16 weights,
  f32 accumulation, ``relu(acc + bias)`` rounded to bf16 before the
  pool, the BN affine in f32 and a bf16 NHWC output (K1's
  ``out_dtype=bfloat16, nhwc_out=True``).  Unlike K1, any H >= 3.

What bounds it on an H100: a 144x256 frame is ~110 KB of uint8 in and
~0.78 MB of pooled f32 out (half in bf16), for 27*48 MACs per conv pixel.
In f32 the CUDA cores bound it (~0.18 ms a batch of 128); in bf16 on the
tensor cores its bytes do (~0.02 ms), and its 6,144 (pooled row, frame)
items a batch, 9x layer 2's outputs, make staging and the pool the work
to hide.  ``f32`` runs ``conv_block``'s CUDA-core route with exactly 3
input channels: a thread holds one pool window's 5x5x3 pixels in
registers and walks the output channels four at a time.  ``bf16`` and
``bf16_xla`` run ``wgmma`` with the three dx taps packed into the 16 k
of a step (3 k steps, one per dy, instead of 9), the output channels on
M (weights in registers) and 8 pool windows' conv pixels on N, ordered
so that each thread pools its own accumulators.  The fused kernel keeps
the [144,256,48] conv output (7 MB per frame in f32) out of device
memory (see the .cu header).

The BN affine is computed by the caller: ``s = gamma * rsqrt(var +
eps)`` (``ops.nn.bn_scale_offset``) for ``conv1_pool_fused`` and
``bf16_xla``, ``gamma / sqrt(var + eps)`` (``rsqrt=False``) for K1.
``launches`` counts every launch; ``instance_launches`` counts them by
instance name.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops.kernels import _build
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    conv_block_plain,
    key,
)

# (compute_dtype, numerics) -> (instance name, kernel dtype, output
# dtype); ``numerics`` as in ``conv_block.INSTANCES``.
INSTANCES = {
    (None, None): ("f32", torch.float32, torch.float32),
    ("bfloat16_full", "xla"): ("bf16_xla", torch.bfloat16, torch.bfloat16),
    ("bfloat16_full", "pallas"): ("bf16", torch.bfloat16, torch.bfloat16),
}


def instance(compute_dtype, numerics="pallas"):
    """(instance name, kernel dtype, output dtype) of a combination; raise
    for one that has no kernel."""
    k = key(compute_dtype, numerics=numerics)
    try:
        return INSTANCES[(k[0], k[2])]
    except KeyError:
        raise ValueError(f"conv1_block has no instance for compute_dtype="
                         f"{compute_dtype!r}") from None


def conv1_block_plain(x_u8, kernel, bias, scale, offset, *,
                      compute_dtype=None, numerics="pallas"):
    """Plain PyTorch version: uint8 NHWC [B,H,W,Cin] -> [B, H//3,
    (W-3)//3+1, Cout], f32, or bf16 at ``"bfloat16_full"``: the mid-stack
    block's plain version on the pixels as floats."""
    return conv_block_plain(x_u8, kernel, bias, scale, offset,
                            compute_dtype=compute_dtype,
                            out_dtype=instance(compute_dtype, numerics)[2],
                            numerics=numerics)


def conv1_block(x_u8, kernel, bias, scale, offset, *, compute_dtype=None,
                numerics="pallas"):
    """The fused layer-1 block: plain version on the CPU, kernel on CUDA.

    ``x_u8``: uint8 [B, H, W, 3] NHWC (H, W >= 3); ``kernel``: HWIO
    [3, 3, 3, Cout], f32, or bf16 at ``"bfloat16_full"``; ``bias``,
    ``scale``, ``offset``: f32 [Cout].
    """
    name, kdtype, out_dtype = instance(compute_dtype, numerics)
    if x_u8.device.type == "cpu":
        return conv1_block_plain(x_u8, kernel, bias, scale, offset,
                                 compute_dtype=compute_dtype,
                                 numerics=numerics)
    if x_u8.device.type != "cuda":
        raise ValueError(f"conv1_block: unsupported device {x_u8.device}")
    if x_u8.dim() != 4 or x_u8.shape[3] != 3:
        raise ValueError(f"conv1_block takes [B, H, W, 3] frames, got "
                         f"{tuple(x_u8.shape)}")
    b, h, w, cin = x_u8.shape
    if h < 3 or w < 3:
        raise ValueError(f"conv1_block needs H, W >= 3, got {h}x{w}")
    cout = kernel.shape[-1]
    dev = x_u8.device
    _build.expect(x_u8, "x", torch.uint8, (b, h, w, cin), dev)
    _build.expect(kernel, "kernel", kdtype, (3, 3, cin, cout), dev)
    for pname, t in (("bias", bias), ("scale", scale), ("offset", offset)):
        _build.expect(t, pname, torch.float32, (cout,), dev)
    out = torch.empty((b, h // 3, (w - 3) // 3 + 1, cout), dtype=out_dtype,
                      device=dev)
    if b == 0:
        return out
    fn = getattr(_build.library(), "cutdet_conv1_block" if name == "f32"
                 else f"cutdet_conv1_block_{name}")
    rc = fn(x_u8.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), out.data_ptr(), b, h, w,
            cout, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "conv1_block launch")
    conv1_block.launches += 1
    conv1_block.instance_launches[name] += 1
    return out


conv1_block.launches = 0
conv1_block.instance_launches = {name: 0 for name, _, _ in INSTANCES.values()}
