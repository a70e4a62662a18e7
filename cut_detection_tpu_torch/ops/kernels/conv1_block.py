"""Layer-1 CNN block from raw uint8 BGR: ``csrc/conv1_block.cu``.

Replaces the Pallas kernel ``conv1_pool_fused``
(``cut_detection_tpu/ops/pallas/conv1_kernel.py:97``), float32 instance:
conv3x3 (zero pad 1) + bias -> ReLU -> maxpool 3x3/3 (floor) -> eval BN,
with f32 pixels, weights, accumulation and output.  Pass the
preprocess-folded kernel (``models.assembly.fold_preprocess``) so raw BGR
pixels are the input.

What bounds it on an H100: a 144x256 frame is ~110 KB of uint8 in and
~0.78 MB of pooled f32 out, but 27*48 MACs per conv pixel — about 100
FLOP per byte, so the f32 CUDA cores bound it, not memory.  The fused
kernel keeps the [144,256,48] f32 conv output (7 MB per frame) out of
device memory; the simple design stages a pooled row's five input rows
in shared memory, holds each channel's 27 weights in registers and
feeds nine FMAs from five staged pixels (see the .cu header).

The BN affine is ``s = gamma * rsqrt(var + eps)``, ``t = beta - mean*s``
(``ops.nn.bn_scale_offset``), as in the Pallas kernel and
``batch_norm_infer``.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops import nn
from cut_detection_tpu_torch.ops.kernels import _build


def conv1_block_plain(x_u8, kernel, bias, scale, offset):
    """Plain PyTorch version: uint8 NHWC [B,H,W,Cin] -> f32
    [B, H//3, (W-3)//3+1, Cout]."""
    z = torch.relu(nn.conv2d_same(x_u8.float(), kernel, bias))
    return nn.max_pool(z, 3) * scale + offset


def conv1_block(x_u8, kernel, bias, scale, offset):
    """The fused layer-1 block: plain version on the CPU, kernel on CUDA.

    ``x_u8``: uint8 [B, H, W, 3] NHWC (H, W >= 3); ``kernel``: f32 HWIO
    [3, 3, 3, Cout]; ``bias``, ``scale``, ``offset``: f32 [Cout].
    """
    if x_u8.device.type == "cpu":
        return conv1_block_plain(x_u8, kernel, bias, scale, offset)
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
    _build.expect(kernel, "kernel", torch.float32, (3, 3, cin, cout), dev)
    for name, t in (("bias", bias), ("scale", scale), ("offset", offset)):
        _build.expect(t, name, torch.float32, (cout,), dev)
    out = torch.empty((b, h // 3, (w - 3) // 3 + 1, cout),
                      dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.library()
    rc = lib.cutdet_conv1_block(
        x_u8.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
        scale.data_ptr(), offset.data_ptr(), out.data_ptr(), b, h, w, cout,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "conv1_block launch")
    conv1_block.launches += 1
    return out


conv1_block.launches = 0
