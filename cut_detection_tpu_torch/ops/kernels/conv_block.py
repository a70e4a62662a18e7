"""Mid-stack CNN block, NHWC: ``csrc/conv_block.cu``.

Replaces the Pallas kernel ``fused_conv_block_pm``
(``cut_detection_tpu/ops/pallas/fused_block_pm.py:112``): conv3x3 (zero
pad 1) + bias -> ReLU -> maxpool 3x3/3 (floor, any H) -> eval-BN affine.
One CUDA source, two instances:

- ``bf16=False``: true f32 operands and accumulation — the float32 path
  (layers 2 and 3 of the prod net, and layer 1 of an unfolded net);
- ``bf16=True``: the Pallas kernel's numerics — operands rounded to
  bf16, f32 accumulation, ``relu(acc + bias)`` rounded to bf16 before
  the pool, f32 output (its ``out_dtype=float32``).

What bounds it on an H100: the prod layer-2 shape (48x85x48 in) costs
~84 M MAC per frame against ~0.8 MB of f32 input — the f32 CUDA cores,
not memory.  The simple design stages a 5 x 26 x Cin input window per
block in shared memory and keeps the nine conv outputs under each pool
window in registers (see the .cu header); ``wgmma`` on bf16 is later work.

``scale`` and ``offset`` are the BN affine, computed by the caller: the
float32 path uses ``ops.nn.bn_scale_offset`` (``gamma * rsqrt``, as
``batch_norm_infer``); the Pallas kernel computes ``gamma / sqrt``.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.ops import nn
from cut_detection_tpu_torch.ops.kernels import _build


def _bf16_round(t):
    return t.to(torch.bfloat16).float()


def conv_block_plain(x, kernel, bias, scale, offset, *, bf16: bool = False):
    """Plain PyTorch version: NHWC [B,H,W,Cin] -> f32
    [B, H//3, (W-3)//3+1, Cout].  With ``bf16`` the operands and the
    post-ReLU activation are rounded to bf16; a product of two bf16
    values is exact in f32, so the f32 convolution then accumulates
    exactly what the kernel accumulates."""
    x = x.float()
    if bf16:
        x, kernel = _bf16_round(x), _bf16_round(kernel)
    z = torch.relu(nn.conv2d_same(x, kernel, bias))
    if bf16:
        z = _bf16_round(z)
    return nn.max_pool(z, 3) * scale + offset


def conv_block(x, kernel, bias, scale, offset, *, bf16: bool = False):
    """The fused mid-stack block: plain version on the CPU, kernel on CUDA.

    ``x``: f32 [B, H, W, Cin] NHWC (H, W >= 3), or bf16 with ``bf16``;
    ``kernel``: HWIO [3, 3, Cin, Cout] in the same dtype as ``x``;
    ``bias``, ``scale``, ``offset``: f32 [Cout].
    """
    if x.device.type == "cpu":
        return conv_block_plain(x, kernel, bias, scale, offset, bf16=bf16)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"conv_block takes NHWC [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    b, h, w, cin = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"conv_block needs H, W >= 3, got {h}x{w}")
    cout = kernel.shape[-1]
    if cout * 8 > 1024:
        raise ValueError(f"conv_block supports up to 128 output channels, "
                         f"got {cout}")
    dev = x.device
    dtype = torch.bfloat16 if bf16 else torch.float32
    _build.expect(x, "x", dtype, (b, h, w, cin), dev)
    _build.expect(kernel, "kernel", dtype, (3, 3, cin, cout), dev)
    for name, t in (("bias", bias), ("scale", scale), ("offset", offset)):
        _build.expect(t, name, torch.float32, (cout,), dev)
    out = torch.empty((b, h // 3, (w - 3) // 3 + 1, cout),
                      dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.library()
    fn = lib.cutdet_conv_block_bf16 if bf16 else lib.cutdet_conv_block_f32
    rc = fn(x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), out.data_ptr(), b, h, w,
            cin, cout, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "conv_block launch")
    conv_block.launches += 1
    return out


conv_block.launches = 0
