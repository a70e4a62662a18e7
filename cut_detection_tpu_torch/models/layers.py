"""Building-block layers: the CNN block and the FC block, eval mode.

Counterpart of ``cut_detection_tpu/models/layers.py:77-123, 302-323``.
Reference order (frameID/net.py:33-40, 62-68):

- ``ConvBlock``: conv3x3 (pad 1) -> ReLU -> maxpool 3/3 -> BatchNorm2d;
- ``FCBlock``: linear -> ReLU -> BatchNorm1d for hidden layers, linear
  alone for the final layer (net.py:164-167).

Parameters sit in ``nn.Conv2d`` / ``nn.Linear`` / ``nn.BatchNorm*``
holders so the state dict has the reference's own keys; the forward
passes never call those modules — the conv block runs one fused kernel.
Activations are NHWC, as in the JAX package.

``compute_dtype`` is the net's precision rung, as in the JAX blocks:
``None`` (float32), ``"bfloat16"`` (bf16 operands, f32 activations) or
``"bfloat16_full"`` (bf16 operands and activations, at the numerics of
the Pallas kernels K1 and K3, whose instances run here).
"""

from __future__ import annotations

import torch
from torch import nn

from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block
from cut_detection_tpu_torch.ops.nn import (
    BN_EPS,
    batch_norm_infer,
    bf16_round,
    bn_scale_offset,
    linear,
)


class ConvBlock(nn.Module):
    """One CNNLayer, eval mode, as one fused kernel launch.

    A uint8 input is raw BGR with a preprocess-folded kernel
    (``assembly.fold_preprocess``) and goes to ``conv1_block``; a float
    input goes to ``conv_block``.  The instance follows
    ``compute_dtype``:

    - ``None``: the f32 instances;
    - ``"bfloat16"``: the f32 ``conv1_block`` on weights rounded to bf16
      (uint8 pixels are exact in bf16), then the ``bf16_operands``
      instance of ``conv_block``;
    - ``"bfloat16_full"``: the ``bf16`` instance of ``conv1_block`` (K1),
      then ``bf16_out`` instances of ``conv_block`` (K3) on bf16
      activations; a float input is rounded to bf16 first, as the JAX
      op rounds it.
    """

    def __init__(self, in_ch: int, out_ch: int, compute_dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.compute_dtype = compute_dtype
        self._frozen = None

    def kernel_args(self):
        """(HWIO kernel, bias, BN scale, BN offset) for the block kernels:
        the ones ``freeze`` stored, else computed from the parameters.
        The kernel is bf16 at ``"bfloat16_full"`` and rounded to bf16 (as
        f32) at ``"bfloat16"``; the BN scale is K1's and K3's ``gamma /
        sqrt(var + eps)`` at ``"bfloat16_full"``, else ``gamma *
        rsqrt(var + eps)`` as ``batch_norm_infer``."""
        if self._frozen is not None:
            return self._frozen
        bn = self.bn
        full = self.compute_dtype == "bfloat16_full"
        scale, offset = bn_scale_offset(bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias, rsqrt=not full)
        kernel = self.conv.weight.permute(2, 3, 1, 0).contiguous()
        if full:
            kernel = kernel.to(torch.bfloat16)
        elif self.compute_dtype == "bfloat16":
            kernel = bf16_round(kernel)
        return kernel, self.conv.bias, scale, offset

    def freeze(self) -> None:
        """Compute the kernel arguments once for every later call.  Only
        for a block whose weights and device are final, such as the
        classify step's private copy: later changes are not seen."""
        self._frozen = None
        self._frozen = self.kernel_args()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = self.kernel_args()
        full = self.compute_dtype == "bfloat16_full"
        if x.dtype == torch.uint8:
            return conv1_block(x.contiguous(), *args,
                               compute_dtype="bfloat16_full" if full
                               else None)
        if full:
            return conv_block(x.to(torch.bfloat16).contiguous(), *args,
                              compute_dtype="bfloat16_full",
                              out_dtype=torch.bfloat16)
        return conv_block(x.contiguous(), *args,
                          compute_dtype=self.compute_dtype)


class FCBlock(nn.Module):
    """Hidden: linear -> ReLU -> eval BN.  Final: linear alone.  With a
    ``compute_dtype`` the linear's operands are rounded to bf16 (the
    result stays f32, as in the JAX package at both bf16 rungs)."""

    def __init__(self, in_f: int, out_f: int, *, hidden: bool,
                 compute_dtype=None):
        super().__init__()
        self.linear = nn.Linear(in_f, out_f)
        self.bn = nn.BatchNorm1d(out_f, eps=BN_EPS) if hidden else None
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.linear.weight.t(), self.linear.bias,
                   compute_dtype=self.compute_dtype)
        if self.bn is None:
            return x
        return batch_norm_infer(torch.relu(x), self.bn.running_mean,
                                self.bn.running_var, self.bn.weight,
                                self.bn.bias)
