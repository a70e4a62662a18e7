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
"""

from __future__ import annotations

import torch
from torch import nn

from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
from cut_detection_tpu_torch.ops.kernels.conv_block import conv_block
from cut_detection_tpu_torch.ops.nn import (
    BN_EPS,
    batch_norm_infer,
    bn_scale_offset,
    linear,
)


class ConvBlock(nn.Module):
    """One CNNLayer, eval mode, as one fused kernel launch.

    A uint8 input is raw BGR with a preprocess-folded kernel
    (``assembly.fold_preprocess``) and goes to ``conv1_block``; a float32
    input goes to the f32 instance of ``conv_block``.
    """

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self._frozen = None

    def kernel_args(self):
        """(HWIO kernel, bias, BN scale, BN offset) for the block kernels:
        the ones ``freeze`` stored, else computed from the parameters."""
        if self._frozen is not None:
            return self._frozen
        bn = self.bn
        scale, offset = bn_scale_offset(bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias)
        return (self.conv.weight.permute(2, 3, 1, 0).contiguous(),
                self.conv.bias, scale, offset)

    def freeze(self) -> None:
        """Compute the kernel arguments once for every later call.  Only
        for a block whose weights and device are final, such as the
        classify step's private copy: later changes are not seen."""
        self._frozen = None
        self._frozen = self.kernel_args()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if x.dtype == torch.uint8:
            return conv1_block(x, *self.kernel_args())
        return conv_block(x, *self.kernel_args())


class FCBlock(nn.Module):
    """Hidden: linear -> ReLU -> eval BN.  Final: linear alone."""

    def __init__(self, in_f: int, out_f: int, *, hidden: bool):
        super().__init__()
        self.linear = nn.Linear(in_f, out_f)
        self.bn = nn.BatchNorm1d(out_f, eps=BN_EPS) if hidden else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.linear.weight.t(), self.linear.bias)
        if self.bn is None:
            return x
        return batch_norm_infer(torch.relu(x), self.bn.running_mean,
                                self.bn.running_var, self.bn.weight,
                                self.bn.bias)
