"""FrameConvNet / FrameLinearNet.

Counterpart of ``cut_detection_tpu/models/frame_conv.py:44-126`` (the
dense path ``:82-100`` and the ``uint8_chain`` / ``int8_mxu`` path
``:57-80``); reference frameID/net.py:71-189.  Activations between
blocks are f32, bf16 at ``"bfloat16_full"`` and ``"uint8_pool"``, and
codes with a pending affine at ``"uint8_chain"`` (uint8) and
``"int8_mxu"`` (int8), the last block's dequantized to bf16 before the
pool; the adaptive pool reads them as f32, as JAX's type promotion
does.  At ``"bfloat16_full"`` the last block hands the pool its
BN sum in f32 (``ConvBlock.feeds_head``), as the compiled JAX step does.

In train mode (``.train()``) each net runs its blocks' ``forward_train``
and records their new BN running statistics in ``bn_stats``, keyed by
block index, for ``GluedNet.apply_bn_stats``: a forward run twice on
the same input (rematerialized) records the same values, and the
statistics move once a step.  A ``process_group`` (``GluedNet.
set_process_group``) makes those statistics the group's global batch's.

- ``FrameConvNet``: N conv blocks (in_ch -> hidden, then hidden ->
  hidden), adaptive average pooling, and a flatten in NCHW order so the
  linear head's weights line up.
- ``FrameLinearNet``: FC blocks with ReLU + BN, the last one identity
  without BN.
"""

from __future__ import annotations

import torch
from torch import nn

from cut_detection_tpu_torch.config import ConvNetConfig, LinearNetConfig
from cut_detection_tpu_torch.models.layers import (
    ConvBlock,
    FCBlock,
    dequantize_u8,
)
from cut_detection_tpu_torch.ops.nn import adaptive_avg_pool, flatten_nchw_order


# The rungs that chain their blocks with a pending affine and rings.
CHAIN_RUNGS = ("uint8_chain", "int8_mxu")


class FrameConvNet(nn.Module):
    """x: NHWC [B, H, W, C] -> features [B, hidden * pool^2]."""

    def __init__(self, cfg: ConvNetConfig, compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        chans = [cfg.input_channels] + [cfg.hidden_channels] * cfg.n_conv_layers
        last = len(chans) - 2
        self.conv_layers = nn.ModuleList(
            ConvBlock(i, o, compute_dtype, feeds_head=k == last)
            for k, (i, o) in enumerate(zip(chans[:-1], chans[1:])))
        self.compute_dtype = compute_dtype
        self.bn_stats: dict[int, tuple] = {}
        self.process_group = None

    def forward(self, x: torch.Tensor, rings=None) -> torch.Tensor:
        """``rings``: the ``uint8_chain`` or ``int8_mxu`` blocks' constant
        terms from ``assembly.precompute_rings`` of this net; without them
        each block computes its own.  Rings of another net raise."""
        if self.training:
            if rings is not None:
                raise ValueError("rings are for the eval forward")
            for i, layer in enumerate(self.conv_layers):
                x, self.bn_stats[i] = layer.forward_train(
                    x, self.process_group)
        elif self.compute_dtype in CHAIN_RUNGS:
            if rings is None:
                rings = [None] * len(self.conv_layers)
            elif getattr(rings, "source", None) is not self:
                raise ValueError(
                    "rings were precomputed from another net's weights; "
                    "precompute them from this one (assembly."
                    "precompute_rings)")
            block = (ConvBlock.forward_i8_chain
                     if self.compute_dtype == "int8_mxu"
                     else ConvBlock.forward_u8_chain)
            affine = None
            for layer, ring in zip(self.conv_layers, rings):
                x, affine = block(layer, x, affine, ring)
            return self.head(x, affine)
        elif rings is not None:
            raise ValueError(f"rings are uint8_chain's and int8_mxu's; this "
                             f"net runs {self.compute_dtype}")
        else:
            for layer in self.conv_layers:
                x = layer(x)
        return self.head(x)

    def head(self, x: torch.Tensor, affine=None) -> torch.Tensor:
        """The last block's output -> features: the chained rungs' codes
        dequantized with their pending ``affine`` first, then the adaptive
        pool and the flatten in NCHW order."""
        if affine is not None:
            # int8 codes too: their affine's offset holds the +128 * a.
            x = dequantize_u8(x, affine)
        x = adaptive_avg_pool(x.float(), self.cfg.average_pool_size)
        return flatten_nchw_order(x)


class FrameLinearNet(nn.Module):
    """x: [B, input_size] -> [B, output_size]."""

    def __init__(self, cfg: LinearNetConfig, compute_dtype=None):
        super().__init__()
        sizes = cfg.layer_sizes()
        last = len(sizes) - 1
        self.layers = nn.ModuleList(
            FCBlock(i, o, hidden=k != last, compute_dtype=compute_dtype)
            for k, (i, o) in enumerate(sizes))
        self.bn_stats: dict[int, tuple] = {}
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if self.training:
                x, stats = layer.forward_train(x, self.process_group)
                if stats is not None:  # the last layer has no BN
                    self.bn_stats[i] = stats
            else:
                x = layer(x)
        return x
