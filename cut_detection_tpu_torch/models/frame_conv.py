"""FrameConvNet / FrameLinearNet, eval mode.

Counterpart of ``cut_detection_tpu/models/frame_conv.py:44-126`` (the
dense path, ``:82-100``); reference frameID/net.py:71-189.  Activations
between blocks are f32, or bf16 at ``"bfloat16_full"``; the adaptive pool
reads them as f32, as JAX's type promotion does.

- ``FrameConvNet``: N conv blocks (in_ch -> hidden, then hidden ->
  hidden), adaptive average pooling, and a flatten in NCHW order so the
  linear head's weights line up.
- ``FrameLinearNet``: FC blocks with ReLU + BN, the last one identity
  without BN.
"""

from __future__ import annotations

import torch
from torch import nn

from cut_detection_tpu.config import ConvNetConfig, LinearNetConfig
from cut_detection_tpu_torch.models.layers import ConvBlock, FCBlock
from cut_detection_tpu_torch.ops.nn import adaptive_avg_pool, flatten_nchw_order


class FrameConvNet(nn.Module):
    """x: NHWC [B, H, W, C] -> features [B, hidden * pool^2]."""

    def __init__(self, cfg: ConvNetConfig, compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        chans = [cfg.input_channels] + [cfg.hidden_channels] * cfg.n_conv_layers
        self.conv_layers = nn.ModuleList(
            ConvBlock(i, o, compute_dtype)
            for i, o in zip(chans[:-1], chans[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
