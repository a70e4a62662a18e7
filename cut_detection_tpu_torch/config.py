"""Configuration the port reads: the precision ladder and the checkpoint
sidecar (``*_model_params.json``).

Copy of the names the port calls from ``cut_detection_tpu/config.py``
(``PRECISION_CHOICES`` ``:29``, ``ConvNetConfig`` ``:33``,
``LinearNetConfig`` ``:48``, ``ModelParams`` ``:67``); the JSON key names
and their meaning are the reference's (frameID/net.py:195-211), so a
sidecar written by either package reads the same here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# Inference precision ladder, slowest/strictest first: float32 guarantees
# byte-identical reference CSVs; bfloat16 runs bf16 operands with f32
# activations; bfloat16_full also stores activations bf16; uint8_pool
# quantizes the post-ReLU conv activation to uint8 before the pool;
# uint8_chain also keeps the inter-layer pooled activations uint8, folding
# the dequant + BN affine into the next conv's weights; int8_mxu runs the
# convs int8 x int8 -> int32 (not ported yet).
PRECISION_CHOICES = ("float32", "bfloat16", "bfloat16_full", "uint8_pool",
                     "uint8_chain", "int8_mxu")


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    """Mirrors FrameConvNet's constructor (frameID/net.py:77-79 defaults)."""

    input_channels: int = 3
    hidden_channels: int = 32
    n_conv_layers: int = 3
    average_pool_size: int = 1


@dataclasses.dataclass(frozen=True)
class LinearNetConfig:
    """Mirrors FrameLinearNet's constructor (frameID/net.py:146-152
    defaults).  Layer ``i`` has ReLU + BatchNorm1d except the final layer,
    which is identity activation with no norm (net.py:164-167)."""

    n_layers: int = 3
    input_size: int = 32
    hidden_size: int = 32
    output_size: int = 8

    def layer_sizes(self) -> list[tuple[int, int]]:
        ins = [self.input_size] + [self.hidden_size] * (self.n_layers - 1)
        outs = [self.hidden_size] * (self.n_layers - 1) + [self.output_size]
        return list(zip(ins, outs))


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """The checkpoint sidecar (``*_model_params.json``) contract.

    Field names match the JSON keys written by supervised_training.py:228-245
    and read by net.py:195-211.  Training fields are informational.
    """

    conv_layers: int = 3
    conv_channels: int = 48
    avg_pool_size: int = 4
    linear_layers: int = 2
    linear_size: int = 32
    linear_output_size: int = 3
    data_size: int | None = None
    batch_size: int | None = None
    epochs: int | None = None

    @classmethod
    def from_json(cls, path: str) -> "ModelParams":
        with open(path, "r") as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    def conv_config(self) -> ConvNetConfig:
        return ConvNetConfig(
            input_channels=3,
            hidden_channels=self.conv_channels,
            n_conv_layers=self.conv_layers,
            average_pool_size=self.avg_pool_size,
        )

    def linear_config(self) -> LinearNetConfig:
        # input_size rule from net.py:208.
        return LinearNetConfig(
            n_layers=self.linear_layers,
            input_size=self.conv_channels * self.avg_pool_size ** 2,
            hidden_size=self.linear_size,
            output_size=self.linear_output_size,
        )
