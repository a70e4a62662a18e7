"""Model assembly: conv backbone + FC head as one eval-mode module.

Counterpart of ``cut_detection_tpu/models/assembly.py`` (``GluedNet``
``:38-119``, ``fold_preprocess`` ``:140-157``, ``folded_input``
``:160-170``, the loaders ``:243-285, 307-327``); reference
frameID/net.py:193-233.  The precision rungs ``float32``, ``bfloat16``
and ``bfloat16_full`` are ported (``PORTED_PRECISIONS``); the quantized
rungs are not yet (ROADMAP.md), and the CLI refuses them.
"""

from __future__ import annotations

import os

import torch
from torch import nn

import cut_detection_tpu
from cut_detection_tpu.checkpoint.io import load_bundle
from cut_detection_tpu.config import ModelParams
from cut_detection_tpu_torch.checkpoint.convert import params_from_jax
from cut_detection_tpu_torch.models.frame_conv import (
    FrameConvNet,
    FrameLinearNet,
)

PORTED_PRECISIONS = ("float32", "bfloat16", "bfloat16_full")

# The bundled prod classifier ships inside the JAX package.
_PROD_NET_DIR = os.path.join(os.path.dirname(cut_detection_tpu.__file__),
                             "prod_net")


class GluedNet(nn.Module):
    """Conv backbone + FC head (frameID/net.py:215), eval mode.

    ``net(x)`` takes NHWC float32 frames in [0, 1] (RGB) and returns
    ``[B, n_class]`` f32 logits.  BN uses the checkpoint's running
    statistics.  A net loaded with a ``fold_preprocess``'d state dict takes
    raw uint8 BGR frames instead (``folded_input``).  ``precision`` is a
    property of the net, not of its weights: the same state dict loads at
    every rung.
    """

    def __init__(self, model_params: ModelParams,
                 precision: str = "float32"):
        super().__init__()
        if precision not in PORTED_PRECISIONS:
            raise ValueError(f"precision {precision!r} is not yet ported "
                             f"(ported: {', '.join(PORTED_PRECISIONS)})")
        self.model_params = model_params
        self.precision = precision
        self.conv = FrameConvNet(model_params.conv_config(),
                                 self.compute_dtype)
        self.linear = FrameLinearNet(model_params.linear_config(),
                                     self.compute_dtype)
        self.eval()
        self.requires_grad_(False)

    @property
    def compute_dtype(self):
        """None (float32), ``"bfloat16"`` (bf16 operands, f32
        activations) or ``"bfloat16_full"`` (bf16 operands and
        activations), as the JAX ``GluedNet`` names them."""
        return None if self.precision == "float32" else self.precision

    @property
    def device(self) -> torch.device:
        return self.conv.conv_layers[0].conv.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.conv(x))

    def num_params(self) -> int:
        """Trainable parameter count (BN running stats excluded)."""
        return sum(p.numel() for p in self.parameters())

    def __repr__(self) -> str:
        mp = self.model_params
        return (f"GluedNet(conv={mp.conv_layers}x{mp.conv_channels}ch, "
                f"pool={mp.avg_pool_size}, "
                f"fc={mp.linear_layers}x{mp.linear_size}->"
                f"{mp.linear_output_size}, params={self.num_params():,}, "
                f"precision={self.precision}, device={self.device})")


def fold_preprocess(state_dict: dict) -> dict:
    """Fold the BGR->RGB flip and /255 into conv layer 1.

    ``conv(flip(x) / 255, W) == conv(x, W[:, flip(I)] / 255)``: with the
    fold, raw uint8 BGR pixels feed layer 1 directly.  Returns a new
    state dict; the input is not modified.
    """
    key = "conv.conv_layers.0.conv.weight"
    out = dict(state_dict)
    out[key] = state_dict[key].flip(1) / 255.0  # OIHW: flip the I axis
    return out


def folded_input(frames_u8: torch.Tensor) -> torch.Tensor:
    """Input of a ``fold_preprocess``'d net: the raw uint8 BGR frames.

    Layer 1's kernel reads uint8 itself (the JAX package casts to
    float32 here instead), so this only validates and makes contiguous.
    """
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 \
            or frames_u8.shape[3] != 3:
        raise ValueError("folded input must be uint8 [B, H, W, 3] BGR, got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    return frames_u8.contiguous()


def _glue(model_params: ModelParams, state_dict: dict, device,
          precision: str) -> GluedNet:
    net = GluedNet(model_params, precision)
    net.load_state_dict(state_dict)
    return net.to(device)


def _load_pt(path: str, prefix: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {prefix + k: v for k, v in sd.items()}


def load_and_glue_nets(param_file: str, conv_file: str, linear_file: str,
                       device, precision: str = "float32"):
    """Load a checkpoint triplet; return ``(net, model_params_dict)``.

    ``.npz`` bundles are converted with ``params_from_jax``; the
    reference's torch ``.pt`` state dicts load as they are (the modules
    keep the reference's keys).
    """
    model_params = ModelParams.from_json(param_file)
    if conv_file.endswith(".pt") or linear_file.endswith(".pt"):
        sd = {**_load_pt(conv_file, "conv."),
              **_load_pt(linear_file, "linear.")}
    else:
        sd = params_from_jax({"conv": load_bundle(conv_file),
                              "linear": load_bundle(linear_file)})
    return _glue(model_params, sd, device, precision), model_params.to_dict()


def load_triplet_or_default(model_dir: str | None, model_name: str,
                            device, precision: str = "float32"):
    """Load a saved triplet from ``model_dir`` (npz preferred, torch .pt
    accepted), or the bundled prod classifier when no dir is given."""
    if not model_dir:
        return load_default_net(device, precision)

    def pick(suffix: str, alt: str) -> str:
        path = os.path.join(model_dir, f"{model_name}{suffix}")
        return path if os.path.isfile(path) else os.path.join(
            model_dir, f"{model_name}{alt}")

    return load_and_glue_nets(
        os.path.join(model_dir, f"{model_name}_model_params.json"),
        pick("_classifier_conv.npz", "_classifier_conv.pt"),
        pick("_classifier_linear.npz", "_classifier_linear.pt"),
        device, precision)


def load_default_net(device, precision: str = "float32"):
    """The bundled prod classifier (``prod_net/init_model.npz``) on
    ``device`` at ``precision``; returns ``(net, model_params_dict)``."""
    model_params = ModelParams.from_json(
        os.path.join(_PROD_NET_DIR, "init_model_model_params.json"))
    sd = params_from_jax(load_bundle(
        os.path.join(_PROD_NET_DIR, "init_model.npz")))
    return _glue(model_params, sd, device, precision), model_params.to_dict()
