"""Model assembly: conv backbone + FC head as one module.

Counterpart of ``cut_detection_tpu/models/assembly.py`` (``GluedNet``
``:38-137``, ``fold_preprocess`` ``:140-157``, ``folded_input``
``:160-170``, ``precompute_rings`` ``:173-240``, the loaders
``:243-327``); reference frameID/net.py:193-233.  Every precision rung is
ported (``PORTED_PRECISIONS``).  A ``GluedNet`` is built for inference;
the training loops (``train/``) initialise one with ``init_weights``,
switch it to ``.train()`` and apply its recorded BN statistics after each
backward (``apply_bn_stats``).
"""

from __future__ import annotations

import logging
import os

import torch
from torch import nn

from cut_detection_tpu_torch.checkpoint.convert import (
    bundle_from_state_dict,
    params_from_jax,
)
from cut_detection_tpu_torch.checkpoint.io import load_bundle, save_bundle
from cut_detection_tpu_torch.config import ModelParams
from cut_detection_tpu_torch.models.frame_conv import (
    CHAIN_RUNGS,
    FrameConvNet,
    FrameLinearNet,
)
from cut_detection_tpu_torch.models.layers import (
    POOL_WINDOW,
    const_conv_ring,
)

logger = logging.getLogger(__name__)

PORTED_PRECISIONS = ("float32", "bfloat16", "bfloat16_full", "uint8_pool",
                     "uint8_chain", "int8_mxu")
# The rungs whose activation scales come from the BN running statistics.
QUANTIZED_PRECISIONS = ("uint8_pool", "uint8_chain", "int8_mxu")

# The bundled prod classifier is the JAX package's data, read by path
# from the sibling directory (the port imports nothing of that package).
_PROD_NET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "cut_detection_tpu", "prod_net")


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
        """None (float32), else the rung's name (``"bfloat16"``: bf16
        operands, f32 activations; ``"bfloat16_full"``: bf16 operands and
        activations; the quantized rungs), as the JAX ``GluedNet`` names
        them."""
        return None if self.precision == "float32" else self.precision

    @property
    def device(self) -> torch.device:
        return self.conv.conv_layers[0].conv.weight.device

    def forward(self, x: torch.Tensor, rings=None) -> torch.Tensor:
        """``rings``: the ``uint8_chain`` or ``int8_mxu`` constant terms
        from ``precompute_rings(net, h, w)`` of this net, or None to
        compute them in the forward."""
        return self.linear(self.conv(x, rings))

    def num_params(self) -> int:
        """Trainable parameter count (BN running stats excluded)."""
        return sum(p.numel() for p in self.parameters())

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial values (``init_frame_conv``,
        ``init_frame_linear``), drawn from ``generator``, a CPU
        ``torch.Generator``, block by block: U(+-1/sqrt(fan_in)) weights
        and biases, BN gamma 1, beta 0, mean 0, var 1.  The draws are not
        JAX's: its keys make another stream."""
        for block in (*self.conv.conv_layers, *self.linear.layers):
            block.init_weights(generator)

    @torch.no_grad()
    def apply_bn_stats(self) -> None:
        """Write the BN running statistics that the last train forward
        recorded (``bn_stats``) into the blocks, once, and clear them.
        A training step calls it after its backward, so a rematerialized
        forward, which records the same values again, moves them once."""
        for net, blocks in ((self.conv, self.conv.conv_layers),
                            (self.linear, self.linear.layers)):
            for i, (mean, var) in net.bn_stats.items():
                blocks[i].bn.running_mean.copy_(mean)
                blocks[i].bn.running_var.copy_(var)
            net.bn_stats.clear()

    def bundle(self) -> dict:
        """The weights as a native numpy bundle (``checkpoint.convert.
        bundle_from_state_dict``)."""
        return bundle_from_state_dict(self.state_dict())

    def save(self, path: str) -> None:
        """Save the weights as one ``.npz`` bundle, as the JAX
        ``GluedNet.save`` does (``assembly.py:116-118``)."""
        save_bundle(path, self.bundle())

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

    Layer 1's kernel reads uint8 itself at every rung (the JAX package
    casts to float32 here at all but ``int8_mxu``, whose layer 1 takes
    the raw frames too), so this only validates and makes contiguous.
    """
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4 \
            or frames_u8.shape[3] != 3:
        raise ValueError("folded input must be uint8 [B, H, W, 3] BGR, got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    return frames_u8.contiguous()


class Rings(tuple):
    """The chained blocks' constant terms, one per conv layer, with the
    ``FrameConvNet`` they were computed from as ``source``: at
    ``uint8_chain`` the ``[1, h, w, C]`` canvases (None for layer 1, whose
    input is dense); at ``int8_mxu`` the ``[3, w, C]`` f32 strips that the
    int8 blocks take (``ops.kernels.conv_block_i8.ring_canvas`` expands
    one), layer 1's too where it reads raw pixels."""

    def __new__(cls, rings, source):
        out = super().__new__(cls, rings)
        out.source = source
        return out


@torch.inference_mode()
def precompute_rings(net: GluedNet, h: int, w: int, *,
                     fold: bool = True) -> Rings | None:
    """The ring constants of ``net`` for an input of ``h`` x ``w``, once.

    Each chained block adds ``conv(b * 1, W) + bias``, a term that
    depends only on the weights and the input size; a per-batch step
    computes it here once per (net, size) and passes it in.  The walk
    takes the pending affine from the same method as the blocks
    (``ConvBlock.u8_pending_affine`` / ``i8_pending_affine``) and the same
    strip conv (``const_conv_ring``), so the logits are bit-identical to
    the in-forward rings.  ``fold`` says that layer 1 reads raw uint8
    pixels (a ``fold_preprocess``'d net), as the JAX function's does: at
    ``int8_mxu`` layer 1 then has a ring of its own (``b = 128``, the
    -128 shift); at ``uint8_chain`` it has none either way.  Each net's
    rings are tagged with it.  None for a rung without rings.
    """
    conv = net.conv
    if conv.compute_dtype not in CHAIN_RUNGS:
        return None
    int8 = conv.compute_dtype == "int8_mxu"
    rings, affine = [], None
    for layer in conv.conv_layers:
        kernel, bias = layer.hwio().float(), layer.conv.bias
        if affine is None and int8 and fold:
            b = torch.full((kernel.shape[2],), 128.0, device=kernel.device)
        elif affine is None:
            b = None  # dense input, no ring
        else:
            b = affine[1]
        if b is None or (int8 and min(h, w) < 3):
            rings.append(None)  # no input ring, or no pool window
        elif int8:
            rings.append(const_conv_ring(b, kernel, bias, 3, w)[0].float())
        else:
            rings.append(const_conv_ring(b, kernel, bias, h, w))
        affine = (layer.i8_pending_affine() if int8
                  else layer.u8_pending_affine())
        # Floor pooling, the blocks' window.
        h, w = h // POOL_WINDOW, w // POOL_WINDOW
    return Rings(rings, conv)


def warn_if_stats_unconverged(state_dict: dict, precision: str) -> bool:
    """Warn when a quantized rung loads conv BN statistics still at their
    initial values (mean 0, var 1): its activation scales derive from
    them, so such a checkpoint would clip real activations.  Returns
    whether it warned.  Counterpart of ``GluedNet._warn_if_stats_
    unconverged`` (``cut_detection_tpu/models/assembly.py:65-89``)."""
    if precision not in QUANTIZED_PRECISIONS:
        return False
    for key, mean in state_dict.items():
        if not (key.startswith("conv.") and key.endswith(
                ".bn.running_mean")):
            continue
        var = state_dict[key[:-len("running_mean")] + "running_var"]
        if mean.abs().max() < 1e-6 and (var - 1.0).abs().max() < 1e-6:
            logger.warning(
                "%s: a conv layer's BN running statistics look "
                "uninitialized (mean=0, var=1).  The quantized activation "
                "scale is derived from these stats, so an untrained/"
                "unconverged checkpoint will clip activations and degrade "
                "accuracy — use float32/bfloat16_full for such models, or "
                "train until the running stats converge.", precision)
            return True
    return False


def _glue(model_params: ModelParams, state_dict: dict, device,
          precision: str) -> GluedNet:
    net = GluedNet(model_params, precision)
    net.load_state_dict(state_dict)
    warn_if_stats_unconverged(state_dict, precision)
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


def load_embedding_net(model_dir: str, model_name: str, device,
                       precision: str = "float32"):
    """A contrastive (conv + projection head) pair for batched embedding
    inference, on ``device`` at ``precision``; returns ``(net,
    model_params_dict)``.  Counterpart of the JAX package's
    ``load_embedding_net`` (``assembly.py:288-305``).

    Reads the ``{name}_conv.npz`` / ``{name}_linear.npz`` pair that both
    training CLIs' contrastive stage writes, with its
    ``{name}_embed_params.json`` sidecar.  ``net(x)`` maps NHWC float
    frames in [0, 1] (RGB) to projection-space embeddings.
    """
    return load_and_glue_nets(
        *(os.path.join(model_dir, f"{model_name}{suffix}") for suffix in (
            "_embed_params.json", "_conv.npz", "_linear.npz")),
        device, precision)


def load_default_net(device, precision: str = "float32"):
    """The bundled prod classifier (``prod_net/init_model.npz``) on
    ``device`` at ``precision``; returns ``(net, model_params_dict)``."""
    model_params = ModelParams.from_json(
        os.path.join(_PROD_NET_DIR, "init_model_model_params.json"))
    sd = params_from_jax(load_bundle(
        os.path.join(_PROD_NET_DIR, "init_model.npz")))
    return _glue(model_params, sd, device, precision), model_params.to_dict()
