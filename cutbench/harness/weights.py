"""Seeded weights, made on the run's device in one call.

Every weight and bias is ``U(-1, 1) / sqrt(fan_in)``, the published
initialisation of ``nn.Conv2d`` and ``nn.Linear``.  For training the BN
layers start as torch's do (gamma 1, beta 0, running mean 0, variance
1).  A served net (``served=True``) stands for a trained one: its BN
gammas and betas are drawn too, and its running statistics are
calibrated on frames of the cell's own pool with the float32 reference
forward, layer by layer, as training would have left them.  The
quantized rungs take their activation scales from those statistics, so
uncalibrated ones would clip or flatten every code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cutbench.reference import model as ref


def _leaves(model: dict):
    """(key, shape, kind) of every tensor of the state dict, in order."""
    convs, fcs = ref.layer_widths(model)
    out = []
    for i, (cin, cout) in enumerate(convs):
        out += [(ref.conv_key(i, "conv.weight"), (cout, cin, 3, 3), "w"),
                (ref.conv_key(i, "conv.bias"), (cout,), "b")]
        out += [(ref.conv_key(i, "bn." + s), (cout,), s) for s in (
            "weight", "bias", "running_mean", "running_var")]
    for k, (fin, fout) in enumerate(fcs):
        out += [(ref.fc_key(k, "linear.weight"), (fout, fin), "w"),
                (ref.fc_key(k, "linear.bias"), (fout,), "b")]
        if k < len(fcs) - 1:
            out += [(ref.fc_key(k, "bn." + s), (fout,), s) for s in (
                "weight", "bias", "running_mean", "running_var")]
    return out


def make_state(model: dict, seed: int, device, *,
               served: bool) -> dict[str, torch.Tensor]:
    """The state dict (float32 on ``device``; ``num_batches_tracked``
    left out, the program keeps its own)."""
    leaves = _leaves(model)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), device=device).uniform_(
        -1.0, 1.0, generator=gen)
    state = {}
    fan_in = None
    for (key, shape, kind), part in zip(leaves, flat.split(sizes)):
        part = part.reshape(shape)
        if kind == "w":
            fan_in = int(torch.Size(shape[1:]).numel())
            state[key] = part / fan_in ** 0.5
        elif kind == "b":
            state[key] = part / fan_in ** 0.5
        elif kind == "weight":
            state[key] = 1.0 + 0.25 * part if served else torch.ones_like(part)
        elif kind == "bias":
            state[key] = 0.1 * part if served else torch.zeros_like(part)
        elif kind == "running_mean":
            state[key] = torch.zeros_like(part)
        else:
            state[key] = torch.ones_like(part)
    return {k: v.contiguous() for k, v in state.items()}


# A channel's calibrated variance is at least this share of its layer's
# median: a channel that the seeded weights leave dead on the calibration
# frames would otherwise get a quantization scale near zero, which a
# trained net does not have.
VAR_FLOOR = 0.25


def _stats(z, dims):
    var = z.var(dim=dims)
    return z.mean(dim=dims), torch.clamp(var, min=VAR_FLOOR * float(
        var.median()))


@torch.no_grad()
def calibrate(state: dict, model: dict, x: torch.Tensor) -> None:
    """Set the running statistics in ``state`` to the float32 activations'
    per-channel mean and variance (floored, ``VAR_FLOOR``) on NCHW input
    ``x``, each layer on the output of the layers before it, already
    calibrated."""
    convs, fcs = ref.layer_widths(model)
    for i in range(len(convs)):
        pfx = ref.conv_key(i, "")
        z = F.max_pool2d(torch.relu(F.conv2d(
            x, state[pfx + "conv.weight"], state[pfx + "conv.bias"],
            padding=1)), ref.POOL)
        state[pfx + "bn.running_mean"], state[pfx + "bn.running_var"] = \
            _stats(z, (0, 2, 3))
        x = ref.bn_eval(z, state, pfx, 1)
    x = F.adaptive_avg_pool2d(x, model["avg_pool_size"]).flatten(1)
    for k in range(len(fcs) - 1):
        pfx = ref.fc_key(k, "")
        z = torch.relu(x @ state[pfx + "linear.weight"].T
                       + state[pfx + "linear.bias"])
        state[pfx + "bn.running_mean"], state[pfx + "bn.running_var"] = \
            _stats(z, (0,))
        x = ref.bn_eval(z, state, pfx, 1)
