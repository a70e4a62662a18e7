"""Plain PyTorch reference of the frame classifier and its training step.

Written from the published model (play4honor/Cut-Detection,
``frameID/net.py``): conv 3x3 'same' -> ReLU -> max pool 3/3 -> BatchNorm,
``conv_layers`` times, adaptive average pool, flatten in NCHW order, then
linear -> ReLU -> BatchNorm for the hidden FC layers and a last linear.
Layout is NCHW throughout and every op is a plain ``torch`` call in
float32.  It imports nothing of the program under test: the benchmark
hands the same seeded weights and frames to both sides, and this file
works everything else out again.

The quantized inference rung, ``uint8_chain`` (``forward_chain``), is
computed as the rung states its numerics (the JAX package's
``models/layers.py`` contract, which the port's tests hold it to): each
convolution takes bfloat16 operands, accumulates in float32 and rounds
the sum to bfloat16, then adds the bias in bfloat16; layer 1 reads the
raw uint8 BGR pixels with the channel flip and the / 255 folded into its
weights; each block's post-ReLU activation becomes integer codes
``clip(rint(z / s), 0, levels)`` with a per-channel scale ``s =
(running_mean + 8 * sqrt(running_var + eps)) / levels``, the codes are
max-pooled and passed on with their dequantize-and-BN affine pending:
the next block folds the affine's scale into its weights and adds the
convolution of the affine's offset over a zero-padded canvas (the
*ring*).  The last block's codes are dequantized to bfloat16 before the
average pool, and the FC layers take bfloat16 operands.  ``levels=255``
is uint8; the control runs ``levels=15`` (int4).  ``forward_eval`` is
the float32 forward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
POOL = 3


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for float32 matmuls and convolutions on the card: off for the
    reference, on only for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def conv_key(i: int, leaf: str) -> str:
    return f"conv.conv_layers.{i}.{leaf}"


def fc_key(i: int, leaf: str) -> str:
    return f"linear.layers.{i}.{leaf}"


def layer_widths(model: dict) -> tuple[list, list]:
    """((cin, cout) of each conv, (fin, fout) of each FC layer)."""
    c = model["conv_channels"]
    convs = [(model["input_channels"], c)] + [(c, c)] * (
        model["conv_layers"] - 1)
    fin = c * model["avg_pool_size"] ** 2
    hid, out = model["linear_size"], model["linear_output_size"]
    n = model["linear_layers"]
    fcs = [(fin if k == 0 else hid, out if k == n - 1 else hid)
           for k in range(n)]
    return convs, fcs


def bn_eval(x, p, pfx, channel_dim):
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    s = p[pfx + "bn.weight"] / torch.sqrt(p[pfx + "bn.running_var"] + BN_EPS)
    t = p[pfx + "bn.bias"] - p[pfx + "bn.running_mean"] * s
    return x * s.reshape(shape) + t.reshape(shape)


def bn_train(x, p, pfx, channel_dim, new_stats):
    """Train BN: normalise with the biased batch variance, record the new
    running statistics (unbiased variance, momentum 0.1) in ``new_stats``."""
    dims = [d for d in range(x.dim()) if d != channel_dim]
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mean = x.mean(dim=dims)
    var = ((x - mean.reshape(shape)) ** 2).mean(dim=dims)
    count = x.numel() // x.shape[channel_dim]
    with torch.no_grad():
        new_stats[pfx + "bn.running_mean"] = (
            (1 - BN_MOMENTUM) * p[pfx + "bn.running_mean"]
            + BN_MOMENTUM * mean)
        new_stats[pfx + "bn.running_var"] = (
            (1 - BN_MOMENTUM) * p[pfx + "bn.running_var"]
            + BN_MOMENTUM * var * count / max(count - 1, 1))
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + BN_EPS)
    return y * p[pfx + "bn.weight"].reshape(shape) + p[
        pfx + "bn.bias"].reshape(shape)


def bgr_u8_to_input(frames_bgr: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC BGR -> float32 NCHW RGB in [0, 1] (the published
    preprocessing: channel flip, then / 255)."""
    return frames_bgr.flip(-1).permute(0, 3, 1, 2).float() / 255.0


def rgb_u8_to_input(frames_rgb: torch.Tensor) -> torch.Tensor:
    return frames_rgb.permute(0, 3, 1, 2).float() / 255.0


def quant_scale(p, pfx, levels: int):
    """Per-channel code scale, one float32 operation at a time as the rung
    rounds it (the square root taken in float64, rounded once)."""
    mean, var = p[pfx + "bn.running_mean"], p[pfx + "bn.running_var"]
    sigma = torch.sqrt((var + BN_EPS).double()).float()
    scale = (mean + 8.0 * sigma) / torch.full_like(mean, float(levels))
    return torch.clamp(scale, min=1e-12)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, as float32."""
    return t.to(torch.bfloat16).float()


def conv_bf16(x, w, bias=None):
    """bf16 operands, float32 sums rounded to bf16, bias added in bf16."""
    z = bf16(F.conv2d(bf16(x), bf16(w), padding=1))
    if bias is not None:
        z = bf16(z + bf16(bias).reshape(1, -1, 1, 1))
    return z


def bn_affine(p, pfx):
    """Eval BN as ``x * s + t``: ``s = gamma * rsqrt(var + eps)``."""
    s = p[pfx + "bn.weight"] * torch.rsqrt(p[pfx + "bn.running_var"]
                                           + BN_EPS)
    return s, p[pfx + "bn.bias"] - p[pfx + "bn.running_mean"] * s


def forward_chain(p: dict, model: dict, frames_bgr: torch.Tensor,
                  levels: int = 255) -> torch.Tensor:
    """``uint8_chain`` logits of uint8 NHWC BGR frames (module
    docstring)."""
    convs, fcs = layer_widths(model)
    x = frames_bgr.permute(0, 3, 1, 2).float()
    affine = None
    for i in range(len(convs)):
        pfx = conv_key(i, "")
        w, bias = p[pfx + "conv.weight"], p[pfx + "conv.bias"]
        if affine is None:
            # The flip and / 255 folded into layer 1's weights.
            z = conv_bf16(x, w.flip(1) / 255.0, bias)
        else:
            a, b = affine
            h, wd = x.shape[2:]
            canvas = b.reshape(1, -1, 1, 1).expand(1, b.shape[0], h, wd)
            ring = conv_bf16(canvas, w, bias)
            z = bf16(conv_bf16(x, w * a.reshape(1, -1, 1, 1)) + ring)
        scale = quant_scale(p, pfx, levels)
        q = torch.clamp(torch.round(torch.relu(z) / scale.reshape(
            1, -1, 1, 1)), 0.0, float(levels))
        x = F.max_pool2d(q, POOL)
        s, t = bn_affine(p, pfx)
        affine = (scale * s, t)
    a, b = affine
    x = bf16(x * a.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1))
    x = F.adaptive_avg_pool2d(x, model["avg_pool_size"]).flatten(1)
    for k in range(len(fcs)):
        pfx = fc_key(k, "")
        x = bf16(x) @ bf16(p[pfx + "linear.weight"]).T + p[
            pfx + "linear.bias"]
        if k < len(fcs) - 1:
            s, t = bn_affine(p, pfx)
            x = torch.relu(x) * s + t
    return x


def forward_eval(p: dict, model: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 eval logits of NCHW input ``x`` in [0, 1]."""
    convs, fcs = layer_widths(model)
    for i in range(len(convs)):
        pfx = conv_key(i, "")
        z = torch.relu(F.conv2d(x, p[pfx + "conv.weight"],
                                p[pfx + "conv.bias"], padding=1))
        x = bn_eval(F.max_pool2d(z, POOL), p, pfx, 1)
    x = F.adaptive_avg_pool2d(x, model["avg_pool_size"]).flatten(1)
    for k in range(len(fcs)):
        pfx = fc_key(k, "")
        x = x @ p[pfx + "linear.weight"].T + p[pfx + "linear.bias"]
        if k < len(fcs) - 1:
            x = bn_eval(torch.relu(x), p, pfx, 1)
    return x


def forward_train(p: dict, model: dict, x: torch.Tensor,
                  new_stats: dict) -> torch.Tensor:
    """Train-mode logits (batch statistics), recording the new BN running
    statistics in ``new_stats``."""
    convs, fcs = layer_widths(model)
    for i in range(len(convs)):
        pfx = conv_key(i, "")
        z = torch.relu(F.conv2d(x, p[pfx + "conv.weight"],
                                p[pfx + "conv.bias"], padding=1))
        x = bn_train(F.max_pool2d(z, POOL), p, pfx, 1, new_stats)
    x = F.adaptive_avg_pool2d(x, model["avg_pool_size"]).flatten(1)
    for k in range(len(fcs)):
        pfx = fc_key(k, "")
        x = x @ p[pfx + "linear.weight"].T + p[pfx + "linear.bias"]
        if k < len(fcs) - 1:
            x = bn_train(torch.relu(x), p, pfx, 1, new_stats)
    return x


def cross_entropy_sum(logits, labels):
    """``CrossEntropyLoss(reduction="sum")``."""
    return F.cross_entropy(logits, labels, reduction="sum")


def ntxent(proj: torch.Tensor, temperature: float) -> torch.Tensor:
    """SimCLR's NT-Xent of the published metric (frameID/metrics.py):
    rows L2-normalised; for each row of one view, cross entropy over its
    similarities to the other view and to its own view with itself masked
    out, the positive being the same row of the other view; the two
    views' means summed."""
    z = F.normalize(proj, dim=1)
    b = z.shape[0] // 2
    za, zb = z[:b], z[b:]
    eye = torch.eye(b, device=z.device, dtype=torch.bool)
    labels = torch.arange(b, device=z.device)
    loss = 0.0
    for own, other in ((za, zb), (zb, za)):
        cross = own @ other.T / temperature
        self_sim = (own @ own.T / temperature).masked_fill(eye, -1e9)
        loss = loss + F.cross_entropy(torch.cat([cross, self_sim], dim=1),
                                      labels)
    return loss


def trainable_keys(model: dict) -> list[str]:
    """The parameters the optimizer holds, in the program's order."""
    convs, fcs = layer_widths(model)
    keys = []
    for i in range(len(convs)):
        keys += [conv_key(i, leaf) for leaf in (
            "conv.weight", "conv.bias", "bn.weight", "bn.bias")]
    for k in range(len(fcs)):
        keys += [fc_key(k, "linear.weight"), fc_key(k, "linear.bias")]
        if k < len(fcs) - 1:
            keys += [fc_key(k, "bn.weight"), fc_key(k, "bn.bias")]
    return keys


def stat_keys(model: dict) -> list[str]:
    convs, fcs = layer_widths(model)
    keys = []
    for i in range(len(convs)):
        keys += [conv_key(i, "bn.running_mean"), conv_key(i, "bn.running_var")]
    for k in range(len(fcs) - 1):
        keys += [fc_key(k, "bn.running_mean"), fc_key(k, "bn.running_var")]
    return keys


def train_steps(state: dict, model: dict, batches, *, loss: str,
                optim: dict, temperature: float = 1.0, scale: float = 1.0):
    """Run the reference's steps from ``state`` (a state dict, copied) on
    ``batches`` (NCHW float input and, for ``loss="ce"``, int64 labels).
    Returns ``(losses, first_grads, final_state)``: each step's loss, the
    first step's gradient of every trainable leaf, and the state after
    the last step.  AdamW as torch's, the decay on every leaf.  ``scale``
    multiplies each loss (a fault reading: half a batch's summed loss
    taken as the whole batch's)."""
    keys = trainable_keys(model)
    p = {k: v.detach().clone() for k, v in state.items()}
    leaves = [p[k].requires_grad_(True) for k in keys]
    opt = torch.optim.AdamW(leaves, lr=optim["learning_rate"],
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=optim["weight_decay"],
                            foreach=False)
    losses, first = [], None
    for x, y in batches:
        new_stats: dict = {}
        out = forward_train(p, model, x, new_stats)
        value = scale * (cross_entropy_sum(out, y) if loss == "ce"
                         else ntxent(out, temperature))
        opt.zero_grad(set_to_none=True)
        value.backward()
        if first is None:
            first = {k: t.grad.detach().clone() for k, t in zip(keys, leaves)}
        opt.step()
        with torch.no_grad():
            for k, v in new_stats.items():
                p[k].copy_(v)
        losses.append(float(value.detach()))
    final = {k: v.detach().clone() for k, v in p.items()}
    return losses, first, final
