"""Micro-benchmark of the block kernels against the shipped nets, with the
prod weights at the prod input shape (B x 144 x 256, seed-0 uint8 frames).

Port of ``scripts/bench_fused_conv1.py`` (``:54-218``), stage for stage
and with its JSON keys:

- ``parity``: layer 1 through K1 (``conv1_block[bf16]``) against the
  shipped ``bfloat16_full`` net's layer 1 (``l1_max_diff``,
  ``l1_frac_gt_1e3``, ``l1_p999_diff``), and the class flips when the
  shipped layers 2, 3 and head follow each (``argmax_flips``);
- ``block``: K1 -> K4 -> K4 -> head (``e2e_allfused``) against the
  shipped net (``full_argmax_flips``, ``full_max_logit_diff``);
- ``mid``: the ``uint8_pool`` layer 1, then K3's ``bf16_out`` instance
  twice and the head (``e2e_u8mid``), against the shipped ``uint8_chain``
  net (``mid_argmax_flips``, ``mid_max_logit_diff``);
- ``l1``, ``e2e``, ``all``: the graphs' frames/s (``<graph>_fps``).

The JAX script's "shipped graph" is XLA's, and so is the port's shipped
net at that rung: ``l1_xla`` and ``e2e_xla`` run the ``bfloat16_full``
net (the ``bf16_xla`` kernel instances, XLA's numerics), ``e2e_chain``
the ``uint8_chain`` net (plain PyTorch).  ``l1_fused`` is K1 and
``rest_fused`` K4, at the Pallas kernels' numerics; layers 2 and 3 of
``e2e_u8mid`` run K3 (``bf16_out``) on the ``bfloat16_full`` net's
weights, the same as the ``uint8_chain`` net's.  ``e2e_k3`` (K1 -> K3 ->
K3 -> head, no stage times it) is the all-Pallas chain that K4's
``e2e_allfused`` must equal exactly.

Timing: a graph's loop runs ``steps`` calls on the frames plus the step
index (uint8, wrapping), summing each output into one scalar that is
read at the end; the median of 3 loops, after a loop of one, gives
seconds per call.  CUDA events time it on the card; with ``--cpu`` the
host clock does, and the JSON says ``"device": "cpu"``.

    python -m cut_detection_tpu_torch.scripts.bench_fused_conv1 \\
        [batch] [steps] [stage] [--cpu]

``stage`` is one of ``all`` (the default), ``parity``, ``l1``, ``e2e``,
``block`` and ``mid``; batch 128 and 50 steps by default.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cut_detection_tpu_torch.models.assembly import (
    GluedNet,
    fold_preprocess,
    load_default_net,
)
from cut_detection_tpu_torch.ops.kernels.conv1_block import conv1_block
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    conv_block,
    fused_conv_block,
)
from cut_detection_tpu_torch.ops.nn import (
    adaptive_avg_pool,
    bn_scale_offset,
    flatten_nchw_order,
)

# stage -> the graphs it times.
STAGES = {
    "all": ["l1_fused", "l1_xla", "e2e_fused", "e2e_xla", "e2e_allfused",
            "e2e_u8mid", "e2e_chain"],
    "parity": [],
    "l1": ["l1_fused", "l1_xla"],
    "e2e": ["e2e_fused", "e2e_xla"],
    "block": ["e2e_allfused", "e2e_xla"],
    "mid": ["e2e_u8mid", "e2e_chain"],
}


def _folded(net: GluedNet) -> GluedNet:
    out = GluedNet(net.model_params, net.precision)
    out.load_state_dict(fold_preprocess(net.state_dict()))
    return out.to(net.device)


def seeded_frames(batch: int, device) -> torch.Tensor:
    """The JAX script's input: seed-0 uint8 frames, [batch, 144, 256, 3]."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, size=(batch, 144, 256, 3),
                                         dtype=np.uint8)).to(device)


def pallas_args(layer):
    """A block's arguments for the Pallas-numerics instances (K1, K3): the
    bf16 kernel and the ``gamma / sqrt(var + eps)`` BN affine."""
    bn = layer.bn
    scale, offset = bn_scale_offset(bn.running_mean, bn.running_var,
                                    bn.weight, bn.bias, rsqrt=False)
    return (layer.hwio().contiguous().to(torch.bfloat16), layer.conv.bias,
            scale, offset)


def build_graphs(device) -> dict:
    """The benchmark's graphs, each frames (uint8 [B, 144, 256, 3]) ->
    activations or logits, on ``device``."""
    net = _folded(load_default_net(device, "bfloat16_full")[0])
    layers = net.conv.conv_layers
    pool_size = net.conv.cfg.average_pool_size
    chain = _folded(load_default_net(device, "uint8_chain")[0])
    u8_layer1 = _folded(load_default_net(device, "uint8_pool")[0]) \
        .conv.conv_layers[0]
    k1_args = pallas_args(layers[0])
    k3_args = [pallas_args(layer) for layer in layers[1:]]

    def head(acts):
        return net.linear(flatten_nchw_order(adaptive_avg_pool(
            acts.float(), pool_size)))

    def l1_xla(frames):
        """The shipped layer 1: conv (folded) -> ReLU -> pool -> BN."""
        return layers[0](frames)

    def l1_fused(frames):
        return conv1_block(frames, *k1_args, compute_dtype="bfloat16_full")

    def k3_chain(acts):
        for args in k3_args:
            acts = conv_block(acts, *args, compute_dtype="bfloat16_full",
                              out_dtype=torch.bfloat16)
        return head(acts)

    def rest(l1):
        acts = l1
        for layer in layers[1:]:
            acts = layer(acts)
        return head(acts)

    def rest_fused(l1):
        """Layers 2 and 3 through K4 (NHWC in and out, its defaults)."""
        acts = l1
        for layer in layers[1:]:
            bn = layer.bn
            acts = fused_conv_block(acts, layer.hwio(), layer.conv.bias,
                                    bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var)
        return head(acts)

    def e2e_u8mid(frames):
        return k3_chain(u8_layer1(frames))

    return {
        "l1_fused": l1_fused,
        "l1_xla": l1_xla,
        "e2e_fused": lambda v: rest(l1_fused(v)),
        "e2e_xla": lambda v: rest(l1_xla(v)),
        "e2e_allfused": lambda v: rest_fused(l1_fused(v)),
        "e2e_k3": lambda v: k3_chain(l1_fused(v)),
        "e2e_u8mid": e2e_u8mid,
        "e2e_chain": chain,
    }


def _seconds(device, fn) -> float:
    """Seconds of ``fn()``, which returns a scalar tensor that is read."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        float(out)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(fn())
    return time.perf_counter() - t0


def timed_loop(graph, frames, steps: int) -> float:
    """Median-of-3 seconds per call of ``graph`` over loops of ``steps``
    calls, each on ``frames + i`` and summed into one scalar."""

    def loop(k):
        acc = torch.zeros((), device=frames.device)
        for i in range(k):
            acc = acc + graph(frames + i).float().sum()
        return acc

    float(loop(1))  # warm-up: kernel build, cuDNN's first calls
    reps = sorted(_seconds(frames.device, lambda: loop(steps)) / steps
                  for _ in range(3))
    return reps[1]


def _logit_flips(ref, got) -> tuple[int, float]:
    return (int((ref.argmax(1) != got.argmax(1)).sum()),
            float((ref - got).abs().max()))


@torch.inference_mode()
def run(batch: int = 128, steps: int = 50, stage: str = "all",
        device=None) -> dict:
    """The benchmark at ``stage``; returns the JSON object it prints."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r} (one of "
                         f"{', '.join(STAGES)})")
    device = torch.device(device or "cuda")
    g = build_graphs(device)
    x = seeded_frames(batch, device)
    out = {"batch": batch, "stage": stage, "steps": steps,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}

    if stage == "mid":
        out["mid_argmax_flips"], out["mid_max_logit_diff"] = _logit_flips(
            g["e2e_chain"](x), g["e2e_u8mid"](x))

    if stage in ("all", "parity"):
        d = (g["l1_xla"](x).float() - g["l1_fused"](x).float()).abs()
        out["l1_max_diff"] = float(d.max())
        out["l1_frac_gt_1e3"] = float((d > 1e-3).float().mean())
        out["l1_p999_diff"] = float(np.quantile(d.cpu().numpy(), 0.999))
        out["argmax_flips"], _ = _logit_flips(g["e2e_xla"](x),
                                              g["e2e_fused"](x))

    if stage in ("all", "block"):
        out["full_argmax_flips"], out["full_max_logit_diff"] = _logit_flips(
            g["e2e_xla"](x), g["e2e_allfused"](x))

    for name in STAGES[stage]:
        out[name + "_fps"] = batch / timed_loop(g[name], x, steps)
    return out


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    pos = [a for a in args if a != "--cpu"]
    batch = int(pos[0]) if len(pos) > 0 else 128
    steps = int(pos[1]) if len(pos) > 1 else 50
    stage = pos[2] if len(pos) > 2 else "all"

    from cut_detection_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32,
    )

    device = resolve_device(cpu=cpu)
    strict_fp32()
    out = run(batch, steps, stage, device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
