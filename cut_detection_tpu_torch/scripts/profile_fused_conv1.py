"""Stage-bisection microbenchmark of layer 1 on the card.

Port of ``scripts/profile_fused_conv1.py``, with its arguments and its
JSON keys: the six cumulative stages of ``ops.kernels.conv1_stages``
(``cast``, ``taps``, ``dotn``, ``dott``, ``tpose``, ``full``; see that
module and ``conv1_stages`` in ``csrc/conv_block.cu`` for what each
leaves), at the prod shape (B x 144 x 256 in the planar flat layout), on
seed-0 uint8 planes and N(0, 0.1) bf16 weights.  The times split the cost
of the port's layer-1 tensor-core chain (``conv1_block_mma``'s steps):
staging, packing, ``wgmma``, the epilogue and the pool.

Timing, as the TPU script's ``run``: a loop of ``steps`` calls, each on
``x + i`` (uint8, wrapping) with its output summed into one scalar that
is read at the end; the median of 3 loops, after a loop of one, gives
seconds per call; ``<stage>_us_per_img`` and ``<stage>_fps`` follow.  CUDA
events time it on the card; with ``--cpu`` the plain versions run and the
host clock times them.  The card's name and power limit are printed
first, then one JSON line per stage and last one JSON line of them all.

    python -m cut_detection_tpu_torch.scripts.profile_fused_conv1 \\
        [batch] [steps] [stages...] [--cpu]

Batch 128, 30 steps and every stage by default.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cut_detection_tpu_torch.ops.kernels.conv1_stages import (
    FLAT,
    STAGES,
    conv1_stages,
)


def seeded_inputs(batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU script's inputs: seed-0 planes ``[batch, 3, 37668]`` uint8,
    then ``[48, 32]`` N(0, 0.1) weights rounded to bf16, from one
    generator in that order."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(batch, 3, FLAT), dtype=np.uint8)
    w = rng.normal(0, 0.1, size=(48, 32)).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(w).to(torch.bfloat16).to(device))


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


def seconds_per_call(stage: str, x: torch.Tensor, w: torch.Tensor,
                     steps: int) -> float:
    def loop(k):
        acc = torch.zeros((), device=x.device)
        for i in range(k):
            acc = acc + conv1_stages(x + i, w, stage)[0].sum()
        return acc

    float(loop(1))  # warm-up: the kernel's build and first launch
    reps = sorted(_seconds(x.device, lambda: loop(steps)) / steps
                  for _ in range(3))
    return reps[1]


@torch.inference_mode()
def run(batch: int = 128, steps: int = 30, stages=STAGES,
        device=None) -> dict:
    """Time ``stages``; returns the JSON object that ``main`` prints."""
    for stage in stages:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r} (one of "
                             f"{', '.join(STAGES)})")
    device = torch.device(device or "cuda")
    x, w = seeded_inputs(batch, device)
    out = {"batch": batch,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    for stage in stages:
        sec = seconds_per_call(stage, x, w, steps)
        out[stage + "_us_per_img"] = 1e6 * sec / batch
        out[stage + "_fps"] = batch / sec
        print(json.dumps({stage: out[stage + "_us_per_img"]}), flush=True)
    return out


def parse(argv) -> tuple[int, int, list[str], bool]:
    """``[batch] [steps] [stages...] [--cpu]`` -> (batch, steps, stages,
    cpu)."""
    args = list(argv)
    cpu = "--cpu" in args
    pos = [a for a in args if a != "--cpu"]
    batch = int(pos[0]) if len(pos) > 0 else 128
    steps = int(pos[1]) if len(pos) > 1 else 30
    stages = pos[2:] or list(STAGES)
    for stage in stages:
        if stage not in STAGES:
            raise SystemExit(f"unknown stage {stage!r} (one of "
                             f"{', '.join(STAGES)})")
    return batch, steps, stages, cpu


def main(argv=None) -> dict:
    batch, steps, stages, cpu = parse(sys.argv[1:] if argv is None
                                      else argv)
    from cut_detection_tpu_torch.utils.device import card_info, resolve_device

    device = resolve_device(cpu=cpu)
    if device.type == "cuda":
        print(f"card: {card_info()}", flush=True)
    out = run(batch, steps, stages, device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
