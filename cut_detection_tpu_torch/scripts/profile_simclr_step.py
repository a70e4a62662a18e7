"""Where the SimCLR step's time goes: the augmentation against the math.

Port of ``scripts/profile_simclr_step.py``, with its arguments and JSON
keys, on the port's ``train/augment.py`` at the reference config (batch
32 of 360x640 originals, 144x256 views):

  augment      — ``simclr_two_views``: both views of the exact path
                 (nearest affine at source size, colour jitter, resized
                 crop)
  affine_only  — ``affine_transform`` alone, on f32 frames
  jitter_only  — ``apply_color_jitter`` alone, on f32 frames
  rrc_only     — ``resized_crop`` alone, f32 frames -> 144x256
  train_math   — forward, backward and optimizer on ready-made views
                 (``contrastive.make_contrastive_update``)

Each timed call draws its parameters on the CPU from an explicit
``torch.Generator``, as the step pays for them.  A call's output is read
back (``.item()`` of one element) at the end of each repetition; the
median of three repetitions of ``steps`` calls, after one warm call,
gives ms a call.  On the card its name and power limit are printed
first; with ``--cpu`` everything runs on the CPU.

    python -m cut_detection_tpu_torch.scripts.profile_simclr_step \\
        [batch] [steps] [--cpu]

Batch 32 and 20 steps by default.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

HW = (360, 640)


def timed(fn, steps: int) -> float:
    """Seconds a call of ``fn`` (which returns a tensor): one warm call,
    then the median of three repetitions of ``steps`` calls, each read
    back to the host at its end."""
    if steps < 1:
        raise ValueError("steps must be positive")
    fn().reshape(-1)[:1].item()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        out.reshape(-1)[:1].item()
        reps.append((time.perf_counter() - t0) / steps)
    return sorted(reps)[1]


def draw_views(cfg, gen: torch.Generator, x_u8: torch.Tensor):
    """The two concatenated views that ``make_contrastive_step(cfg)``'s
    step makes of ``x_u8`` when it draws from ``gen``."""
    from cut_detection_tpu_torch.train.contrastive import two_views

    b = x_u8.shape[0]
    return two_views(cfg, gen, x_u8, b, slice(0, b))


def run(batch: int, steps: int, device: torch.device) -> dict:
    from cut_detection_tpu_torch.config import ContrastiveConfig
    from cut_detection_tpu_torch.ops.preprocess import to_unit
    from cut_detection_tpu_torch.train.augment import (
        affine_params,
        affine_transform,
        apply_color_jitter,
        color_jitter_params,
        resized_crop,
        resized_crop_params,
        simclr_two_views,
    )
    from cut_detection_tpu_torch.train.contrastive import (
        init_contrastive_state,
        make_contrastive_update,
    )

    h, w = HW
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, size=(batch, h, w, 3),
                                      dtype=np.uint8)).to(device)
    xf = to_unit(x)
    gen = torch.Generator().manual_seed(0)

    out: dict = {"batch": batch}
    out["augment_ms"] = 1e3 * timed(lambda: simclr_two_views(gen, x), steps)
    out["affine_only_ms"] = 1e3 * timed(
        lambda: affine_transform(xf, *affine_params(gen, batch, w, h)), steps)
    out["jitter_only_ms"] = 1e3 * timed(
        lambda: apply_color_jitter(xf, *color_jitter_params(gen, batch)),
        steps)
    out["rrc_only_ms"] = 1e3 * timed(
        lambda: resized_crop(xf, *resized_crop_params(gen, batch, h, w)),
        steps)

    cfg = ContrastiveConfig(batch_size=batch)
    views = draw_views(cfg, torch.Generator().manual_seed(0), x)
    update = make_contrastive_update(cfg)
    state = init_contrastive_state(torch.Generator().manual_seed(0), cfg,
                                   device)
    out["train_math_ms"] = 1e3 * timed(
        lambda: update(state, views)[1]["loss"], steps)
    return out


def parse(argv) -> tuple[int, int, bool]:
    """``[batch] [steps] [--cpu]`` -> (batch, steps, cpu)."""
    cpu = "--cpu" in argv
    pos = [a for a in argv if a != "--cpu"]
    batch = int(pos[0]) if len(pos) > 0 else 32
    steps = int(pos[1]) if len(pos) > 1 else 20
    return batch, steps, cpu


def main(argv=None) -> dict:
    batch, steps, cpu = parse(sys.argv[1:] if argv is None else list(argv))
    from cut_detection_tpu_torch.utils.device import (
        card_info,
        resolve_device,
        strict_fp32,
    )

    device = resolve_device(cpu=cpu)
    if device.type == "cuda":
        strict_fp32()
        print(f"card: {card_info()}", flush=True)
    out = run(batch, steps, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
