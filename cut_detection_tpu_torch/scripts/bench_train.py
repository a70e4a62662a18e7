"""Training step time: supervised and SimCLR, at float32 and bfloat16.

Port of ``scripts/bench_train.py``, with its arguments and JSON keys.
The supervised step runs the prod config (3 conv layers of 48 channels,
pool 4, FC 768->32->3) on ``batch`` seeded 144x256 frames; the SimCLR
step the contrastive defaults (32 channels) on ``SIMCLR_BATCH`` seeded
360x640 originals, its two 144x256 views made on the frames' device,
with the exact and the composed (fast) augment paths.  Each variant
takes one step to warm, then three repetitions of ``steps`` steps run
back to back, each timed to the ``.item()`` of its last loss; the
median repetition gives ms a step.  TF32 stays off, as in training
(``utils.device.strict_fp32``).  On the card its name and power limit
are printed first; with ``--cpu`` the steps run on the CPU.

    python -m cut_detection_tpu_torch.scripts.bench_train \\
        [batch] [steps] [--cpu]

Batch 128 and 30 steps by default.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

SIMCLR_BATCH = 32
SIMCLR_HW = (360, 640)


def _seconds_per_step(step, steps: int) -> tuple[float, float]:
    """Warm ``step`` (a callable returning a loss tensor) once, then the
    median of three repetitions of ``steps`` back-to-back calls, each
    timed to the last loss's ``.item()``: (seconds a step, that loss)."""
    step().item()
    reps = []
    loss = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        value = loss.item()
        reps.append((time.perf_counter() - t0) / steps)
    return sorted(reps)[1], value


def run(batch: int, steps: int, device: torch.device) -> dict:
    from cut_detection_tpu_torch.config import ContrastiveConfig, TrainConfig
    from cut_detection_tpu_torch.train.contrastive import (
        init_contrastive_state,
        make_contrastive_step,
    )
    from cut_detection_tpu_torch.train.supervised import (
        init_train_state,
        make_train_step,
    )

    if steps < 1:
        raise ValueError("steps must be positive")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, size=(batch, 144, 256, 3),
                                      dtype=np.uint8)).to(device)
    y = torch.from_numpy(rng.integers(0, 3, size=(batch,))).to(device)

    out: dict = {"batch": batch, "steps": steps}
    for label, cd in [("f32", None), ("bf16", "bfloat16")]:
        cfg = TrainConfig(batch_size=batch, compute_dtype=cd)
        step = make_train_step(cfg)
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 device)
        sec, loss = _seconds_per_step(lambda: step(state, x, y)[1]["loss"],
                                      steps)
        out[label + "_step_ms"] = 1e3 * sec
        out[label + "_frames_per_sec"] = batch / sec
        out[label + "_final_loss"] = loss
    out["speedup"] = out["f32_step_ms"] / out["bf16_step_ms"]

    xc = torch.from_numpy(rng.integers(
        0, 255, size=(SIMCLR_BATCH, *SIMCLR_HW, 3), dtype=np.uint8)).to(device)
    for label, cd, fast in [("simclr_f32", None, False),
                            ("simclr_bf16", "bfloat16", False),
                            ("simclr_fast", None, True),
                            ("simclr_fast_bf16", "bfloat16", True)]:
        ccfg = ContrastiveConfig(batch_size=SIMCLR_BATCH, compute_dtype=cd,
                                 fast_augment=fast)
        cstep = make_contrastive_step(ccfg)
        cstate = init_contrastive_state(torch.Generator().manual_seed(0),
                                        ccfg, device)
        gen = torch.Generator().manual_seed(0)
        sec, _ = _seconds_per_step(
            lambda: cstep(cstate, gen, xc)[1]["loss"], steps)
        out[label + "_step_ms"] = 1e3 * sec
    for label in ("simclr_bf16", "simclr_fast", "simclr_fast_bf16"):
        out[label + "_speedup"] = (out["simclr_f32_step_ms"]
                                   / out[label + "_step_ms"])
    return out


def parse(argv) -> tuple[int, int, bool]:
    """``[batch] [steps] [--cpu]`` -> (batch, steps, cpu)."""
    cpu = "--cpu" in argv
    pos = [a for a in argv if a != "--cpu"]
    batch = int(pos[0]) if len(pos) > 0 else 128
    steps = int(pos[1]) if len(pos) > 1 else 30
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
