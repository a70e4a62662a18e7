"""``bench_pipeline``: the pipeline's decode, classify and end-to-end rates.

Counterpart of ``cut_detection_tpu/cli/bench_pipeline.py`` (``:25-123``),
with the JAX parser's flags and defaults.  Each stage prints one JSON
line with the JAX keys (``metric``, ``value``, ``unit``, and ``frames``
for ``e2e``), values in frames/s:

- ``decode``: host decode and resize to width 256 alone, sequential
  (``VideoFrameSource``) and chunk-parallel (``ParallelVideoReader``,
  ``--decode-workers``), both cv2, up to ``--frame-limit`` frames;
- ``classify``: the device-resident classify loop (``bench_classify``),
  the port's counterpart of ``bench.py:198-264`` (``bench_ours``), no
  host I/O;
- ``e2e``: ``pipeline.classify_video`` on the video (decode, upload,
  step, fetch).

The model runs on the CUDA device, or on the CPU with ``--cpu`` (the
decode stage runs on the host either way); without a CUDA device and
without ``--cpu`` it stops with an error.

    python -m cut_detection_tpu_torch.cli.bench_pipeline VIDEO.mp4 \\
        [--stages decode classify e2e] [--decode-workers N] \\
        [--batch-size N] [--frame-limit N] [--precision P] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging

MODEL_HW = (144, 256)  # the model's input at the reference resize of 256
STEPS = 128  # classify calls per timed block, as in ``bench.py``


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Benchmark the pipeline stage by stage.")
    p.add_argument("input_path", type=str, help="Video to benchmark with.")
    p.add_argument("--stages", nargs="+",
                   default=["decode", "classify", "e2e"],
                   choices=["decode", "classify", "e2e"])
    p.add_argument("--decode-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--frame-limit", type=int, default=2000)
    p.add_argument("--precision",
                   choices=list(PRECISION_CHOICES),
                   default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="Run the model on the CPU (otherwise a CUDA device "
                        "is required).")
    return p


def bench_decode(path: str, workers: int, limit: int) -> list[dict]:
    from cut_detection_tpu_torch.data.video import (
        ParallelVideoReader,
        VideoFrameSource,
    )

    out = []
    for tag, make in (
        ("decode_sequential", lambda: VideoFrameSource(path, resize=256)),
        ("decode_parallel",
         lambda: ParallelVideoReader(path, resize=256, num_threads=workers)),
    ):
        # A VideoFrameSource is its own iterator; a ParallelVideoReader's
        # is a generator whose close() stops its decode threads.
        frames = iter(make())
        n = 0
        t0 = time.perf_counter()
        try:
            for _ in frames:
                n += 1
                if n >= limit:
                    break
            dt = time.perf_counter() - t0
        finally:
            frames.close()
        out.append({"metric": tag, "value": round(n / dt, 1),
                    "unit": "frames/sec"})
    return out


def bench_classify(batch: int, precision: str, seconds: float = 8.0, *,
                   device) -> dict:
    """The device-resident classify loop: the bundled classifier at
    ``precision`` with the preprocess folded into layer 1 and the ring
    constants computed once, as the pipeline's step runs it, on a seeded
    uint8 batch of ``batch`` 144x256 frames resident on ``device``.  Each
    call adds its index to the frames (uint8, wrapping), so no two calls
    see the same input, and adds the sum of its logits to an accumulator
    on the device, which is fetched once per block of ``STEPS`` calls.
    Blocks run until at least ``seconds`` have passed, after one warm-up
    call; returns the ``classify_device`` line in frames/s."""
    import torch

    from cut_detection_tpu_torch.models.assembly import (
        folded_input,
        load_default_net,
        precompute_rings,
    )
    from cut_detection_tpu_torch.pipeline import frozen_copy

    net, _ = load_default_net(device, precision)
    folded = frozen_copy(net)
    rings = precompute_rings(folded, *MODEL_HW)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 256, size=(batch, *MODEL_HW, 3), dtype=np.uint8)).to(device)
    acc = torch.zeros((), dtype=torch.float32, device=device)
    calls = 0

    @torch.inference_mode()
    def block(k: int) -> float:
        nonlocal calls
        for _ in range(k):
            x = frames + (calls & 255)
            acc.add_(folded(folded_input(x), rings).sum())
            calls += 1
        return float(acc)

    block(1)  # warm-up: kernel build, allocator, first launch
    n = 0
    t0 = time.perf_counter()
    while True:
        block(STEPS)
        n += STEPS * batch
        if time.perf_counter() - t0 >= seconds:
            break
    fps = n / (time.perf_counter() - t0)
    return {"metric": f"classify_device ({precision})",
            "value": round(fps, 1), "unit": "frames/sec"}


def bench_e2e(path: str, workers: int, batch: int, limit: int,
              precision: str, *, device) -> dict:
    from cut_detection_tpu_torch.pipeline import classify_video

    _, _, stats = classify_video(path, device=device, batch_size=batch,
                                 frame_limit=limit, decode_workers=workers,
                                 print_every=0, precision=precision)
    return {"metric": "e2e_classify", "value": round(stats.frames_per_sec, 1),
            "unit": "frames/sec", "frames": stats.frames}


def main(args=None) -> list[dict]:
    parser = build_parser()
    ns = parser.parse_args(args)
    setup_logging("WARNING")

    from cut_detection_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32,
    )

    try:
        device = resolve_device(cpu=ns.cpu)
    except RuntimeError as e:
        parser.error(str(e))
    strict_fp32()

    results = []
    if "decode" in ns.stages:
        results.extend(bench_decode(ns.input_path, ns.decode_workers,
                                    ns.frame_limit))
    if "classify" in ns.stages:
        results.append(bench_classify(ns.batch_size, ns.precision,
                                      device=device))
    if "e2e" in ns.stages:
        results.append(bench_e2e(ns.input_path, ns.decode_workers,
                                 ns.batch_size, ns.frame_limit, ns.precision,
                                 device=device))
    for r in results:
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
