"""The seeded mp4 clip that the full-game and decode benches read.

Copy of ``bench._make_bench_clip`` (``bench.py:303-332``): scenes of 60 to
399 frames in four flat colours with U(0, 30) noise, drawn from a pool of
at most 16 noisy frames per scene so that writing runs at the encoder's
pace; seed 7, mp4v, 640x360 at 30 fps.  The file is written once per path
and reused while it exists; it is written beside it and renamed into
place, so a run cut short leaves no truncated clip to reuse.
"""

from __future__ import annotations

import os

import numpy as np


def make_bench_clip(path: str, frames: int, w: int = 640,
                    h: int = 360) -> str:
    """Write (once) ``frames`` frames of the seeded clip to ``path``;
    returns ``path``."""
    if os.path.isfile(path):
        return path
    import cv2

    root, ext = os.path.splitext(path)
    part = f"{root}.part{ext}"
    wr = cv2.VideoWriter(part, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {part}")
    rng = np.random.default_rng(7)
    colors = [(40, 120, 40), (10, 10, 10), (150, 60, 60), (60, 60, 140)]
    left = frames
    i = 0
    while left > 0:
        n = min(left, int(rng.integers(60, 400)))
        base = np.full((h, w, 3), colors[i % len(colors)], np.uint8)
        pool = [cv2.add(base,
                        rng.integers(0, 30, (h, w, 3), dtype=np.uint8))
                for _ in range(min(n, 16))]
        for j in range(n):
            wr.write(pool[j % len(pool)])
        left -= n
        i += 1
    wr.release()
    os.replace(part, path)
    return path
