"""The general traffic generator: seeded frame pools from a mix's file.

A mix (``cutbench/traffic/<name>.json``) gives the sizes and the shot
statistics; this module turns them and ``--seed`` into a pool of frames
in host memory, as a decoder's ring or a loader's queue holds them, and
the per-frame labels.  Frames are made on the run's device in a few
large calls and copied to pageable host memory once.

A pool is a sequence of shots, each of one kind, with heavy-tailed
lengths (a Pareto tail above ``min_frames``, cut at ``max_frames``), as
broadcast film cuts between long wide views and short inserts:

- ``all22``: a green field with sparse bright line texture;
- ``endzone``: a closer, warmer, more textured view;
- ``blank``: near-black frames with faint noise.

Every frame is its shot's base picture (random texture at two scales,
upsampled to the frame) plus per-frame noise and a small drift, so
neighbouring frames differ as decoded video does.  The sizes and the
number of frames do not depend on the seed: only the content does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KINDS = ("all22", "endzone", "blank")
# Per kind: base colour (channel order as stored), texture amplitude.
PALETTE = {
    "all22": ((60.0, 140.0, 70.0), 40.0),
    "endzone": ((120.0, 100.0, 150.0), 70.0),
    "blank": ((8.0, 8.0, 8.0), 4.0),
}
# Two scales of texture: the shot's layout, and finer detail (lines,
# players, crowd) at half the amplitude.
TEXTURE = (9, 16)
DETAIL = (36, 64)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams (weights, frames,
    augmentation), from ``--seed``."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    lo, hi = state.generate_state(2, np.uint32)
    return int((int(hi) << 32 | int(lo)) & (2 ** 63 - 1))


def shot_table(n_frames: int, shots: dict, seed: int) -> np.ndarray:
    """Each frame's shot index, and each shot's kind: ``(shot_of_frame
    int64 [n], kind_of_shot int64 [s])``."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    lengths = []
    total = 0
    while total < n_frames:
        u = rng.random()
        length = int(shots["min_frames"] * (1.0 - u) ** (-1.0 / shots[
            "tail_alpha"]))
        length = min(length, shots["max_frames"])
        lengths.append(length)
        total += length
    share = np.asarray(shots["share"], float)
    kinds = rng.choice(len(KINDS), size=len(lengths), p=share / share.sum())
    shot_of_frame = np.repeat(np.arange(len(lengths)), lengths)[:n_frames]
    return shot_of_frame, kinds


def frame_pool(traffic: dict, seed: int, device) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """``(frames uint8 [pool_batches, batch, H, W, 3], labels int64
    [pool_batches, batch])`` in host memory."""
    b, h, w = traffic["batch"], traffic["height"], traffic["width"]
    n = traffic["pool_batches"] * b
    shot_of_frame, kinds = shot_table(n, traffic["shots"], seed)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    n_shots = len(kinds)
    texture = torch.rand((n_shots, 3, *TEXTURE), generator=gen,
                         device=device) - 0.5
    detail = torch.rand((n_shots, 3, *DETAIL), generator=gen,
                        device=device) - 0.5
    colour = torch.tensor([PALETTE[KINDS[k]][0] for k in kinds],
                          device=device).reshape(n_shots, 3, 1, 1)
    amp = torch.tensor([PALETTE[KINDS[k]][1] for k in kinds],
                       device=device).reshape(n_shots, 1, 1, 1)
    base = colour + amp * (F.interpolate(texture, size=DETAIL,
                                         mode="bilinear",
                                         align_corners=False) + 0.5 * detail)
    noise = traffic["noise"]
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8)
    shot_t = torch.from_numpy(shot_of_frame).to(device)
    chunk = 256
    for lo in range(0, n, chunk):
        idx = shot_t[lo:lo + chunk]
        m = idx.shape[0]
        drift = (torch.rand((m, 3, 1, 1), generator=gen, device=device)
                 - 0.5) * 2 * noise
        up = F.interpolate(base[idx], size=(h, w), mode="bilinear",
                           align_corners=False)
        grain = torch.randint(-noise, noise + 1, (m, 3, h, w), generator=gen,
                              device=device, dtype=torch.int16)
        pix = (up + drift + grain).clamp(0, 255).to(torch.uint8)
        frames[lo:lo + m] = pix.permute(0, 2, 3, 1).cpu()
    labels = torch.as_tensor(kinds[shot_of_frame]).reshape(-1, b)
    return frames.numpy().reshape(-1, b, h, w, 3), labels.numpy()
