"""The traffic generator: the same seed gives the same frames, another
seed other frames of the same sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cutbench.harness import traffic as gen

SMALL = {"batch": 4, "height": 36, "width": 64, "pool_batches": 3,
         "noise": 12, "shots": {"share": [0.55, 0.35, 0.10],
                                "min_frames": 2, "tail_alpha": 1.3,
                                "max_frames": 40}}
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_pool():
    a, la = gen.frame_pool(SMALL, BIG_SEED, torch.device("cpu"))
    b, lb = gen.frame_pool(SMALL, BIG_SEED, torch.device("cpu"))
    assert a.shape == (3, 4, 36, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_other_seed_other_content_same_sizes():
    a, la = gen.frame_pool(SMALL, BIG_SEED, torch.device("cpu"))
    b, lb = gen.frame_pool(SMALL, BIG_SEED + 1, torch.device("cpu"))
    assert a.shape == b.shape and la.shape == lb.shape
    assert not np.array_equal(a, b)


def test_shots_are_heavy_tailed_and_of_every_kind():
    shots = dict(SMALL["shots"], min_frames=8, max_frames=1800)
    shot_of_frame, kinds = gen.shot_table(20000, shots, 7)
    lengths = np.bincount(shot_of_frame)
    # The last shot is cut where the pool ends.
    assert lengths[:-1].min() >= 8 and lengths.max() > 10 * np.median(lengths)
    assert set(kinds.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 33 + 5])
def test_sub_seeds_fit_a_generator(seed):
    s = [gen.sub_seed(seed, k) for k in range(4)]
    assert len(set(s)) == 4 and all(0 <= x < 2 ** 63 for x in s)
    torch.Generator().manual_seed(s[0])
