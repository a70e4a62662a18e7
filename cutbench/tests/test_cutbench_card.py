"""On the card: the training cells' control (the reference with TF32 on,
in the program's place) fails the cells' limits, and the program passes
them, at a size a test run holds.  Run on the card with
``python -m pytest cutbench/tests/test_cutbench_card.py -q``."""

from __future__ import annotations

import time

import pytest
import torch

from cutbench.harness import main, train
from cutbench.tests.small import cell_and_traffic


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from cut_detection_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["prod_net.train_sup",
                                  "simclr_net.pretrain"])
def test_tf32_control_fails_and_the_program_passes(card, name):
    cell, traffic = cell_and_traffic(name)
    traffic["batch"] = 32
    seed = 2 ** 31 + 21
    frames, labels, state = train.build(cell.config, traffic, seed, card)
    st, call = train.program(cell.config, traffic, state, seed, card)
    compared, _ = train.run_steps(st, call, frames, labels, 0.0, False, card,
                                  main.Clock(time.time()))
    ref_out = train.reference(cell.config, traffic, state, frames, labels,
                              seed, card)
    ours = train.gaps(cell.config, state, compared, ref_out)
    assert all(v <= cell.limits[k] for k, v in ours.items()), ours
    low = train.reference(cell.config, traffic, state, frames, labels,
                          seed, card, tf32=True)
    control = train.gaps(cell.config, state, {"losses": low[0],
                                              "grads": low[1],
                                              "after": low[2]}, ref_out)
    assert any(v > cell.limits[k] for k, v in control.items()), control
