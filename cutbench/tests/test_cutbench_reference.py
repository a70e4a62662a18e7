"""The benchmark's plain reference against the port, at a small size on
the CPU: the uint8_chain classify step and one step of each training
cell, held to the cells' own limits."""

from __future__ import annotations

import time

import pytest
import torch

from cutbench.harness import classify, main, train
from cutbench.reference import model as ref
from cutbench.tests.small import CPU, cell_and_traffic

SEED = 2 ** 31 + 5


def test_uint8_chain_step_matches_the_reference():
    from cut_detection_tpu_torch.pipeline import classify_batches

    cell, traffic = cell_and_traffic("prod_net.game_u8chain")
    frames, state = classify.build(cell.config, traffic, SEED, CPU)
    net = classify.program_net(cell.config, traffic, state, CPU)
    batches = [(b, b.shape[0]) for b in frames]
    conf, pred, _ = classify_batches(iter(batches), net,
                                     batch_size=traffic["batch"],
                                     length=traffic["length"], print_every=0)
    ref_all = classify.reference_logits(cell.config, state, frames, CPU, 255)
    gaps = classify.window_gaps(conf, pred, ref_all)
    assert gaps["conf_gap"] <= cell.limits["conf_gap"]
    assert gaps["pred_gap"] <= cell.limits["pred_gap"]


def test_float32_forward_matches_the_port():
    cell, traffic = cell_and_traffic("prod_net.game_u8chain")
    frames, state = classify.build(cell.config, traffic, SEED, CPU)
    net = classify.program_net(cell.config, dict(traffic,
                                                 precision="float32"),
                               state, CPU)
    x = ref.bgr_u8_to_input(torch.from_numpy(frames[0]))
    with torch.no_grad():
        ours = net(x.permute(0, 2, 3, 1).contiguous())
        theirs = ref.forward_eval(state, cell.config["model"], x)
    assert torch.allclose(ours, theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["prod_net.train_sup",
                                  "simclr_net.pretrain"])
def test_training_steps_match_the_reference(name):
    cell, traffic = cell_and_traffic(name)
    frames, labels, state = train.build(cell.config, traffic, SEED, CPU)
    st, call = train.program(cell.config, traffic, state, SEED, CPU)
    compared, _ = train.run_steps(st, call, frames, labels, 0.0, False, CPU,
                                  main.Clock(time.time()))
    ref_out = train.reference(cell.config, traffic, state, frames, labels,
                              SEED, CPU)
    gaps = train.gaps(cell.config, state, compared, ref_out)
    for key, value in gaps.items():
        assert value <= cell.limits[key], (key, value)
