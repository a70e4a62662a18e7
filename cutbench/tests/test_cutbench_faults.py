"""A run with the timed path broken underneath must come out not correct,
for each fault a cell can have, and an unbroken run correct; the
classify cell's control (the reference at int4 in the program's place)
fails its limits at a test size."""

from __future__ import annotations

import pytest
import torch

from cutbench.harness import classify
from cutbench.tests import small


def _alter_one_answer(monkeypatch):
    from cut_detection_tpu_torch import pipeline

    made = pipeline.device_step

    def broken(*args, **kwargs):
        step = made(*args, **kwargs)

        def altered(x):
            conf, pred = step(x)
            conf = conf.clone()
            conf[0] += 1.0
            return conf, pred
        return altered
    monkeypatch.setattr(pipeline, "device_step", broken)


def _classify_half_batch(monkeypatch):
    from cut_detection_tpu_torch import pipeline

    made = pipeline.device_step

    def broken(*args, **kwargs):
        step = made(*args, **kwargs)

        def halved(x):
            conf, pred = step(x[: x.shape[0] // 2])
            return conf.repeat(2), pred.repeat(2)
        return halved
    monkeypatch.setattr(pipeline, "device_step", broken)


def _state_unchanged(monkeypatch):
    from cut_detection_tpu_torch.train import contrastive, supervised

    def no_update(state, loss, group=None):
        loss.backward()
    monkeypatch.setattr(supervised, "optimizer_step", no_update)
    monkeypatch.setattr(contrastive, "optimizer_step", no_update)


def _train_half_batch(monkeypatch):
    from cut_detection_tpu_torch.train import contrastive, supervised

    ce, ntxent = supervised.cross_entropy_sum, contrastive.ntxent_loss

    def half_ce(logits, labels):
        n = logits.shape[0] // 2
        return 2.0 * ce(logits[:n], labels[:n])

    def half_ntxent(x, **kwargs):
        b = x.shape[0] // 2
        h = b // 2
        return ntxent(torch.cat([x[:h], x[b:b + h]]), **kwargs)
    monkeypatch.setattr(supervised, "cross_entropy_sum", half_ce)
    monkeypatch.setattr(contrastive, "ntxent_loss", half_ntxent)


FAULTS = {"answer_altered": _alter_one_answer,
          "classify_half_batch": _classify_half_batch,
          "state_unchanged": _state_unchanged,
          "train_half_batch": _train_half_batch}
CASES = [("prod_net.game_u8chain", "answer_altered"),
         ("prod_net.game_u8chain", "classify_half_batch"),
         ("prod_net.train_sup", "state_unchanged"),
         ("prod_net.train_sup", "train_half_batch"),
         ("simclr_net.pretrain", "state_unchanged"),
         ("simclr_net.pretrain", "train_half_batch")]


@pytest.mark.parametrize("name", ["prod_net.game_u8chain",
                                  "prod_net.train_sup",
                                  "simclr_net.pretrain"])
def test_unbroken_run_is_correct(name):
    result = small.run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_run_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result = small.run(name)
    assert not result["correct"], result["checks"]


def test_classify_control_fails_its_limits():
    cell, traffic = small.cell_and_traffic("prod_net.game_u8chain")
    frames, state = classify.build(cell.config, traffic, 2 ** 31 + 9,
                                   small.CPU)
    gaps = classify.control_gaps(cell.config, traffic, frames, state,
                                 small.CPU)
    assert any(v > cell.limits[k] for k, v in gaps.items()), gaps
