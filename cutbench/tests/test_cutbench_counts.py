"""The yardstick's operation and byte counts against counts by hand."""

from __future__ import annotations

import json
import os

import pytest

from cutbench.harness import counts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(*parts):
    with open(os.path.join(ROOT, "cutbench", *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def prod():
    return _load("configs", "prod_net.json")


@pytest.fixture(scope="module")
def simclr():
    return _load("configs", "simclr_net.json")


def test_prod_net_forward_flops_by_layer(prod):
    m = prod["model"]
    # 3x3 'same' convs, two FLOPs a multiply-add, max pool 3/3 between.
    layer1 = 2 * 144 * 256 * 3 * 48 * 9      # 95.6 M
    layer2 = 2 * 48 * 85 * 48 * 48 * 9       # 169.2 M
    layer3 = 2 * 16 * 28 * 48 * 48 * 9      # 18.6 M
    head = 2 * 768 * 32 + 2 * 32 * 3         # about 0.05 M
    assert layer1 == pytest.approx(95.6e6, rel=2e-3)
    assert layer2 == pytest.approx(169.2e6, rel=2e-3)
    assert layer3 == pytest.approx(18.6e6, rel=2e-3)
    assert head == pytest.approx(0.05e6, rel=0.02)
    total = counts.forward_flops(m, 144, 256)
    assert total == layer1 + layer2 + layer3 + head
    assert total == pytest.approx(0.283e9, rel=2e-3)


def test_simclr_encoder_flops_per_view(simclr):
    total = counts.forward_flops(simclr["model"], 144, 256)
    assert total == pytest.approx(0.147e9, rel=2e-3)


def test_param_count_of_the_prod_net(prod):
    # 67,971 trainable (PERF.md) + 2 * (3 * 48 + 32) BN running statistics.
    assert counts.param_count(prod["model"]) == 67971 + 2 * (3 * 48 + 32)


def test_classify_step_least_time_is_operation_bound(prod):
    traffic = _load("traffic", "game.json")
    ops = 128 * counts.forward_flops(prod["model"], 144, 256)
    assert counts.classify_step_least_s(prod, traffic) == pytest.approx(
        ops / 1979e12)
    assert counts.classify_step_bytes(prod["model"], 128, 144, 256) \
        / 3.35e12 < ops / 1979e12


def test_training_flops_count_every_view(prod, simclr):
    sup = _load("traffic", "train_sup.json")
    pre = _load("traffic", "simclr_step.json")
    assert counts.train_flops_per_item(prod, sup) == \
        3 * counts.forward_flops(prod["model"], 144, 256)
    assert counts.train_flops_per_item(simclr, pre) == \
        6 * counts.forward_flops(simclr["model"], 144, 256)
