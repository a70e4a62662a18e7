"""BENCHMARK.json against the contract the benchmark is checked by, and the
files each entry is found by."""

from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "cutbench/run.py"]
    assert bench["paths"] == ["cutbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(
        bench["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for text in ([w["why"] for w in bench["workloads"]]
                 + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_setup_and_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    assert all(w["chips"] == 1 for w in bench["workloads"])
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2, w["name"]
        layers = [m for m in bench["per_layer"]
                  if w["name"] in m["workloads"]]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in {r["name"] for r in reported}, m["name"]


def test_run_seconds_fits_a_full_check(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= bench["run_seconds"] <= 51 and total <= 43200


def test_every_cell_finds_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        assert cfg["file"].startswith("cutbench/")
        with open(os.path.join(ROOT, cfg["file"])) as f:
            assert json.load(f)["name"] == cfg["name"]
        for sub, name in (("traffic", w["traffic"] + ".json"),
                          ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(ROOT, "cutbench", sub, name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "cutbench", "metrics",
                                           m["name"] + ".py")), m["name"]


def test_file_names_use_name_characters():
    for base, _, files in os.walk(os.path.join(ROOT, "cutbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH.match(rel), rel


def test_limits_hold_every_compared_number(bench):
    from cutbench.harness.main import Cell

    expected = {"classify": {"conf_gap", "pred_gap"},
                "train_supervised": {"loss_gap", "grad_gap", "change_gap"},
                "train_simclr": {"loss_gap", "grad_gap", "change_gap"}}
    for w in bench["workloads"]:
        cell = Cell.named(w["name"], ROOT)
        assert set(cell.limits) == expected[cell.traffic["entry"]]
        assert all(v > 0 for v in cell.limits.values())
