"""Cells at a size a CPU test run holds: the cell's widths and frame
sizes, fewer frames a batch and a smaller pool.

``simclr_net.pretrain`` is staged: its configuration, mix, limits and
reference are in ``cutbench/`` and tested here, but the cell is not in
``BENCHMARK.json`` (PERF.md says why), so its manifest entries are
added here."""

from __future__ import annotations

import copy
import os
import time

import torch

from cutbench.harness import main

SMALL = {"classify": {"batch": 4, "pool_batches": 2, "length": 16},
         "train_supervised": {"batch": 8, "pool_batches": 4},
         "train_simclr": {"batch": 4, "pool_batches": 4}}
CPU = torch.device("cpu")
STAGED = {"name": "simclr_net.pretrain", "config": "simclr_net",
          "traffic": "simclr_step", "chips": 1}


def manifest() -> dict:
    """``BENCHMARK.json`` with the staged cell's entries added."""
    out = copy.deepcopy(main.load_json(os.path.join(main.ROOT,
                                                    "BENCHMARK.json")))
    out["configs"].append({"name": "simclr_net",
                           "file": "cutbench/configs/simclr_net.json"})
    out["workloads"].append(dict(STAGED))
    for m in out["end_to_end"] + out["per_layer"]:
        if "prod_net.train_sup" in m.get("workloads", []):
            m["workloads"].append(STAGED["name"])
    return out


def cell_and_traffic(name: str):
    m = manifest()
    cell = main.Cell({w["name"]: w for w in m["workloads"]}[name], m)
    return cell, dict(cell.traffic, **SMALL[cell.traffic["entry"]])


def run(name: str, seed: int = 2 ** 31 + 77, seconds: float = 0.3,
        trace: bool = False) -> dict:
    """One run of the cell on the CPU, without the look for a card."""
    cell, traffic = cell_and_traffic(name)
    return main.execute(cell, seed, seconds, trace, CPU,
                        main.Clock(time.time()), traffic)
