"""A run loads neither JAX nor the JAX package (by whole top-level name:
the port's name begins with the JAX package's), and a run that cannot
measure prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from cutbench.harness.main import FORBIDDEN, forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert not forbidden_modules()
    monkeypatch.setitem(sys.modules, "cut_detection_tpu_torch_fake", None)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", None)
    assert not forbidden_modules()
    for name in ("cut_detection_tpu.models", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, None)
    assert forbidden_modules() == sorted(FORBIDDEN)


RUN_EVERY_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
from cutbench.harness import main
from cutbench.tests import small
for name in ("prod_net.game_u8chain", "prod_net.train_sup",
             "simclr_net.pretrain"):
    small.run(name, seconds=0.1, trace=name == "prod_net.train_sup")
print(json.dumps({{"forbidden": main.forbidden_modules(),
                   "port": "cut_detection_tpu_torch" in sys.modules}}))
"""


def test_a_run_of_every_cell_loads_no_jax():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c",
                          RUN_EVERY_CELL.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"forbidden": [], "port": True}


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_without_a_card_a_run_prints_nothing(no_card):
    out = subprocess.run(
        [sys.executable, "cutbench/run.py", "--workload",
         "prod_net.game_u8chain", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cutbench"), tmp_path / "cutbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "cutbench/run.py", "--workload",
         "prod_net.train_sup", "--seed", "5", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
