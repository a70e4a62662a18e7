"""One run of one cell: find its files by name, drive it, print the result.

``BENCHMARK.json`` names the cell; its configuration is the file the
manifest gives, its mix ``cutbench/traffic/<traffic>.json``, its limits
``cutbench/limits/<workload>.json`` and each metric
``cutbench/metrics/<metric>.py``.  The mix's ``entry`` names the
program entry it drives (``classify``, ``train_supervised``,
``train_simclr``) and so the harness code that runs it.

The last line of standard output is the result; the numbers compared
for ``correct`` close standard error, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Modules that must not be loaded in a run, by whole top-level name: the
# JAX package is the port's source, not what is measured.
FORBIDDEN = ("jax", "jaxlib", "flax", "cut_detection_tpu")
# One host thread for torch's CPU ops: the program's host work is launches
# and a few small draws, and a pool of spinning threads on the card's
# shared host made runs of the SimCLR cell 15-20% slower and far noisier.
HOST_THREADS = 1


def cache_env(root: str = ROOT) -> None:
    """Kernel build and compile caches at fixed paths in the checkout, so
    only a cell's first run there builds."""
    cache = os.path.join(root, "build", "cutbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start_wall() -> float:
    """This process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


class Clock:
    """Set-up runs from the process's start to the first timed batch."""

    def __init__(self, started: float):
        self.started = started
        self.setup_s = None

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.started
        self.mark("window starts")

    def mark(self, what: str) -> None:
        """Log a step of set-up with its time since the process started."""
        print(f"cutbench: {time.time() - self.started:.3f} s {what}",
              file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of the manifest with its files."""

    def __init__(self, workload: dict, manifest: dict, root: str = ROOT):
        name = workload["name"]
        self.workload, self.name, self.root = workload, name, root
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(os.path.join(
            root, configs[workload["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            root, "cutbench", "traffic", workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(
            root, "cutbench", "limits", name + ".json"))
        self.chips = workload["chips"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    @classmethod
    def named(cls, name: str, root: str = ROOT) -> "Cell":
        manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return cls(cells[name], manifest, root)


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, clock: Clock, traffic: dict | None = None):
        self.config = cell.config
        self.traffic = cell.traffic if traffic is None else traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.clock = device, clock

    def memory_peak(self) -> int:
        import torch

        if torch.device(self.device).type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))


def runner(name: str):
    if name == "classify":
        from cutbench.harness import classify
        return classify.drive
    if name in ("train_supervised", "train_simclr"):
        from cutbench.harness import train
        return train.drive
    raise KeyError(f"no runner for entry {name!r}")


def read_metric(root: str, name: str, ctx: dict):
    path = os.path.join(root, "cutbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "cutbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            clock: Clock, traffic: dict | None = None) -> dict:
    """Drive the cell once and build the result (without printing it)."""
    from cut_detection_tpu_torch.utils.device import strict_fp32

    strict_fp32()  # as the program's entry points do
    run = Run(cell, seed, seconds, trace, device, clock, traffic)
    clock.mark("torch and the program's modules imported")
    out = runner(run.traffic["entry"])(run)
    log_rates(out)
    ctx = {"config": run.config, "traffic": run.traffic, "out": out,
           "setup_s": clock.setup_s}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(cell.root, m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {k: {"value": v, "limit": cell.limits[k]}
                for k, v in out["gaps"].items()}
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, cell.chips,
                                    out["memory_peak_bytes"])}
    summary = out.get("trace")
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = compared
    return result


def log_rates(out: dict, chunk_s: float = 5.0) -> None:
    """Log the window's hand-offs a second, in chunks of ``chunk_s``, so
    a drift inside the window shows."""
    ticks = out.get("ticks") or []
    if len(ticks) < 2:
        return
    rates, lo = [], 0
    for i, t in enumerate(ticks):
        if t - ticks[lo] >= chunk_s:
            rates.append((i - lo) / (t - ticks[lo]))
            lo = i
    print("cutbench: hand-offs a second by 5-s chunk: "
          + " ".join(f"{r:.2f}" for r in rates), file=sys.stderr)


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse(argv)
    cache_env()
    clock = Clock(started)
    cell = Cell.named(args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"cutbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), clock)
    loaded = forbidden_modules()
    if loaded:
        print(f"cutbench: the run loaded {', '.join(loaded)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0
