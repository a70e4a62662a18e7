"""A cell's traced run with the program's spans reduced, on the card.

    python3 cutbench/tools/spans.py --workload W --seed N --seconds 51 \\
        [--out FILE]

Drives the cell once as ``run.py --trace 1`` does (the same runner,
profiled slice and summary), and adds ``harness/spans.py``'s reduction
of the same events.  On standard error: one ``cutbench: span`` line per
``cutdet`` span name (count, host time, its p95, device time, idle
time), the idle shares summed against the slice's device idle share, the
block kernels' launches a batch or step over the window
(``ops.kernels.launch_counts``), the readings of ``spans.READINGS``, the
slice's hand-offs a second against the untraced rest of the window, and
what one ``utils.profiling.span`` costs on this host with no profiler
and under one.  One JSON line of all of it on standard output, and in
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cutbench.harness import main as harness  # noqa: E402
from cutbench.harness import spans, trace  # noqa: E402

SPAN_CALLS = 100_000


def span_cost_us(device, calls: int = SPAN_CALLS) -> dict:
    """Microseconds a ``span`` enter and exit, with no profiler running
    and under one set up as the traced run's."""
    from torch.profiler import ProfilerActivity, profile

    from cut_detection_tpu_torch.utils.profiling import span

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def per_call(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with span("cutdet.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    per_call(1000)
    off = per_call(calls)
    with profile(activities=activities):
        on = per_call(calls // 10)
    return {"off": off, "on": on}


class WindowClock(harness.Clock):
    """Reads the kernels' launch counters as the window opens."""

    def setup_done(self) -> None:
        from cut_detection_tpu_torch.ops.kernels import launch_counts

        self.launches = launch_counts()
        super().setup_done()


def run(workload: str, seed: int, seconds: float, device=None,
        traffic: dict | None = None) -> dict:
    """The cell's traced run on ``device`` (the first card by default),
    at the cell's mix or ``traffic``."""
    import torch

    from cut_detection_tpu_torch.ops.kernels import launch_counts
    from cut_detection_tpu_torch.utils.device import strict_fp32

    clock = WindowClock(harness.process_start_wall())
    cell = harness.Cell.named(workload)
    device = torch.device("cuda", 0) if device is None else device
    reduce_trace = trace.summarise

    def summarise(events):
        events = list(events)
        out = reduce_trace(events)
        out["spans"] = spans.reduce(events)
        return out

    strict_fp32()
    r = harness.Run(cell, seed, seconds, True, device, clock, traffic)
    trace.summarise = summarise
    try:
        out = harness.runner(r.traffic["entry"])(r)
    finally:
        trace.summarise = reduce_trace
    summary, ticks = out["trace"], out["ticks"]
    handoffs = len(ticks)
    launched = {k: n - clock.launches[k] for k, n in launch_counts().items()
                if n != clock.launches[k]}
    idle_s = sum(v["idle_s"] for v in summary["spans"].values())
    lead = sum(t < ticks[0] + trace.LEAD_S for t in ticks)
    return {
        "workload": workload, "seed": seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "window_s": summary["window_s"], "busy_s": summary["busy_s"],
        "device_idle_pct": 100.0 * (1 - summary["busy_s"]
                                    / summary["window_s"]),
        "idle_pct_summed": 100.0 * idle_s / summary["window_s"],
        "handoffs": summary["handoffs"], "spans": summary["spans"],
        "readings": {n: spans.reading(n, summary) for n in spans.READINGS},
        "launches_a_handoff": {k: n / handoffs for k, n in launched.items()},
        "traced_handoffs_per_s": summary["handoffs"] / summary["window_s"],
        "untraced_handoffs_per_s": (
            (lead - 1) / (ticks[lead - 1] - ticks[0])
            if lead > 1 and lead < handoffs else None),
        "gaps": out["gaps"], "failed": out["failed"],
        "span_cost_us": span_cost_us(device),
    }


def report(result: dict) -> None:
    err = sys.stderr
    for name, v in sorted(result["spans"].items()):
        p95 = v["host_p95_ms"]
        print(f"cutbench: span {name} count {v['count']} host_s "
              f"{v['host_s']!r} host_p95_ms {p95!r} device_s "
              f"{v['device_s']!r} idle_s {v['idle_s']!r} idle_pct "
              f"{100 * v['idle_s'] / result['window_s']!r}", file=err)
    print(f"cutbench: span idle summed {result['idle_pct_summed']!r}% "
          f"against device idle {result['device_idle_pct']!r}%; batch or "
          f"step spans against hand-offs {result['handoffs']}", file=err)
    print("cutbench: launches a hand-off "
          + (" ".join(f"{k} {n!r}" for k, n in
                      sorted(result["launches_a_handoff"].items()))
             or "none"), file=err)
    for name, value in result["readings"].items():
        print(f"cutbench: reading {name} {value!r}", file=err)
    print(f"cutbench: hand-offs a second traced "
          f"{result['traced_handoffs_per_s']!r} before the trace "
          f"{result['untraced_handoffs_per_s']!r}", file=err)
    print(f"cutbench: span cost us off {result['span_cost_us']['off']!r} "
          f"on {result['span_cost_us']['on']!r}", file=err)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)
    result = run(args.workload, args.seed, args.seconds)
    report(result)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
