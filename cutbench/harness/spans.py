"""The program's own spans in a traced slice, and the readings taken from
them.

The port marks its phases with ``record_function`` spans named
``cutdet.<layer>.<phase>`` (``cut_detection_tpu_torch/utils/profiling.py``
lists them), on the profiler's clock with the card's kernels and copies.
``reduce(events)`` takes the same profiler events as
``trace.summarise`` and gives, for each span name:

- ``count``: the spans of the name that opened and closed inside the
  slice (``WINDOW``);
- ``host_s``: their summed duration, and ``host_p95_ms`` the 95th
  percentile of one's (``statistics.quantiles``, as the hand-off p95);
- ``device_s``: the summed device time (clipped to the slice) of the
  device events whose launch, found by the event's correlation id among
  the host's CUDA API calls, fell while the span was the
  innermost ``cutdet`` span open on the thread that opened the slice,
  whichever thread launched (autograd's device thread launches the
  backward's kernels while the loop's thread waits in
  ``cutdet.train.backward``);
- ``idle_s``: the time in the slice when no device event runs and the
  span is the innermost ``cutdet`` span open on that thread, each gap
  split over time between the spans it crosses.

Device time and idle time with no ``cutdet`` span open go under
``NONE``; the ``idle_s`` of all names and ``NONE`` add up to the slice's
``window_s - busy_s``.  A span still open when the slice closes counts
for idle and device time, not in ``count``.

``reading(name, summary)`` computes a per-layer metric (``READINGS``)
from a traced summary that holds ``spans``; None where it does not, or
where the spans it needs are missing.
"""

from __future__ import annotations

import bisect
import re
import statistics

from cutbench.harness.trace import WINDOW, _is_device

PREFIX = "cutdet."
NONE = "(none)"
# The host's CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync,
# cuLaunchKernel, ...), whose correlation ids are the device events'; a
# host op's own id may collide with one.
LAUNCH = re.compile(r"cu(da)?[A-Z]")


def _innermost(spans, lo: int, hi: int):
    """``(starts, ends, names)``: [lo, hi] cut where the innermost span of
    ``spans`` (``(start, end, name)``, nested, on one thread) changes."""
    marks = []
    for k, (s, e, _) in enumerate(spans):
        s, e = max(s, lo), min(e, hi)
        if s < e:
            marks.append((s, 1, -e, k))
            marks.append((e, 0, 0, k))
    marks.sort()
    open_, starts, ends, names = [], [], [], []
    t = lo
    for at, opens, _, k in marks:
        if at > t:
            starts.append(t)
            ends.append(at)
            names.append(spans[open_[-1]][2] if open_ else NONE)
            t = at
        if opens:
            open_.append(k)
        else:
            open_.remove(k)
    if hi > t:
        starts.append(t)
        ends.append(hi)
        names.append(NONE)
    return starts, ends, names


def _gaps(dev, lo: int, hi: int):
    """The gaps in [lo, hi] between the union of ``dev``'s intervals,
    merged as ``trace.summarise`` merges them."""
    merged = []
    for s, e in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return gaps


def reduce(events) -> dict:
    window, thread_spans, launched, dev = None, [], {}, []
    for e in events:
        if _is_device(e):
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name() == WINDOW:
            window = e
        elif e.name().startswith(PREFIX):
            thread_spans.append((e.start_ns(), e.end_ns(), e.name(),
                                 e.start_thread_id()))
        elif LAUNCH.match(e.name()):
            launched[e.correlation_id()] = e.start_ns()
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window.start_ns(), window.end_ns()
    spans = [(s, e, n) for s, e, n, tid in thread_spans
             if tid == window.start_thread_id()]
    starts, ends, names = _innermost(spans, lo, hi)

    def at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return names[i] if 0 <= i and t < ends[i] else NONE

    out: dict = {}

    def entry(name: str) -> dict:
        return out.setdefault(name, {"count": 0, "host_s": 0.0,
                                     "host_p95_ms": None, "device_s": 0.0,
                                     "idle_s": 0.0})

    durations: dict = {}
    for s, e, n in spans:
        if lo <= s and e < hi:
            durations.setdefault(n, []).append(e - s)
    for n, d in durations.items():
        ent = entry(n)
        ent["count"] = len(d)
        ent["host_s"] = sum(d) * 1e-9
        ent["host_p95_ms"] = (d[0] if len(d) == 1 else
                              statistics.quantiles(d, n=20)[18]) * 1e-6

    clipped = []
    for s, e, corr in dev:
        s, e = max(s, lo), min(e, hi)
        if s < e:
            clipped.append((s, e))
            launch = launched.get(corr)
            entry(NONE if launch is None else at(launch))["device_s"] += (
                (e - s) * 1e-9)

    gaps = _gaps(clipped, lo, hi)
    idle: dict = {}
    i = 0
    for gs, ge in gaps:
        while ends[i] <= gs:
            i += 1
        j = i
        while starts[j] < ge:
            cut = min(ge, ends[j]) - max(gs, starts[j])
            idle[names[j]] = idle.get(names[j], 0) + cut
            if ends[j] >= ge:
                break
            j += 1
    entry(NONE)
    for n, ns in idle.items():
        entry(n)["idle_s"] = ns * 1e-9
    return out


def _per(per: str, *names: str):
    """Mean summed ``host_s`` of ``names`` a ``per`` span, in ms."""
    def read(spans, window_s):
        if any(n not in spans for n in names) or not spans.get(
                per, {}).get("count"):
            return None
        return (sum(spans[n]["host_s"] for n in names)
                / spans[per]["count"] * 1e3)
    return read


def _idle_pct(name: str):
    def read(spans, window_s):
        if name not in spans:
            return None
        return 100.0 * spans[name]["idle_s"] / window_s
    return read


def _p95(name: str):
    def read(spans, window_s):
        return spans.get(name, {}).get("host_p95_ms")
    return read


BATCH, STEP = "cutdet.classify.batch", "cutdet.train.step"
READINGS = {
    "classify.upload_host_ms": _per(BATCH, "cutdet.classify.upload"),
    "classify.launch_ms": _per(BATCH, "cutdet.classify.step"),
    "classify.batch_span_p95_ms": _p95(BATCH),
    "classify.idle_upload_pct": _idle_pct("cutdet.classify.upload"),
    "classify.idle_launch_pct": _idle_pct("cutdet.classify.step"),
    "train.upload_host_ms": _per(STEP, "cutdet.train.upload"),
    "train.launch_ms": _per(STEP, "cutdet.train.forward",
                            "cutdet.train.backward", "cutdet.train.update"),
    "train.idle_upload_pct": _idle_pct("cutdet.train.upload"),
    "train.idle_forward_pct": _idle_pct("cutdet.train.forward"),
    "train.idle_backward_pct": _idle_pct("cutdet.train.backward"),
    "train.idle_update_pct": _idle_pct("cutdet.train.update"),
}


def reading(name: str, summary) -> float | None:
    """The metric ``name`` of ``READINGS`` from a traced summary, or None."""
    if summary is None or "spans" not in summary:
        return None
    return READINGS[name](summary["spans"], summary["window_s"])
