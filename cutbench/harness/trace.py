"""The traced run: ``torch.profiler`` over a slice of the window, reduced
in memory.

A trace of every op of a 51-second window holds millions of events and
takes minutes to read back, so the traced run profiles a slice of its
window (``SLICE_S`` seconds from ``LEAD_S`` in, or the whole of a shorter
window), opened and closed at the harness's hand-offs of batches or
steps.  The slice is marked with a ``record_function`` span
(``WINDOW``), so its bounds are read in the profiler's own clock, and
the card is synchronized before it closes, so the work of every batch
handed off inside the slice lies inside it.  The profiler is started and
stopped once during set-up, so that its own start-up is not in the
window.

Device events are every event the profiler records on the card:
kernels, copies and sets, but not the device-side mirrors of host spans.
The reduction gives, over the slice:

- ``handoffs``: the batches or steps handed off inside it;
- ``busy_s``: the union of device events;
- ``kernel_s``: the summed time of kernels (events that are neither a
  copy nor a set);
- ``htod_s``: the summed time of host-to-device copies;
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the ten longest gaps between device events, each named
  by the innermost host span open at its middle (``host (untraced)``
  where none is).

Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = "cutbench.window"
LEAD_S = 5.0
SLICE_S = 12.0


class Tracer:
    """``tick(now)`` at every hand-off of the window; ``finish()`` after
    it.  ``summary`` is None where the run is not traced."""

    def __init__(self, enabled: bool, device, seconds: float):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.seconds = seconds
        self.summary = None
        self.handoffs = 0
        self.state = "idle"
        if enabled:
            warm = self._profiler()
            warm.start()
            warm.stop()

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def begin(self, t0: float) -> None:
        """The window opens at host time ``t0``."""
        lead = LEAD_S if self.seconds >= LEAD_S + SLICE_S else 0.0
        self.lo = t0 + lead
        self.hi = self.lo + SLICE_S

    def tick(self, now: float) -> None:
        if not self.enabled:
            return
        if self.state == "on" and now >= self.hi:
            self._close()
        elif self.state == "idle" and now >= self.lo:
            self.prof = self._profiler()
            self.prof.start()
            self.span = torch.profiler.record_function(WINDOW)
            self.span.__enter__()
            self.state = "on"
        if self.state == "on":
            self.handoffs += 1

    def _close(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"

    def finish(self) -> None:
        if self.state == "on":
            self._close()
        if self.state == "done":
            events = self.prof.profiler.kineto_results.events()
            self.summary = summarise(events)
            self.summary["handoffs"] = self.handoffs
            del self.prof


def _is_device(event) -> bool:
    return str(event.device_type()).split(".")[-1] != "CPU"


def summarise(events) -> dict:
    cpu_name, cpu_start, cpu_end = [], [], []
    dev_name, dev_start, dev_end = [], [], []
    window = None
    for e in events:
        if _is_device(e):
            # A host span's mirror on the device timeline (record_function,
            # the optimizer's step span) is no work of the device's own.
            if e.is_user_annotation():
                continue
            dev_name.append(e.name())
            dev_start.append(e.start_ns())
            dev_end.append(e.end_ns())
        elif e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns())
        else:
            cpu_name.append(e.name())
            cpu_start.append(e.start_ns())
            cpu_end.append(e.end_ns())
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    lo, hi = window
    ds, de = np.asarray(dev_start, np.int64), np.asarray(dev_end, np.int64)
    keep = (de > lo) & (ds < hi)
    ds, de = np.clip(ds[keep], lo, hi), np.clip(de[keep], lo, hi)
    names = np.asarray(dev_name, dtype=object)[keep]
    dur = (de - ds).astype(np.float64) * 1e-9
    is_copy = np.array([n.startswith("Memcpy") for n in names], bool)
    is_set = np.array([n.startswith("Memset") for n in names], bool)
    is_htod = np.array([n.startswith("Memcpy HtoD") for n in names], bool)

    # Union of device intervals, and the gaps between them.
    order = np.argsort(ds, kind="stable")
    merged = []
    for s, e in zip(ds[order].tolist(), de[order].tolist()):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_ns = sum(e - s for s, e in merged)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)

    cs, ce = np.asarray(cpu_start, np.int64), np.asarray(cpu_end, np.int64)
    idle = []
    for s, e in gaps[:10]:
        mid = (s + e) // 2
        inside = np.nonzero((cs <= mid) & (ce >= mid))[0]
        label = ("host (untraced)" if inside.size == 0
                 else cpu_name[int(inside[np.argmax(cs[inside])])])
        idle.append([label, (e - s) * 1e-9])

    by_name: dict = {}
    for n, d in zip(names.tolist(), dur.tolist()):
        by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernel_s": float(dur[~is_copy & ~is_set].sum()),
        "htod_s": float(dur[is_htod].sum()),
        "device_events": int(names.size),
        "device_ops": [[n, d] for n, d in top],
        "idle_gaps": idle,
    }
