"""Throughput metering of the classify loop, and the profiler hook.

``ThroughputMeter`` is a copy of ``cut_detection_tpu/utils/profiling.py:15``;
``maybe_trace`` is the counterpart of its ``:60-84`` on ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time


class ThroughputMeter:
    """Tracks items/sec over a run, with warmup exclusion.

    ``warmup_items`` items are excluded from the steady-state rate so a
    first call's set-up (a kernel build, cuDNN's autotuning) doesn't
    poison the measurement.
    """

    def __init__(self, warmup_items: int = 0):
        self.warmup_items = warmup_items
        self.total_items = 0
        self._t0 = None
        self._steady_t0 = None
        self._steady_items = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def update(self, n: int) -> None:
        if self._t0 is None:
            self.start()
        self.total_items += n
        if self._steady_t0 is None and self.total_items >= self.warmup_items:
            self._steady_t0 = time.perf_counter()
            self._steady_items = self.total_items

    @property
    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    @property
    def rate(self) -> float:
        """Overall items/sec including warmup."""
        e = self.elapsed
        return self.total_items / e if e > 0 else 0.0

    @property
    def steady_rate(self) -> float:
        """Items/sec excluding the warmup window."""
        if self._steady_t0 is None:
            return self.rate
        e = time.perf_counter() - self._steady_t0
        n = self.total_items - self._steady_items
        return n / e if e > 0 else 0.0


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, *, cuda: bool = False):
    """Trace the region with ``torch.profiler`` when ``trace_dir`` is set,
    and write the trace into that directory as a Chrome trace
    (``trace_<pid>_<time>.json``, readable in Perfetto or
    chrome://tracing): host activity, and the card's with ``cuda``.

    A profiler that fails to start, or a trace that cannot be written,
    logs a warning and the run goes on, as with the JAX hook: tracing must
    never take down a production run.  It hides no device or kernel.
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    log = logging.getLogger(__name__)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # a boundary: the run must go on untraced
        log.warning("profiler unavailable: %s", e)
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(trace_dir, f"trace_{os.getpid()}_"
                            f"{time.strftime('%Y%m%d-%H%M%S')}.json")
        try:
            prof.export_chrome_trace(path)
            log.info("Wrote the profiler trace to %s", path)
        except (OSError, RuntimeError) as e:
            log.warning("could not write the profiler trace: %s", e)
