"""Throughput metering of the classify loop.

Copy of ``ThroughputMeter`` from ``cut_detection_tpu/utils/profiling.py:15``.
"""

from __future__ import annotations

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
