"""Threaded prefetch of decoded batches.

Copy of ``PrefetchLoader`` from ``cut_detection_tpu/data/loader.py:67``:
one producer thread keeps ``depth`` batches decoded ahead of the device
loop (cv2 releases the GIL while it decodes).
"""

from __future__ import annotations

import queue
import threading


class PrefetchLoader:
    """Iterator wrapper that prefetches ``depth`` batches on a thread."""

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2, on_close=None):
        if depth <= 0:
            # queue.Queue(maxsize=0) is unbounded: a depth of 0 would
            # prefetch the whole stream into host memory.
            raise ValueError(
                f"PrefetchLoader depth must be >= 1, got {depth} "
                "(for no prefetch, iterate the source directly)")
        self.iterable = iterable
        self.depth = depth
        self._stop = threading.Event()
        self._q: queue.Queue | None = None
        self._error: list[BaseException] = []
        self._consumed = False
        self._on_close = on_close
        self._close_lock = threading.Lock()

    def close(self) -> None:
        """Stop the producer thread (for consumers that break early, as
        ``--frame-limit`` does, so decode does not run ahead forever).
        Fires ``on_close`` exactly once, however many paths close the
        loader."""
        self._stop.set()
        with self._close_lock:
            cb, self._on_close = self._on_close, None
        if cb is not None:
            cb()

    def start(self) -> "PrefetchLoader":
        """Begin producing into the bounded queue now (idempotent);
        ``__iter__`` calls it, so the loader is single-use either way."""
        if self._q is not None:
            return self
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._q = q
        error = self._error
        sentinel = PrefetchLoader._SENTINEL

        def producer():
            try:
                for item in self.iterable:
                    while not self._stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                while True:
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        return self

    def __iter__(self):
        # Not a generator: the single-use check must fire at iter() time.
        if self._consumed:
            # A second pass would block forever on an empty queue whose
            # sentinel was already taken.
            raise RuntimeError("PrefetchLoader is single-use; construct "
                               "a new one to iterate again")
        self._consumed = True
        self.start()
        return self._drain(self._q)

    def _drain(self, q):
        try:
            while True:
                item = q.get()
                if item is PrefetchLoader._SENTINEL:
                    if self._error:
                        raise self._error[0]
                    return
                yield item
        finally:
            self.close()
