"""Batching and threaded prefetch of decoded batches.

Copy of ``_collate``, ``iter_batches`` and ``PrefetchLoader`` from
``cut_detection_tpu/data/loader.py:19-67``: ``iter_batches`` collates
dataset items into contiguous uint8 arrays (a thread pool loads them: cv2
releases the GIL while it decodes), and one producer thread keeps
``depth`` batches decoded ahead of the device loop.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading

import numpy as np


def _collate(items: list[dict]) -> dict:
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = np.asarray(vals[0])
        if first.ndim == 0:
            out[key] = np.asarray(vals)
        else:
            out[key] = np.stack(vals)
    return out


def iter_batches(dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int | None = None,
                 indices=None, num_workers: int = 0,
                 shard: tuple[int, int] | None = None):
    """Yield collated dict batches from an indexable dataset.

    ``indices`` restricts/reorders the dataset (torch ``Subset`` analog,
    supervised_training.py:75-76); ``shuffle`` permutes them with
    ``np.random.default_rng(seed)``, so a seed gives the JAX package's
    batch order.  ``shard=(rank, ranks)`` loads only that rank's rows of
    each batch, ``[rank n / ranks, (rank + 1) n / ranks)`` of its ``n``,
    which must divide (a data-parallel rank's share; the port's own
    addition).
    """
    if indices is None:
        indices = np.arange(len(dataset))
    else:
        indices = np.asarray(indices)
    if shuffle:
        rng = np.random.default_rng(seed)
        indices = rng.permutation(indices)
    n = len(indices)

    def load(i):
        return dataset[int(i)]

    def rows(chunk):
        if shard is None:
            return chunk
        rank, ranks = shard
        if len(chunk) % ranks:
            raise ValueError(f"a batch of {len(chunk)} does not divide "
                             f"over {ranks} ranks")
        return chunk[rank * len(chunk) // ranks:
                     (rank + 1) * len(chunk) // ranks]

    if num_workers <= 0:
        for s in range(0, n, batch_size):
            chunk = indices[s: s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield _collate([load(i) for i in rows(chunk)])
        return

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        for s in range(0, n, batch_size):
            chunk = indices[s: s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield _collate(list(pool.map(load, rows(chunk))))


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
