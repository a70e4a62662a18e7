"""Subprocess decode feeding a shared-memory batch ring.

Copy of ``ShmDecodeLoader`` and its child's entry point from
``cut_detection_tpu/data/shm_loader.py:49, 116``, with both transfers:
``bgr`` slots hold ``[B, h, w, 3]`` uint8 frames, ``yuv420`` slots
``[B, yuv420_nbytes(h, w)]`` packed planes from the native YUV decoder.
The decode runs in a spawned process, so the host's upload and the decode
overlap whatever the parent does with the interpreter lock.  The child
decodes straight into a ring of ``slots`` batch-sized uint8 blocks of
shared memory; the parent yields views of them (or copies, with
``copy_out``, for a consumer whose tensor would alias the slot, such as
``torch.from_numpy`` on the CPU).  Flow control: a ``free`` queue of slot
ids (parent -> child) and a ``ready`` queue of (slot, valid) messages
(child -> parent), so the child runs at most ``slots`` batches ahead.

The batches are exactly what ``video.batch_frames`` yields in-process
(same sources, same padding), so the CSVs do not depend on where the
decode runs.  The child imports only this package's ``data`` modules.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time
from multiprocessing import shared_memory

import numpy as np

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _producer_main(path: str, kw: dict, shm_names: list, slot_shape: tuple,
                   free_q, ready_q) -> None:
    """Child process: decode batches into the shared-memory ring.

    Sends ("batch", slot, valid) per batch, then ("done", stats), or
    ("error", message) on any failure, so the parent re-raises instead of
    waiting on a silently dead child.
    """
    shms = []
    try:
        from cut_detection_tpu_torch.data import video as v

        if kw["transfer"] == "yuv420":
            if kw["decode_workers"] > 1:
                src = v.ParallelVideoReader(
                    path, resize=kw["resize"],
                    num_threads=kw["decode_workers"],
                    chunk_frames=kw["decode_chunk_frames"], backend="yuv")
            else:
                from cut_detection_tpu_torch.data.native_video import (
                    NativeYUVSource,
                )

                src = NativeYUVSource(path, resize=kw["resize"])
        elif kw["decode_workers"] > 1:
            src = v.ParallelVideoReader(
                path, resize=kw["resize"], num_threads=kw["decode_workers"],
                chunk_frames=kw["decode_chunk_frames"],
                backend=kw["decoder"])
        elif kw["decoder"] == "native":
            from cut_detection_tpu_torch.data.native_video import (
                NativeVideoSource,
            )

            src = NativeVideoSource(path, resize=kw["resize"])
        else:
            src = v.VideoFrameSource(path, resize=kw["resize"])
        shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
        views = [np.ndarray(slot_shape, np.uint8, buffer=s.buf)
                 for s in shms]
        for batch, valid in v.batch_frames(src, slot_shape[0]):
            if batch.shape != slot_shape:
                raise RuntimeError(
                    f"decoded batch shape {batch.shape} != expected "
                    f"{slot_shape} (video stream changed size mid-file?)")
            slot = free_q.get()
            if slot is None:  # parent closed early (e.g. --frame-limit)
                return
            views[slot][...] = batch
            ready_q.put(("batch", slot, int(valid)))
        ready_q.put(("done", {
            "frames_failed": int(getattr(src, "frames_failed", 0))}))
    except BaseException as e:  # noqa: BLE001 — the child must report
        import traceback

        try:
            ready_q.put(("error", f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}"))
        except Exception:
            pass
    finally:
        for s in shms:
            try:
                s.close()
            except Exception:
                pass


class ShmDecodeLoader:
    """Iterable of ``(batch, valid)`` decoded in a subprocess.

    Stands in for ``PrefetchLoader(batch_frames(source, B))`` in
    ``pipeline.classify_video``; exposes ``video_info`` / ``length`` /
    ``frames_failed`` like the in-process sources.  Single-use.
    ``copy_out=True`` yields private copies instead of ring views, for a
    consumer that may alias host memory; a consumer whose copy has left
    the slot when it asks for the next batch (a synchronous upload to
    the card) can take the views and save a copy.
    """

    def __init__(self, input_path: str, *, batch_size: int = 128,
                 resize: int | None = 256, decode_workers: int = 1,
                 decode_chunk_frames: int = 256, decoder: str = "cv2",
                 slots: int | None = None, copy_out: bool = False,
                 transfer: str = "bgr"):
        from cut_detection_tpu_torch.data.video import open_video

        if decoder == "auto":
            from cut_detection_tpu_torch.data import native_video

            decoder = "native" if native_video.available() else "cv2"
        cap, info = open_video(input_path)  # probe metadata (and fail early)
        cap.release()
        self.video_info = info
        self.length = info["length"]
        self.frames_failed = 0
        if resize is not None:
            from cut_detection_tpu_torch.geometry import reference_resize_dims

            w, h = reference_resize_dims(info["width"], info["height"],
                                         resize)
        else:
            w, h = info["width"], info["height"]
        self.frame_hw = (h, w)
        if slots is None:
            try:
                slots = int(os.environ.get("CUTDET_DECODE_SLOTS") or 6)
            except ValueError:
                slots = 6
        slots = max(2, slots)
        if transfer == "yuv420":
            from cut_detection_tpu_torch.data import native_video
            from cut_detection_tpu_torch.geometry import yuv420_nbytes

            if not native_video.yuv_available():
                raise RuntimeError(
                    "transfer='yuv420' needs the native decoder with YUV "
                    "entry points (make -C native)")
            if h % 2 or w % 2:
                raise ValueError(
                    f"transfer='yuv420' needs even target dims, got {h}x{w} "
                    "(odd sizes take swscale's interpolating path; use the "
                    "BGR transfer)")
            self._slot_shape = (batch_size, yuv420_nbytes(h, w))
        elif transfer == "bgr":
            self._slot_shape = (batch_size, h, w, 3)
        else:
            raise ValueError(f"unknown transfer mode {transfer!r}")
        self._copy_out = copy_out
        self._closed = False
        self._consumed = False
        # Wall time from construction to the first decoded batch (spawn +
        # child imports + first batch decode), set by _drain.
        self._t_init = time.perf_counter()
        self.startup_s: float | None = None
        nbytes = int(np.prod(self._slot_shape))
        self._shms = [shared_memory.SharedMemory(create=True, size=nbytes)
                      for _ in range(slots)]
        self._views = [np.ndarray(self._slot_shape, np.uint8, buffer=s.buf)
                       for s in self._shms]
        ctx = mp.get_context("spawn")
        self._free = ctx.Queue()
        self._ready = ctx.Queue()
        for i in range(slots):
            self._free.put(i)
        kw = {"resize": resize, "decode_workers": decode_workers,
              "decode_chunk_frames": decode_chunk_frames, "decoder": decoder,
              "transfer": transfer}
        # The spawned child inherits os.environ: put the repo on its
        # PYTHONPATH for the spawn window so it imports this package.
        saved = os.environ.get("PYTHONPATH")
        pyp = [p for p in (saved or "").split(os.pathsep) if p]
        if _REPO_ROOT not in pyp:
            pyp.insert(0, _REPO_ROOT)
        try:
            os.environ["PYTHONPATH"] = os.pathsep.join(pyp)
            self._proc = ctx.Process(
                target=_producer_main,
                args=(input_path, kw, [s.name for s in self._shms],
                      self._slot_shape, self._free, self._ready),
                daemon=True)
            self._proc.start()
        finally:
            if saved is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = saved

    def __iter__(self):
        if self._consumed:
            raise RuntimeError("ShmDecodeLoader is single-use; construct a "
                               "new one to iterate again")
        self._consumed = True
        return self._drain()

    def _drain(self):
        try:
            while True:
                try:
                    msg = self._ready.get(timeout=600.0)
                except queue_mod.Empty:
                    raise RuntimeError(
                        "decode subprocess produced nothing for 600s "
                        f"(alive={self._proc.is_alive()})") from None
                kind = msg[0]
                if kind == "batch":
                    if self.startup_s is None:
                        self.startup_s = time.perf_counter() - self._t_init
                    _, slot, valid = msg
                    if self._copy_out:
                        out = self._views[slot].copy()
                        self._free.put(slot)
                        yield out, valid
                    else:
                        yield self._views[slot], valid
                        # The consumer is done with the view once it asks
                        # for the next batch.
                        self._free.put(slot)
                elif kind == "done":
                    self.frames_failed = msg[1]["frames_failed"]
                    return
                else:
                    raise RuntimeError(f"decode subprocess failed: {msg[1]}")
        finally:
            self.close()

    def close(self) -> None:
        """Stop the child and release the shared-memory ring (idempotent)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._free.put(None)
        except (OSError, ValueError):  # queue already closed
            pass
        proc = getattr(self, "_proc", None)
        if proc is not None:
            proc.join(timeout=15)
            if proc.is_alive():
                logger.warning("decode subprocess did not exit; terminating")
                proc.terminate()
                proc.join(timeout=5)
        # Drain queue feeder threads so close() doesn't leak them.
        for q in (self._free, self._ready):
            q.cancel_join_thread()
            q.close()
        for s in self._shms:
            try:
                s.close()
                s.unlink()
            except FileNotFoundError:  # already unlinked
                pass

    def __del__(self):  # last-resort cleanup; close() is the real API
        try:
            self.close()
        except Exception:  # a half-built instance, or interpreter exit
            pass
