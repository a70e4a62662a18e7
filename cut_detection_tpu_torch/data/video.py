"""Video decode: the sequential source, the chunk-parallel reader and
batching.

Copy of the names the port calls from ``cut_detection_tpu/data/video.py``
(``open_video`` ``:65``, ``VideoFrameSource`` ``:94``,
``ParallelVideoReader`` ``:222`` with its cv2, native and yuv backends,
``batch_frames`` ``:567``); reference frameID/data.py:13-31, 184-234.

- Frames stay uint8 BGR HWC on the host; the flip and /255 are folded
  into layer 1 (or run on the device), so a width-256 frame crosses to
  the card as ~110 KB instead of ~442 KB of float32.
- ``ParallelVideoReader`` decodes the video in seek-separated chunks on
  N threads (cv2 and the native decoder release the GIL while decoding),
  reassembled in order, with a byte-compare of each chunk's boundary
  frame that repairs an inexact seek by decoding again from earlier.
- Decode failures are counted (``frames_failed``) and logged; the stream
  is truncated at the first failure, as the reference does.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator

import numpy as np

try:
    import cv2
except ImportError:  # the native decoder and resize stand in
    cv2 = None

from cut_detection_tpu_torch.geometry import reference_resize_dims

logger = logging.getLogger(__name__)


def _require_cv2():
    if cv2 is None:
        raise ImportError(
            "OpenCV (cv2) is required for video decode. Install opencv-python "
            "or use the native decoder fallback."
        )


def _host_resize(frame: np.ndarray, new_width: int, new_height: int):
    """Host resize: cv2 INTER_LINEAR, or the bit-identical native C++ path."""
    if cv2 is not None:
        return cv2.resize(frame, (new_width, new_height),
                          interpolation=cv2.INTER_LINEAR)
    from cut_detection_tpu_torch import native as native_ops

    return native_ops.resize_bilinear_u8(frame, new_height, new_width)


def open_video(video_path: str):
    """Open a video; return (capture, info).  frameID/data.py:13-31 contract.

    ``fps`` is int-truncated exactly like the reference (data.py:20).
    ``threads;0`` in $OPENCV_FFMPEG_CAPTURE_OPTIONS turns on ffmpeg's own
    frame/slice threading (the decoded bytes do not change); a value
    already set is respected.  An unreadable file raises, as the native
    decoder does for the same input.
    """
    _require_cv2()
    os.environ.setdefault("OPENCV_FFMPEG_CAPTURE_OPTIONS", "threads;0")
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"could not open video: {video_path}")
    fps = int(cap.get(cv2.CAP_PROP_FPS))
    length = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    return cap, {"fps": fps, "length": length, "width": width, "height": height}


class VideoFrameSource:
    """Sequential frame iterator yielding uint8 BGR HWC numpy frames.

    With ``resize`` set, frames are resized on the host with
    ``cv2.resize(..., INTER_LINEAR)`` using the reference's size rule — this
    keeps resized pixels bit-identical to frameID/data.py:218-222.  With
    ``resize=None`` raw frames are yielded (for on-device resize).
    """

    def __init__(self, file_path: str, resize: int | None = None):
        self.cap, self.video_info = open_video(file_path)
        self.frames_read = 0
        self.frames_failed = 0
        if resize is not None:
            self.new_width, self.new_height = reference_resize_dims(
                self.video_info["width"], self.video_info["height"], resize
            )
        else:
            self.new_width = self.new_height = None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        ret, frame = self.cap.read()
        if not ret:
            if self.frames_read < self.video_info["length"]:
                self.frames_failed = self.video_info["length"] - self.frames_read
                logger.warning(
                    "Decode ended early: %d/%d frames decoded (%d missing).",
                    self.frames_read, self.video_info["length"],
                    self.frames_failed,
                )
            raise StopIteration
        if self.new_width is not None:
            frame = cv2.resize(
                frame, (self.new_width, self.new_height),
                interpolation=cv2.INTER_LINEAR,
            )
        self.frames_read += 1
        return frame

    def __len__(self) -> int:
        return self.video_info["length"]

    def close(self) -> None:
        self.cap.release()


class _Cv2ChunkDecoder:
    """Seek/read adapter over cv2.VideoCapture for chunked decode."""

    def __init__(self, file_path: str):
        self.cap = cv2.VideoCapture(file_path)

    def seek(self, frame_index: int) -> None:
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_index)

    def read(self):
        ret, frame = self.cap.read()
        return (frame if ret else None)

    def close(self) -> None:
        self.cap.release()


class _NativeChunkDecoder:
    """Seek/read adapter over the native libav decoder."""

    def __init__(self, file_path: str):
        from cut_detection_tpu_torch.data.native_video import (
            NativeVideoSource,
        )

        self.src = NativeVideoSource(file_path)

    def seek(self, frame_index: int) -> None:
        self.src.seek(frame_index)

    def read(self):
        try:
            return next(self.src)
        except StopIteration:
            return None

    def close(self) -> None:
        self.src.close()


class _YUVChunkDecoder(_NativeChunkDecoder):
    """Seek/read adapter over the native decoder's planar-YUV420 path.

    ``read()`` yields flat packed-YUV420 vectors already scaled to the
    target size by the decoder, so the chunk workers apply no host
    resize; the boundary byte-compare works on the vectors as on BGR
    frames.
    """

    def __init__(self, file_path: str, resize: int | None):
        from cut_detection_tpu_torch.data.native_video import NativeYUVSource

        self.src = NativeYUVSource(file_path, resize=resize)


class ParallelVideoReader:
    """Chunk-parallel in-order video decode.

    The video's frame range is cut into ``chunk_frames``-sized chunks;
    ``num_threads`` workers each own a private decoder (cv2.VideoCapture or
    the native libav stage, ``backend``), seek to their next chunk's first
    frame, decode it sequentially (resizing on the host when ``resize`` is
    set; ``backend="yuv"`` decodes to packed YUV420 vectors that the
    decoder has already scaled to the target size), and publish
    ``(chunk_idx, frames)`` to a bounded queue.  The consumer reassembles
    chunks in order, so the frame stream is identical to sequential
    decode for codecs with exact seeking; pass
    ``num_threads=1`` to force the strictly sequential reference behavior.
    """

    def __init__(self, file_path: str, resize: int | None = None,
                 num_threads: int = 4, chunk_frames: int = 256,
                 max_pending_chunks: int | None = None,
                 backend: str = "cv2", verify_seek: bool = True,
                 heal_seek: bool = True):
        self.backend = backend
        # Seek-integrity guard: chunks overlap by one frame and the
        # boundary frame is byte-compared against the previous chunk's
        # last frame, which catches codecs with inexact keyframe seeking
        # (open-GOP H.264).  With ``heal_seek`` a mismatch is repaired by
        # re-decoding the chunk from an earlier, verified position.
        self.verify_seek = verify_seek
        self.heal_seek = heal_seek
        self.seek_mismatches = 0
        self.chunks_healed = 0
        self.file_path = file_path
        self.resize = resize
        if backend == "native":
            from cut_detection_tpu_torch.data.native_video import (
                NativeVideoSource,
            )

            probe = NativeVideoSource(file_path)
            self.video_info = probe.video_info
            probe.close()
        elif backend == "yuv":
            from cut_detection_tpu_torch.data.native_video import (
                NativeYUVSource,
            )

            probe = NativeYUVSource(file_path, resize=resize)
            self.video_info = probe.video_info
            self.frame_nbytes = probe.frame_nbytes
            probe.close()
        else:
            _require_cv2()
            cap, self.video_info = open_video(file_path)
            cap.release()
        self.length = self.video_info["length"]
        self.chunk_frames = chunk_frames
        self.num_threads = max(1, min(num_threads, max(1, self.length // chunk_frames + 1)))
        self.num_chunks = max(1, -(-self.length // chunk_frames))
        self.frames_failed = 0
        max_pending = max_pending_chunks or 2 * self.num_threads
        self._results: queue.Queue = queue.Queue(maxsize=max_pending)
        # In-flight window (see _worker): bounds decoding + queued +
        # reorder-buffered chunks together, which the queue alone cannot
        # (the consumer drains completed later chunks into its reorder
        # dict while waiting on a slow one, freeing queue slots).
        self._window = threading.Semaphore(max_pending)
        self._next_chunk = 0
        self._chunk_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        if resize is not None and backend != "yuv":
            self.new_width, self.new_height = reference_resize_dims(
                self.video_info["width"], self.video_info["height"], resize
            )
        else:
            # The yuv backend's decoder scales to the target size itself.
            self.new_width = self.new_height = None

    def _claim_chunk(self) -> int | None:
        with self._chunk_lock:
            if self._next_chunk >= self.num_chunks:
                return None
            c = self._next_chunk
            self._next_chunk += 1
            return c

    def _worker(self) -> None:
        try:
            dec = self._new_decoder()
        except Exception:
            # This worker claimed nothing yet; peers pick up its chunks
            # and the consumer's liveness check covers total death.
            logger.exception("decode worker failed to construct a decoder")
            return
        try:
            pos = -1  # current frame position of this decoder
            while not self._stop.is_set():
                # Window bound: at most max_pending chunks in flight; the
                # consumer releases a permit per chunk it emits.
                while not self._window.acquire(timeout=0.2):
                    if self._stop.is_set():
                        return
                chunk = self._claim_chunk()
                if chunk is None:
                    self._window.release()
                    break
                start = chunk * self.chunk_frames
                end = min(start + self.chunk_frames, self.length)
                # Overlap by one frame for the boundary check.
                check = self.verify_seek and chunk > 0
                read_from = start - 1 if check else start
                boundary = None
                frames = []
                ok = True
                try:
                    if pos != read_from:
                        dec.seek(read_from)
                        pos = read_from
                    for i in range(end - read_from):
                        frame = dec.read()
                        if frame is None:
                            ok = False
                            break
                        if self.new_width is not None:
                            frame = _host_resize(frame, self.new_width,
                                                 self.new_height)
                        if check and i == 0:
                            boundary = frame
                        else:
                            frames.append(frame)
                    pos = end if ok else -1
                except Exception:
                    # A raising decoder must not kill the thread silently:
                    # the consumer would wait forever on the chunk.
                    # Publish the failure instead.
                    logger.exception("decode worker failed on chunk %d",
                                     chunk)
                    boundary, frames, ok, pos = None, [], False, -1
                self._results.put((chunk, boundary, frames, ok))
        finally:
            dec.close()

    def _new_decoder(self):
        if self.backend == "native":
            return _NativeChunkDecoder(self.file_path)
        if self.backend == "yuv":
            return _YUVChunkDecoder(self.file_path, self.resize)
        return _Cv2ChunkDecoder(self.file_path)

    def _redecode_chunk(self, chunk: int, prev_last: np.ndarray):
        """Re-decode chunk ``chunk`` with verified alignment (self-heal).

        Bounded retry with progressively earlier seek points (1 chunk
        back, 4 chunks back, then frame 0 with no seek, which is
        sequential and exact by construction).  Each attempt decodes
        forward to the chunk's first frame and trusts the stream only once
        the frame at ``start-1`` byte-equals the previous chunk's verified
        last frame.  Returns the chunk's frames (host-resized like the
        workers') or None if every attempt failed to decode that far.
        """
        start = chunk * self.chunk_frames
        end = min(start + self.chunk_frames, self.length)
        targets = [t for back in (1, 4)
                   if (t := start - 1 - back * self.chunk_frames) > 0]
        targets.append(0)
        for target in targets:
            dec = self._new_decoder()
            try:
                if target > 0:
                    try:
                        dec.seek(target)
                    except Exception:
                        # A raising seek makes this target bad, not the
                        # heal: fall through to the earlier targets.
                        logger.warning(
                            "Self-heal seek to frame %d failed; trying an "
                            "earlier position.", target, exc_info=True)
                        continue
                check = None
                for _ in range(start - target):
                    check = dec.read()
                    if check is None:
                        break
                if check is None:
                    continue
                if self.new_width is not None:
                    check = _host_resize(check, self.new_width,
                                         self.new_height)
                if not np.array_equal(check, prev_last):
                    if target > 0:
                        continue
                    # Sequential-from-0 is ground truth; disagreement
                    # means a nondeterministic decoder.  Say so and trust
                    # the sequential frames.
                    logger.warning(
                        "Sequential re-decode of chunk %d disagrees with "
                        "the previously verified boundary frame; decoder "
                        "is nondeterministic.", chunk)
                frames = []
                for _ in range(end - start):
                    f = dec.read()
                    if f is None:
                        break
                    if self.new_width is not None:
                        f = _host_resize(f, self.new_width, self.new_height)
                    frames.append(f)
                return frames
            except Exception:
                # A raising read fails only this target; the
                # sequential-from-0 attempt remains.
                logger.warning("Self-heal attempt from frame %d failed; "
                               "trying an earlier position.", target,
                               exc_info=True)
                continue
            finally:
                dec.close()
        return None

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._threads:
            raise RuntimeError(
                "ParallelVideoReader is single-use: construct a new reader "
                "to decode the video again.")
        if self.length <= 0:
            # No frame count in the container (webm/mkv/streams): the
            # chunk plan needs one, so decode sequentially to EOF.
            logger.warning(
                "Container reports no frame count (%d); decoding "
                "sequentially to EOF without chunk parallelism.",
                self.length)
            self._threads.append(None)  # arm the single-use guard
            dec = self._new_decoder()
            n = 0
            try:
                while True:
                    frame = dec.read()
                    if frame is None:
                        break
                    if self.new_width is not None:
                        frame = _host_resize(frame, self.new_width,
                                             self.new_height)
                    n += 1
                    yield frame
            finally:
                dec.close()
                self.length = n  # observed count, for callers' accounting
            return
        for t in range(self.num_threads):
            th = threading.Thread(target=self._worker, daemon=True,
                                  name=f"decode-{t}")
            th.start()
            self._threads.append(th)
        pending: dict[int, tuple] = {}
        emit = 0
        truncated = False
        prev_last = None
        try:
            while emit < self.num_chunks and not truncated:
                while emit not in pending:
                    try:
                        chunk, boundary, frames, ok = self._results.get(
                            timeout=5.0)
                    except queue.Empty:
                        # Liveness: workers publish their own failures, so
                        # only a worker that died before claiming a chunk
                        # can leave the one we need unpublished.
                        if (not any(t is not None and t.is_alive()
                                    for t in self._threads)
                                and self._results.empty()):
                            raise RuntimeError(
                                f"all decode workers exited without "
                                f"producing chunk {emit} of "
                                f"{self.num_chunks} ({self.file_path})")
                        continue
                    pending[chunk] = (boundary, frames, ok)
                boundary, frames, ok = pending.pop(emit)
                self._window.release()  # one in-flight slot per emitted chunk
                if boundary is not None and prev_last is not None:
                    if not np.array_equal(boundary, prev_last):
                        self.seek_mismatches += 1
                        if self.heal_seek:
                            logger.warning(
                                "Seek-inexact decode at chunk %d (codec "
                                "with open GOPs?); re-decoding the chunk "
                                "from an earlier verified position.", emit)
                            healed = self._redecode_chunk(emit, prev_last)
                            if healed is not None:
                                start = emit * self.chunk_frames
                                want = min(start + self.chunk_frames,
                                           self.length) - start
                                frames, ok = healed, len(healed) == want
                                self.chunks_healed += 1
                            else:
                                logger.warning(
                                    "Self-heal re-decode failed for chunk "
                                    "%d; yielding unverified frames.", emit)
                        else:
                            logger.warning(
                                "Seek-inexact decode at chunk %d: boundary "
                                "frame differs after keyframe seek (codec "
                                "with open GOPs?). Use num_threads=1 for "
                                "bit-exact sequential decode.", emit)
                if frames:
                    prev_last = frames[-1]
                yield from frames
                if not ok:
                    # Mirror the reference's truncation-on-failure, loudly.
                    start = emit * self.chunk_frames
                    self.frames_failed = self.length - (start + len(frames))
                    logger.warning(
                        "Decode failed at frame %d; truncating (%d frames lost).",
                        start + len(frames), self.frames_failed,
                    )
                    truncated = True
                emit += 1
        finally:
            self._stop.set()
            # Drain so workers blocked on put() can exit.
            while any(t.is_alive() for t in self._threads):
                try:
                    self._results.get_nowait()
                except queue.Empty:
                    for t in self._threads:
                        t.join(timeout=0.05)

    def __len__(self) -> int:
        return self.length


def batch_frames(source, batch_size: int, *, pad_to_batch: bool = True):
    """Group a frame iterator into [B, H, W, 3] uint8 batches.

    Yields ``(batch, valid)`` where ``valid <= batch_size`` counts real
    frames; when ``pad_to_batch`` the final batch is zero-padded so every
    batch has the same shape (the reference instead ships a smaller last
    batch, segment_video.py:42).
    """
    buf: list[np.ndarray] = []
    for frame in source:
        buf.append(frame)
        if len(buf) == batch_size:
            yield np.stack(buf), batch_size
            buf = []
    if buf:
        valid = len(buf)
        if pad_to_batch and valid < batch_size:
            pad = np.zeros_like(buf[0])
            buf.extend([pad] * (batch_size - valid))
        yield np.stack(buf), valid
