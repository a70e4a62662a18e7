"""Python bindings for the repo's native libav decoder
(``native/video_decoder.cpp``).

Copy of ``available`` and ``NativeVideoSource`` from
``cut_detection_tpu/data/native_video.py:80, 229`` (the BGR path; the
planar-YUV420 transfer is not ported).  ``NativeVideoSource`` has
``VideoFrameSource``'s contract (uint8 BGR HWC frames, the reference's
resize rule, failure accounting); its frames are byte-identical to
cv2's ffmpeg backend (both convert to BGR24 with swscale).  The library
is loaded by path from the repo's ``native/`` directory, built there
with ``make`` on first use when it is missing.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

from cut_detection_tpu_torch.geometry import reference_resize_dims

logger = logging.getLogger(__name__)

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libcutdet_decoder.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                               check=True, capture_output=True, timeout=180)
            except (OSError, subprocess.SubprocessError) as e:
                logger.debug("decoder build failed: %s", e)
                return None
        if not os.path.isfile(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            logger.debug("decoder load failed: %s", e)
            return None
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_info.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_int64)]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.vd_read_frame.argtypes = [ctypes.c_void_p, u8p]
        lib.vd_read_stashed.argtypes = [ctypes.c_void_p, u8p]
        lib.vd_seek_frame.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        if hasattr(lib, "vd_seek_frame_from"):  # a library built before it
            lib.vd_seek_frame_from.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64,
                                               ctypes.c_int64]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeVideoSource:
    """Sequential decode via the native libav stage.

    Same interface as ``data.video.VideoFrameSource``: yields uint8 BGR HWC
    frames, resized on host when ``resize`` is set (cv2 when present, else
    the bit-identical native resize).
    """

    def __init__(self, file_path: str, resize: int | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable")
        self._lib = lib
        self._handle = lib.vd_open(file_path.encode())
        if not self._handle:
            raise IOError(f"could not open {file_path}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        lib.vd_info(self._handle, ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(fps), ctypes.byref(n))
        # open_video's info dict, fps int-truncated (frameID/data.py:20).
        self.video_info = {"fps": int(fps.value), "length": int(n.value),
                           "width": int(w.value), "height": int(h.value)}
        # frames_read is the stream position (seek() moves it), so the
        # early-end warning does not count skipped frames as lost.
        self.frames_read = 0
        self.frames_failed = 0
        self._stashed = False
        if resize is not None:
            self.new_width, self.new_height = reference_resize_dims(
                self.video_info["width"], self.video_info["height"], resize)
        else:
            self.new_width = self.new_height = None

    def seek(self, frame_index: int) -> None:
        """Position so the next frame returned is ``frame_index``.

        Keyframe seek + decode-forward.  When the pts->index mapping jumps
        past the target (VFR, NTSC-rate rounding), the decoder reports the
        overshoot (return code 3) and the seek retries from earlier
        anchors, ending at frame 0, where decode-forward is exact.  Raises
        IOError on a hard failure, so no caller gets a mispositioned
        stream silently.
        """
        seek_from = getattr(self._lib, "vd_seek_frame_from", None)
        if seek_from is None:  # a library built before the anchored seek
            ret = self._lib.vd_seek_frame(self._handle, frame_index)
            if ret == 0:
                raise IOError(f"seek to frame {frame_index} failed")
            self._stashed = ret == 2
            self.frames_read = frame_index
            return
        anchors = [frame_index, max(0, frame_index - 64),
                   max(0, frame_index - 512), 0]
        ret = 0
        for anchor in dict.fromkeys(anchors):  # dedup, keep order
            ret = seek_from(self._handle, frame_index, anchor)
            if ret == 2:
                self._stashed = True
                self.frames_read = frame_index
                return
            if ret == 0:
                break  # hard failure; earlier anchors won't help
        raise IOError(
            f"seek to frame {frame_index} "
            f"{'overshot from every anchor' if ret == 3 else 'failed'}")

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self.new_width is None:
            return frame
        from cut_detection_tpu_torch.data.video import _host_resize

        return _host_resize(frame, self.new_width, self.new_height)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        h, w = self.video_info["height"], self.video_info["width"]
        frame = np.empty((h, w, 3), dtype=np.uint8)
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if self._stashed:
            ret = self._lib.vd_read_stashed(self._handle, ptr)
            self._stashed = False
        else:
            ret = self._lib.vd_read_frame(self._handle, ptr)
        if not ret:
            if self.frames_read < self.video_info["length"]:
                self.frames_failed = (self.video_info["length"]
                                      - self.frames_read)
                logger.warning(
                    "Native decode ended early: %d/%d frames (%d missing).",
                    self.frames_read, self.video_info["length"],
                    self.frames_failed)
            raise StopIteration
        self.frames_read += 1
        return self._resize(frame)

    def __len__(self) -> int:
        return self.video_info["length"]

    def close(self) -> None:
        # getattr: __del__ runs this on an instance whose __init__ raised.
        if getattr(self, "_handle", None):
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
