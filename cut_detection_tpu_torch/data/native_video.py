"""Python bindings for the repo's native libav decoder
(``native/video_decoder.cpp``).

Copy of ``available``, ``yuv_available``, ``yuv420_to_bgr24_host``,
``NativeYUVSource`` and ``NativeVideoSource`` from
``cut_detection_tpu/data/native_video.py:80-229``.  ``NativeVideoSource``
has ``VideoFrameSource``'s contract (uint8 BGR HWC frames, the
reference's resize rule, failure accounting); its frames are
byte-identical to cv2's ffmpeg backend (both convert to BGR24 with
swscale).  ``NativeYUVSource`` yields packed planar YUV420 at the target
size for the ``yuv420`` transfer, whose conversion to BGR runs on the
device (``ops.yuv``, ``ops.kernels.yuv420_to_bgr``).  The library is
loaded by path from the repo's ``native/`` directory, built there with
``make`` on first use when it is missing.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

from cut_detection_tpu_torch.geometry import (
    reference_resize_dims,
    yuv420_nbytes,
)

logger = logging.getLogger(__name__)

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libcutdet_decoder.so")

# Bytes past a BGR frame that its buffer holds: swscale's SIMD converters
# write past the end of a row whose length is not a multiple of their
# vector width, and ``vd_read_frame`` scales straight into the caller's
# tight buffer (linesize 3 * width; 1278 bytes at width 426), so the last
# row overruns it.  The library's YUV entries scale through aligned,
# padded buffers for the same reason ("swscale's SIMD paths write past
# unaligned row ends", native/video_decoder.cpp, convert_held_frame_yuv).
# The slack is never read.
BGR_PAD_BYTES = 256

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
        if hasattr(lib, "vd_read_frame_yuv"):  # a library built before it
            lib.vd_read_frame_yuv.argtypes = [ctypes.c_void_p, u8p,
                                              ctypes.c_int, ctypes.c_int]
            lib.vd_read_stashed_yuv.argtypes = [ctypes.c_void_p, u8p,
                                                ctypes.c_int, ctypes.c_int]
            lib.vd_yuv420_to_bgr24.argtypes = [u8p, u8p, u8p, ctypes.c_int,
                                               ctypes.c_int, u8p]
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


def yuv_available() -> bool:
    """True when the built library has the planar-YUV420 entry points."""
    lib = _load()
    return lib is not None and hasattr(lib, "vd_read_frame_yuv")


def yuv420_to_bgr24_host(y, u, v):
    """swscale's same-size yuv420p -> bgr24 on the host: the oracle that
    ``ops.yuv`` reproduces."""
    lib = _load()
    if lib is None or not hasattr(lib, "vd_yuv420_to_bgr24"):
        raise RuntimeError("native decoder (with YUV entry points) "
                           "unavailable")
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if not lib.vd_yuv420_to_bgr24(
            y.ctypes.data_as(u8p), u.ctypes.data_as(u8p),
            v.ctypes.data_as(u8p), w, h, out.ctypes.data_as(u8p)):
        raise RuntimeError("vd_yuv420_to_bgr24 failed")
    return out


class _NativeSource:
    """One decoder handle: open, the video's info, seek, sequential reads
    with failure accounting, close.  Subclasses say what a read yields
    (``_read``)."""

    _what = "Native decode"

    def __init__(self, file_path: str):
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

    def seek(self, frame_index: int) -> None:
        """Position so the next frame returned is ``frame_index``.

        Keyframe seek + decode-forward.  When the pts->index mapping jumps
        past the target (VFR, NTSC-rate rounding), the decoder reports the
        overshoot (return code 3) and the seek retries from earlier
        anchors, ending at frame 0, where decode-forward is exact.  Raises
        IOError on a hard failure, so no caller gets a mispositioned
        stream silently.  The decoder holds the target frame; the next
        read converts it as this source's reads do.
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

    def _read(self, stashed: bool):
        """The next frame, or None at the end of the stream."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        out = self._read(self._stashed)
        self._stashed = False
        if out is None:
            if self.frames_read < self.video_info["length"]:
                self.frames_failed = (self.video_info["length"]
                                      - self.frames_read)
                logger.warning(
                    "%s ended early: %d/%d frames (%d missing).", self._what,
                    self.frames_read, self.video_info["length"],
                    self.frames_failed)
            raise StopIteration
        self.frames_read += 1
        return out

    def __len__(self) -> int:
        return self.video_info["length"]

    def close(self) -> None:
        # getattr: __del__ runs this on an instance whose __init__ raised.
        if getattr(self, "_handle", None):
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeYUVSource(_NativeSource):
    """Sequential decode to packed planar YUV420 at the target size.

    One swscale pass a frame scales the decoded frame to the reference's
    resize dims in YUV space and yields the packed planes (Y, then U,
    then V, chroma at the ceil'd half dims) as one flat uint8 vector of
    ``frame_nbytes = geometry.yuv420_nbytes(h, w)`` bytes: 1.5 B/px where
    BGR takes 3.  The conversion to BGR runs on the device (``ops.yuv``,
    exact with swscale).  The resize runs in YUV space where the
    reference resizes BGR (frameID/data.py:220-222), so this path is held
    by the accuracy corpus, not by byte parity.
    """

    _what = "Native YUV decode"

    def __init__(self, file_path: str, resize: int | None = 256):
        if not yuv_available():
            raise RuntimeError("native decoder (with YUV entry points) "
                               "unavailable")
        super().__init__(file_path)
        if resize is not None:
            self.out_width, self.out_height = reference_resize_dims(
                self.video_info["width"], self.video_info["height"], resize)
        else:
            self.out_width = self.video_info["width"]
            self.out_height = self.video_info["height"]
        self.frame_nbytes = yuv420_nbytes(self.out_height, self.out_width)

    def _read(self, stashed: bool):
        # The library packs the planes out of its own padded buffer, so
        # this one needs no slack.
        buf = np.empty((self.frame_nbytes,), dtype=np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        read = (self._lib.vd_read_stashed_yuv if stashed
                else self._lib.vd_read_frame_yuv)
        if not read(self._handle, ptr, self.out_width, self.out_height):
            return None
        return buf


class NativeVideoSource(_NativeSource):
    """Sequential decode via the native libav stage.

    Same interface as ``data.video.VideoFrameSource``: yields uint8 BGR HWC
    frames, resized on host when ``resize`` is set (cv2 when present, else
    the bit-identical native resize).
    """

    def __init__(self, file_path: str, resize: int | None = None):
        super().__init__(file_path)
        if resize is not None:
            self.new_width, self.new_height = reference_resize_dims(
                self.video_info["width"], self.video_info["height"], resize)
        else:
            self.new_width = self.new_height = None

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self.new_width is None:
            return frame
        from cut_detection_tpu_torch.data.video import _host_resize

        return _host_resize(frame, self.new_width, self.new_height)

    def _read(self, stashed: bool):
        h, w = self.video_info["height"], self.video_info["width"]
        # The frame is a view of a buffer BGR_PAD_BYTES longer than it.
        buf = np.empty((h * w * 3 + BGR_PAD_BYTES,), dtype=np.uint8)
        frame = buf[:h * w * 3].reshape(h, w, 3)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        read = (self._lib.vd_read_stashed if stashed
                else self._lib.vd_read_frame)
        if not read(self._handle, ptr):
            return None
        return self._resize(frame)
