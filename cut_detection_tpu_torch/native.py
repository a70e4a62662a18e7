"""ctypes bindings for the repo's native host library
(``native/cutdet_native.cpp``).

Copy of the names the port calls from ``cut_detection_tpu/native.py``:
the uint8 bilinear resize (bit-exact with OpenCV INTER_LINEAR), used when
cv2 is missing, and the segment table's merge loops.  The library is
loaded by path from the repo's ``native/`` directory, built there with
``make`` on first use; where neither works the callers take their numpy
or cv2 paths.

``load_built`` is the one way the port builds and loads a library of
``native/`` (this one and ``data/native_video``'s decoder): it takes an
exclusive ``flock`` on ``native/.build.lock``, runs ``make`` there only
where the library is missing, and loads it only under that lock, so processes that
start together (test workers, the decode subprocess) never load a file
that another one's ``g++ -o`` is still writing.  A load that fails is
tried once more under the lock before the caller caches the miss: a
writer outside the lock (the JAX package's binding builds unlocked) may
finish the file in the meantime.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import logging
import os
import subprocess
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcutdet_native.so")
BUILD_LOCK = os.path.join(_NATIVE_DIR, ".build.lock")
# Seconds between the two tries of ``load_built``: time for a writer
# outside the lock to finish a file whose load failed.
_RETRY_DELAY_S = 2.0

_lock = threading.Lock()
_lib = None
_tried = False


@contextlib.contextmanager
def _build_lock():
    """Exclusive ``flock`` on ``BUILD_LOCK`` across processes (none where
    the directory is read-only: there nothing can be built either)."""
    try:
        fd = os.open(BUILD_LOCK, os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


def load_built(lib_path: str, timeout: float = 180.0):
    """``ctypes.CDLL(lib_path)`` under the build lock, after ``make -C
    native`` where the file is missing; the loaded library, or None.  A
    second try follows a failed load or a failed ``make``; not a ``make``
    that succeeded without the file (the decoder where the libav headers
    are missing), which no wait cures."""
    for attempt in range(2):
        if attempt:
            time.sleep(_RETRY_DELAY_S)
        with _build_lock():
            if not os.path.isfile(lib_path):
                try:
                    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                                   capture_output=True, timeout=timeout)
                except (OSError, subprocess.SubprocessError) as e:
                    logger.debug("native build failed: %s", e)
                    continue
                if not os.path.isfile(lib_path):
                    return None
            try:
                return ctypes.CDLL(lib_path)
            except OSError as e:
                logger.debug("native load of %s failed: %s", lib_path, e)
    return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        lib = load_built(_LIB_PATH, timeout=120)
        _tried = True
        if lib is None:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p, ctypes.c_int,
                                           ctypes.c_int]
        lib.glue_orphans.argtypes = [i64p, i64p, i64p, i64p, f32p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int]
        lib.glue_orphans.restype = ctypes.c_int64
        lib.combine_adjacent.argtypes = [i64p, i64p, i64p, i64p, f32p,
                                         ctypes.c_int64, ctypes.c_int]
        lib.combine_adjacent.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Native uint8 HWC resize, bit-exact with cv2 INTER_LINEAR."""
    lib = _require()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected HWC image, got shape {img.shape}")
    h, w, c = img.shape
    # A zero source dim gives negative tap indices (reads out of bounds)
    # and a negative output dim throws across extern "C": refuse both.
    if h <= 0 or w <= 0 or c <= 0 or out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"resize dims must be positive: in {img.shape}, "
            f"out ({out_h}, {out_w})")
    out = np.empty((out_h, out_w, c), dtype=np.uint8)
    lib.resize_bilinear_u8(_ptr(img, ctypes.c_uint8), h, w, c,
                           _ptr(out, ctypes.c_uint8), out_h, out_w)
    return out


def _table_copies(te: dict):
    """Private working copies of the table's five arrays: the C merge
    loops move rows in place, and the caller's table must not change."""
    return (np.array(te["start_frames"], np.int64, copy=True),
            np.array(te["end_frames"], np.int64, copy=True),
            np.array(te["frame_types"], np.int64, copy=True),
            np.array(te["run_lengths"], np.int64, copy=True),
            np.array(te["score_means"], np.float32, copy=True))


def _table(start, end, typ, runlen, mean, k: int) -> dict:
    return {
        "end_frames": end[:k].copy(),
        "frame_types": typ[:k].copy(),
        "run_lengths": runlen[:k].copy(),
        "start_frames": start[:k].copy(),
        "score_means": mean[:k].copy(),
    }


def glue_orphans(te: dict, real_threshold: int, blank_threshold: int,
                 bug_compat: bool = True) -> dict:
    """Native orphan gluing (on private copies); same contract as
    ``segmentation.glue.glue_orphans``."""
    lib = _require()
    start, end, typ, runlen, mean = _table_copies(te)
    k = lib.glue_orphans(_ptr(start, ctypes.c_int64),
                         _ptr(end, ctypes.c_int64),
                         _ptr(typ, ctypes.c_int64),
                         _ptr(runlen, ctypes.c_int64),
                         _ptr(mean, ctypes.c_float), start.shape[0],
                         real_threshold, blank_threshold, int(bug_compat))
    return _table(start, end, typ, runlen, mean, k)


def combine_adjacent(te: dict, bug_compat: bool = True) -> dict:
    """Native adjacent merge (on private copies); same contract as
    ``segmentation.glue.combine_adjacent_segments``."""
    lib = _require()
    start, end, typ, runlen, mean = _table_copies(te)
    k = lib.combine_adjacent(_ptr(start, ctypes.c_int64),
                             _ptr(end, ctypes.c_int64),
                             _ptr(typ, ctypes.c_int64),
                             _ptr(runlen, ctypes.c_int64),
                             _ptr(mean, ctypes.c_float), start.shape[0],
                             int(bug_compat))
    return _table(start, end, typ, runlen, mean, k)
