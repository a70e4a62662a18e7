"""The reference's resize size rule and the packed-YUV420 frame size.

Copy of ``reference_resize_dims`` and ``yuv420_nbytes`` from
``cut_detection_tpu/geometry.py:14, 26``.
Dependency-free on purpose: the decode subprocess (``data.shm_loader``)
imports the data layer at spawn, and nothing on that path should cost it
start-up time.
"""

from __future__ import annotations


def reference_resize_dims(width: int, height: int,
                          resize: int) -> tuple[int, int]:
    """(new_w, new_h) exactly as frameID/data.py:199-202 computes them.

    The reference computes ``int(height * (resize / width))`` — a float
    multiply then truncation — so the expression is kept verbatim rather
    than written in integer arithmetic.
    """
    new_w = resize
    new_h = int(height * (new_w / width))
    return new_w, new_h


def yuv420_nbytes(h: int, w: int) -> int:
    """Bytes of a packed planar-YUV420 frame at ``h`` x ``w``.

    Copy of ``cut_detection_tpu/geometry.py:26``: the Y plane (h*w), then
    the U and V planes at the ceil'd half dimensions each, the layout
    ``ops.yuv.pack_yuv420`` builds and ``vd_read_frame_yuv`` writes.
    """
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return h * w + 2 * cw * ch
