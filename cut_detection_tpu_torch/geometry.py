"""The reference's resize size rule.

Copy of ``reference_resize_dims`` from ``cut_detection_tpu/geometry.py:14``.
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
