"""Segments CSV writer with byte-exact reference formatting.

The reference writes rows of ``(start_frame, label)`` through stdlib
``csv.writer`` with the default dialect — which means ``\r\n`` line
terminators and no header (frameID/segmentation.py:185-196).  We use the
same stdlib writer so output is byte-identical.

The port's copy of ``cut_detection_tpu/segmentation/csv_io.py`` (whose
package ``__init__`` imports jax); tests pin the two equal.
"""

from __future__ import annotations

import csv


def write_segments_csv(file_path: str, start_frames, labels) -> None:
    """Write ``start_frame,label`` rows exactly like segmentation.py:193-196."""
    with open(file_path, "w", newline="") as f:
        cw = csv.writer(f, delimiter=",")
        for sf, lab in zip(start_frames, labels):
            cw.writerow((int(sf), lab))
