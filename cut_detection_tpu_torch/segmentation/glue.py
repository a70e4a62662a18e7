"""Orphan gluing and adjacent-segment merging (host side).

The port's copy of ``cut_detection_tpu/segmentation/glue.py``: that
module is numpy-only, but its package's ``__init__`` imports jax, so it
cannot be imported on a machine without jax.  Tests pin the two equal.

Reference: frameID/segmentation.py:12-183.  The merge loop is inherently
data-dependent (each iteration deletes a row and re-derives the orphan set),
operates on a table of ~10^2-10^3 segments, and its *order* of merges is
observable in the final CSV — so it runs on host over numpy arrays,
replicating the reference's semantics exactly:

- Orphan = non-blank segment shorter than ``real_threshold`` OR blank
  (type 2) segment shorter than ``blank_threshold`` (segmentation.py:12-17).
- Merge the orphan with the lowest score mean first (segmentation.py:103-107).
  Ties resolve to the lowest index.  Note: the reference breaks ties with
  ``torch.argsort(...)[0]`` and torch's sort is *unstable*, so its order on
  EXACT ties is implementation-defined; for continuous logits exact ties
  are measure-zero and the two implementations agree (property-tested).
- First row merges into the next, last row into the previous, interior rows
  into the strictly-longer neighbor with ties going to the next
  (segmentation.py:110-156).

⚠ Bug compatibility: the reference's weighted-mean update
(segmentation.py:79-82) mis-parenthesizes the division —
``(m_n*l_n + m_o*l_o) / l_n + l_o`` — inflating the merged mean by the
orphan's run length.  Because the inflated means feed later argmin choices,
bit-for-bit CSV parity REQUIRES replicating it; ``bug_compat=True`` (the
default) does.  ``bug_compat=False`` computes the correct weighted mean.

All scalar arithmetic is done in float32 to match torch's promotion rules
(float32 tensor ops stay float32; numpy would otherwise widen to float64).
"""

from __future__ import annotations

import numpy as np

BLANK_TYPE = 2  # lab_enum "b" (frameID/data.py:116)


def find_orphans(seg_types: np.ndarray, seg_lengths: np.ndarray,
                 real_threshold: int, blank_threshold: int) -> np.ndarray:
    """Boolean orphan mask (frameID/segmentation.py:12-17)."""
    real_orphans = (seg_types != BLANK_TYPE) & (seg_lengths < real_threshold)
    blank_orphans = (seg_types == BLANK_TYPE) & (seg_lengths < blank_threshold)
    return real_orphans | blank_orphans


def _update_neighbor(te: dict, orphan_idx: int, neighbor_idx: int,
                     bug_compat: bool) -> None:
    """Merge row ``orphan_idx`` into ``neighbor_idx`` in place.

    Mirrors frameID/segmentation.py:69-89: extend the neighbor's span,
    update its score mean from the *old* run lengths, then recompute its
    run length from the new span.
    """
    if orphan_idx < neighbor_idx:
        te["start_frames"][neighbor_idx] = te["start_frames"][orphan_idx]
    else:
        te["end_frames"][neighbor_idx] = te["end_frames"][orphan_idx]

    m_n = np.float32(te["score_means"][neighbor_idx])
    m_o = np.float32(te["score_means"][orphan_idx])
    l_n = np.float32(te["run_lengths"][neighbor_idx])
    l_o = np.float32(te["run_lengths"][orphan_idx])
    if bug_compat:
        # Reference's exact (buggy) expression: division binds before + l_o
        # (segmentation.py:79-82).
        merged = (m_n * l_n + m_o * l_o) / l_n + l_o
    else:
        merged = (m_n * l_n + m_o * l_o) / (l_n + l_o)
    te["score_means"][neighbor_idx] = merged

    te["run_lengths"][neighbor_idx] = (
        te["end_frames"][neighbor_idx] - te["start_frames"][neighbor_idx] + 1
    )


def _delete_row(te: dict, idx: int) -> None:
    """Drop one row from every table column (segmentation.py:20-23, 65-67)."""
    for k in te:
        te[k] = np.delete(te[k], idx)


def glue_orphans(te: dict, real_threshold: int = 100,
                 blank_threshold: int = 10, *, bug_compat: bool = True) -> dict:
    """Iteratively merge orphans until none remain (segmentation.py:91-166).

    ``te`` is the segment table dict (numpy arrays keyed like the
    reference's ``self.te``).  Mutates and returns it.
    """
    while True:
        mask = find_orphans(te["frame_types"], te["run_lengths"],
                            real_threshold, blank_threshold)
        # Stop when clean — or when a single row survives: the reference
        # would raise here (its first-element branch indexes row 1,
        # segmentation.py:110-113); a lone all-orphan segment has nothing
        # to merge into.  The native and device paths guard identically.
        if not mask.any() or te["start_frames"].shape[0] <= 1:
            break
        orphan_indices = np.nonzero(mask)[0]
        # Least confident first; np.argmin takes the first minimum, which
        # matches the reference's argsort(...)[0] tie behavior.
        target = int(orphan_indices[np.argmin(te["score_means"][mask])])
        n_rows = te["start_frames"].shape[0]

        if target == 0:
            neighbor = 1
        elif target == n_rows - 1:
            neighbor = target - 1
        else:
            # Strictly-longer previous neighbor wins; ties go next
            # (segmentation.py:147-156).
            if te["run_lengths"][target - 1] > te["run_lengths"][target + 1]:
                neighbor = target - 1
            else:
                neighbor = target + 1

        _update_neighbor(te, target, neighbor, bug_compat)
        _delete_row(te, target)
    return te


def combine_adjacent_segments(te: dict, *, bug_compat: bool = True) -> dict:
    """Merge runs of equal-type adjacent segments (segmentation.py:168-183).

    Repeatedly takes the *first* equal-type adjacent pair and merges the left
    row into the right one.
    """
    while True:
        matches = te["frame_types"][1:] == te["frame_types"][:-1]
        if not matches.any():
            break
        idx = int(np.nonzero(matches)[0][0])
        _update_neighbor(te, idx, idx + 1, bug_compat)
        _delete_row(te, idx)
    return te
