"""``evaluate``: a segments CSV against a truth CSV.

Copy of ``cut_detection_tpu/cli/evaluate.py`` (``evaluate`` ``:66``,
``main`` ``:116``).  Both CSVs are ``start_frame,label`` rows, as the
pipeline writes them.  Reports:

- per-frame label accuracy (the share of frames with the right label);
- per-class frame accuracy;
- boundary precision and recall at a frame tolerance (a predicted
  boundary counts where a true boundary lies within +-tolerance frames);
- segment counts.

When ``--num-frames`` is omitted the video's length is taken as one past
the last boundary in either CSV (``num_frames_assumed`` in the output):
fine for the boundary metrics, but frame accuracy then ignores whatever
follows the final cut, so pass the real frame count when it matters.

    python -m cut_detection_tpu_torch.cli.evaluate PRED.csv TRUTH.csv \\
        [--num-frames N] [--tolerance 30]
"""

from __future__ import annotations

import argparse
import csv
import json

import numpy as np

from cut_detection_tpu_torch.segmentation.rle import LAB_ENUM

# The labelling tool's uppercase vocabulary (EZ/A22/B) is accepted too.
_LABEL_ALIASES = {k.lower(): v for k, v in LAB_ENUM.items()}


def read_segments_csv(path: str) -> list[tuple[int, str]]:
    with open(path, "r", newline="") as f:
        return [(int(r[0]), r[1]) for r in csv.reader(f) if r]


def _label_id(lab: str, path: str) -> int:
    try:
        return _LABEL_ALIASES[lab.strip().lower()]
    except KeyError:
        raise SystemExit(
            f"{path}: unknown label {lab!r} — expected one of "
            f"{sorted(LAB_ENUM)} (case-insensitive)") from None


def frame_labels(segments: list[tuple[int, str]], num_frames: int,
                 path: str = "<csv>") -> np.ndarray:
    """Expand (start, label) rows into a per-frame label id array."""
    out = np.full(num_frames, -1, dtype=np.int32)
    for i, (start, lab) in enumerate(segments):
        end = segments[i + 1][0] if i + 1 < len(segments) else num_frames
        out[start:end] = _label_id(lab, path)
    return out


def evaluate(pred_csv: str, truth_csv: str, num_frames: int | None,
             tolerance: int = 30) -> dict:
    pred = read_segments_csv(pred_csv)
    truth = read_segments_csv(truth_csv)
    assumed = num_frames is None
    if assumed:
        num_frames = max((s for s, _ in pred + truth), default=0) + 1
    pl = frame_labels(pred, num_frames, pred_csv)
    tl = frame_labels(truth, num_frames, truth_csv)

    # Score only frames the truth covers: a truth CSV starting past frame
    # 0 leaves a -1 prefix, and -1 == -1 must not count as correct.
    covered = tl >= 0
    acc = float(np.mean((pl == tl)[covered])) if covered.any() else 0.0
    per_class = {}
    for name, cid in LAB_ENUM.items():
        mask = tl == cid
        per_class[name] = float(np.mean(pl[mask] == tl[mask])) if mask.any() \
            else None

    pred_b = np.asarray([s for s, _ in pred[1:]])
    true_b = np.asarray([s for s, _ in truth[1:]])

    def _matched(a, b):
        if len(a) == 0 or len(b) == 0:
            return 0
        d = np.abs(a[:, None] - b[None, :])
        return int(np.sum(d.min(axis=1) <= tolerance))

    precision = _matched(pred_b, true_b) / max(len(pred_b), 1)
    recall = _matched(true_b, pred_b) / max(len(true_b), 1)

    result = {
        "frame_accuracy": round(acc, 4),
        "per_class_accuracy": {k: (round(v, 4) if v is not None else None)
                               for k, v in per_class.items()},
        "boundary_precision": round(precision, 4),
        "boundary_recall": round(recall, 4),
        "boundary_tolerance_frames": tolerance,
        "pred_segments": len(pred),
        "true_segments": len(truth),
    }
    if assumed:
        result["num_frames_assumed"] = int(num_frames)
    return result


def main(args=None) -> dict:
    p = argparse.ArgumentParser("Evaluate a segments CSV against truth.")
    p.add_argument("pred_csv", type=str)
    p.add_argument("truth_csv", type=str)
    p.add_argument("--num-frames", type=int, default=None,
                   help="Total frames in the video; if omitted, assumed to "
                        "be one past the last boundary in either CSV.")
    p.add_argument("--tolerance", type=int, default=30,
                   help="Boundary match tolerance in frames.")
    ns = p.parse_args(args)
    result = evaluate(ns.pred_csv, ns.truth_csv, ns.num_frames, ns.tolerance)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
