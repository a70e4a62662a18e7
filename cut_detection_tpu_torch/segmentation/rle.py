"""Run-length encoding of per-frame scores + the ``Segmentation`` table.

Counterpart of the host path of ``cut_detection_tpu/segmentation/rle.py``
(``:107-217``); reference frameID/segmentation.py:26-63.  The per-frame
reduction (max / argmax) happens on the device in the classify step, so
only the two ``[N]`` vectors reach this module.  The merge loops use the
native C++ library (``cut_detection_tpu_torch.native``) when it is
built, as the JAX package does, and the numpy loops in ``glue`` otherwise.
"""

from __future__ import annotations

import numpy as np

from cut_detection_tpu_torch.segmentation import glue as _glue
from cut_detection_tpu_torch.segmentation.csv_io import write_segments_csv

# Label vocabulary from frameID/data.py:116, used for CSV output via the
# inverse map (frameID/segmentation.py:8-9).
LAB_ENUM = {"a22": 0, "ez": 1, "b": 2}
INVERSE_LAB_ENUM = {v: k for k, v in LAB_ENUM.items()}


def _native_available() -> bool:
    from cut_detection_tpu_torch import native

    return native.available()


class Segmentation:
    """Segment table built from per-frame scores (segmentation.py:26-60).

    ``Segmentation(scores)`` takes ``[N, C]`` host logits, as the
    reference constructor does; ``from_frame_scores`` takes the per-frame
    (confidence, class) vectors.  ``self.te`` has the reference's keys and
    dtypes: frames, types and run lengths int64, score means float32.
    """

    def __init__(self, scores=None, *, _te: dict | None = None):
        if _te is not None:
            self.te = _te
            return
        if scores is None:
            raise ValueError("Segmentation requires scores (or _te).")
        scores = np.asarray(scores)
        self.te = self._build_table(np.max(scores, axis=1).astype(np.float32),
                                    np.argmax(scores, axis=1).astype(np.int64))

    @classmethod
    def from_frame_scores(cls, conf, pred) -> "Segmentation":
        conf = np.asarray(conf, dtype=np.float32)
        pred = np.asarray(pred, dtype=np.int64)
        return cls(_te=cls._build_table(conf, pred))

    @staticmethod
    def _build_table(conf: np.ndarray, pred: np.ndarray) -> dict:
        n = pred.shape[0]
        # Boundaries: a segment ends where the class changes; the final
        # frame always closes one (segmentation.py:39-45).
        change = np.nonzero(pred[1:] != pred[:-1])[0]
        end_frames = np.concatenate([change, [n - 1]]).astype(np.int64)
        start_frames = np.concatenate([[0], end_frames[:-1] + 1]).astype(np.int64)
        run_lengths = np.concatenate(
            [[end_frames[0] + 1], end_frames[1:] - end_frames[:-1]]
        ).astype(np.int64)
        # Segment score means in float32, one reduceat.
        sums = np.add.reduceat(conf, start_frames.astype(np.intp))
        score_means = (sums / run_lengths.astype(np.float32)).astype(np.float32)
        return {
            "end_frames": end_frames,
            "frame_types": pred[end_frames],
            "run_lengths": run_lengths,
            "start_frames": start_frames,
            "score_means": score_means,
        }

    def __len__(self) -> int:
        return int(self.te["end_frames"].shape[0])

    def glue_orphans(self, real_threshold: int = 100,
                     blank_threshold: int = 10, *,
                     bug_compat: bool = True,
                     backend: str = "auto") -> None:
        """Merge orphan segments (segmentation.py:91-166 semantics).

        ``backend``: "auto" uses the native C++ merge loop when built,
        "python" forces the numpy implementation.
        """
        if backend == "auto" and _native_available():
            from cut_detection_tpu_torch import native

            self.te = native.glue_orphans(self.te, real_threshold,
                                          blank_threshold,
                                          bug_compat=bug_compat)
        else:
            self.te = _glue.glue_orphans(self.te, real_threshold,
                                         blank_threshold,
                                         bug_compat=bug_compat)

    def combine_adjacent_segments(self, *, bug_compat: bool = True,
                                  backend: str = "auto") -> None:
        """Merge equal-type adjacent segments (segmentation.py:168-183)."""
        if backend == "auto" and _native_available():
            from cut_detection_tpu_torch import native

            self.te = native.combine_adjacent(self.te, bug_compat=bug_compat)
        else:
            self.te = _glue.combine_adjacent_segments(
                self.te, bug_compat=bug_compat)

    def write_csv(self, file_path: str) -> None:
        """Byte-exact CSV output (segmentation.py:185-196)."""
        labels = [INVERSE_LAB_ENUM[int(t)] for t in self.te["frame_types"]]
        write_segments_csv(file_path, self.te["start_frames"], labels)
