"""Run-length encoding of per-frame scores + the ``Segmentation`` table.

Counterpart of ``cut_detection_tpu/segmentation/rle.py``; reference
frameID/segmentation.py:26-63.

- On the device (``:37-105``): ``device_frame_scores`` (per-frame max /
  argmax) and ``device_segment_reduce`` (the run-length table with a
  static row bound, on tensors on any device; ``segment_tables`` is the
  form ``device_glue`` builds on).
- On the host (``:107-217``): the ``Segmentation`` table.  The classify
  step reduces the logits on the device, so only the two ``[N]`` vectors
  reach it.  The merge loops use the native C++ library
  (``cut_detection_tpu_torch.native``) when it is built, as the JAX
  package does, and the numpy loops in ``glue`` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from cut_detection_tpu_torch.segmentation import glue as _glue
from cut_detection_tpu_torch.segmentation.csv_io import write_segments_csv

# Label vocabulary from frameID/data.py:116, used for CSV output via the
# inverse map (frameID/segmentation.py:8-9).
LAB_ENUM = {"a22": 0, "ez": 1, "b": 2}
INVERSE_LAB_ENUM = {v: k for k, v in LAB_ENUM.items()}


def device_frame_scores(logits: torch.Tensor):
    """Per-frame ``(confidence f32, class int32)``: the row-wise max and
    argmax of ``[N, C]`` logits, on their device.  Ties go to the first
    index, as ``torch.max`` in the reference (segmentation.py:37)."""
    return logits.amax(dim=1), logits.argmax(dim=1).to(torch.int32)


def _segment_sums(conf, starts, lengths) -> tuple[torch.Tensor, int]:
    """Each segment's sum of ``conf``, added left to right in f32: the
    order of the host table's ``np.add.reduceat`` and of the JAX
    smoother's ``lax.scan``, bit for bit (the merge order's argmin turns
    on the last ulp).  ``torch.cumsum`` and ``index_add_`` add in other
    orders.  One step per frame of the longest segment, each over the
    segments still that long (sorted longest first, so a prefix); returns
    the sums and the number of steps."""
    sums = conf[starts]
    if not starts.numel():
        return sums, 0
    lengths, order = torch.sort(lengths, descending=True, stable=True)
    # How many segments are longer than j, for every j (one fetch).
    counts = lengths.cpu().numpy()
    live = np.searchsorted(-counts, -np.arange(int(counts[0])), side="left")
    idx, run = starts[order], sums[order]
    for j in range(1, int(counts[0])):
        m = int(live[j])
        idx[:m] += 1
        run[:m] += conf[idx[:m]]
    sums[order] = run
    return sums, max(int(counts[0]) - 1, 0)


def segment_tables(conf: torch.Tensor, pred: torch.Tensor,
                   max_segments: int) -> tuple[dict, int, int]:
    """The run-length table of per-frame ``(conf, pred)`` on their device,
    in ``max_segments`` rows: ``start``, ``end``, ``type``, ``length``
    (int32), ``mean`` (f32, the sequential sum over the length) and
    ``active`` (bool; rows past the segment count are padding: 0, and
    ``type`` -1).  Returns ``(table, segment count, summing steps)``.  A
    count above ``max_segments`` leaves the table truncated to its first
    rows; the caller must check."""
    n = conf.shape[0]
    dev = conf.device
    conf = conf.float()
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = pred[1:] != pred[:-1]
    starts = torch.nonzero(is_start).squeeze(1)  # a fetch of its size
    count = starts.numel()
    ends = torch.cat([starts[1:] - 1,
                      torch.full((1,), n - 1, dtype=starts.dtype,
                                 device=dev)])[:count]
    starts = starts[:max_segments]
    ends = ends[:max_segments]
    lengths = ends - starts + 1
    sums, steps = _segment_sums(conf, starts, lengths)
    pad = max_segments - starts.numel()

    def padded(t, fill, dtype):
        return torch.cat([t.to(dtype),
                          torch.full((pad,), fill, dtype=dtype, device=dev)])

    table = {
        "start": padded(starts, 0, torch.int32),
        "end": padded(ends, 0, torch.int32),
        "type": padded(pred[starts], -1, torch.int32),
        "length": padded(lengths, 0, torch.int32),
        "mean": padded(sums / lengths.float(), 0.0, torch.float32),
        "active": torch.arange(max_segments, device=dev) < min(
            count, max_segments),
    }
    return table, count, steps


def device_segment_reduce(conf, pred, max_segments: int):
    """The run-length table on the device with a static row bound,
    checked: ``ValueError`` when the segments exceed ``max_segments``
    (the rows past the bound would be dropped).  Returns what
    ``device_segment_reduce_unchecked`` returns."""
    out = device_segment_reduce_unchecked(conf, pred, max_segments)
    if out[0] > max_segments:
        raise ValueError(
            f"device_segment_reduce overflow: {out[0]} segments exceed "
            f"max_segments={max_segments}; rows past the bound would be "
            "silently dropped. Raise max_segments (a power-of-two bucket "
            "keeps table shapes shared across videos).")
    return out


def device_segment_reduce_unchecked(conf, pred, max_segments: int):
    """``(num_segments, start_frames, end_frames, frame_types,
    run_lengths int64, score_means)``, the arrays padded to
    ``max_segments`` rows; rows ``>= num_segments`` are padding.  No
    bound check: past the bound the table is truncated (the JAX function
    keeps a jitted step free of a host sync this way; here the count is
    fetched to size the table all the same).  The means are the
    sequential f32 sums over the lengths, bit for bit the host table's."""
    table, count, _ = segment_tables(torch.as_tensor(conf),
                                     torch.as_tensor(pred), max_segments)
    return (count, table["start"], table["end"], table["type"],
            table["length"].long(), table["mean"])


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
