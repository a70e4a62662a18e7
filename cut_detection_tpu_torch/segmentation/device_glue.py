"""The segmentation smoother on the device: run-length table, orphan glue
and adjacent merge on tensors on the net's device.

Counterpart of ``cut_detection_tpu/segmentation/device_glue.py:42-228``,
which runs the same algorithm as one XLA program with no Pallas kernel;
here it is plain PyTorch, and the data-dependent ``while_loop``s become
Python loops with one scalar fetch per iteration (the loop's condition).
The host path (``segmentation/glue.py``) replicates the reference's loops
directly; this one gives the same table.

Representation: fixed-capacity tables (``max_segments`` rows) plus an
``active`` mask; "deleting" a row deactivates it, and the reference's
post-deletion adjacency maps onto the previous / next *active* row.
Every reference rule is kept:

- orphan definition (frameID/segmentation.py:12-17);
- least-confident-first merge order, first index on ties (:103-107);
- first -> next, last -> prev, interior -> strictly-longer prev else next
  (:110-156);
- the mis-parenthesized mean update behind ``bug_compat`` (:79-82);
- adjacent merge: repeatedly merge the FIRST equal-type pair, left into
  right (:168-183).

The tables are updated in place (the JAX program builds new arrays).
The means come out bit for bit the JAX program's: the segment sums add
left to right (``rle.segment_tables``), and a merge rounds each f32
operation as the compiled program does, which contracts ``m_n * l_n +
m_o * l_o`` into one fused multiply-add (``_fma32``).  The host loops
round that product on its own, so their means can sit one ulp from
these; the tables' rows are the same.
"""

from __future__ import annotations

import torch

from cut_detection_tpu_torch.segmentation.rle import (
    device_frame_scores,
    segment_tables,
)

_INF = float("inf")


def _orphan_mask(te, k1: int, kb: int) -> torch.Tensor:
    t, length = te["type"], te["length"]
    return te["active"] & (((t != 2) & (length < k1))
                           | ((t == 2) & (length < kb)))


def _fma32(a, b, c):
    """``a * b + c`` for f32 ``a``, ``b``, ``c``, rounded once to f32 (a
    fused multiply-add), on any device.  The product is exact in f64; the
    f64 sum ``s`` and its exact error ``e`` (TwoSum) hold ``a * b + c``
    exactly, and ``s`` rounds to the same f32 as ``s + e`` unless ``s``
    lies exactly halfway between two f32 values, where ``e`` breaks the
    tie."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    m = s.float()
    d = s - m.double()  # exact: s and m are within one f32 ulp
    toward = torch.where(d > 0, _INF, -_INF).to(m.dtype)
    other = torch.nextafter(m, toward)
    tie = (d != 0) & ((other.double() - s) == d)
    return torch.where(tie & (e * d > 0), other, m)


def _merge(te, orphan, neighbor, bug_compat: bool) -> None:
    """Merge row ``orphan`` into row ``neighbor`` (0-d index tensors) in
    place (segmentation.py:69-89)."""
    left = orphan < neighbor
    start = torch.where(left, te["start"][orphan], te["start"][neighbor])
    end = torch.where(left, te["end"][neighbor], te["end"][orphan])
    m_n, m_o = te["mean"][neighbor], te["mean"][orphan]
    l_n = te["length"][neighbor].float()
    l_o = te["length"][orphan].float()
    total = _fma32(m_n, l_n, m_o * l_o)
    if bug_compat:
        mean = total / l_n + l_o
    else:
        mean = total / (l_n + l_o)
    at = neighbor.view(1)
    te["start"].index_put_((at,), start.view(1))
    te["end"].index_put_((at,), end.view(1))
    te["length"].index_put_((at,), (end - start + 1).view(1))
    te["mean"].index_put_((at,), mean.view(1))
    te["active"].index_put_((orphan.view(1),),
                            torch.zeros(1, dtype=torch.bool,
                                        device=orphan.device))


def _glue_loop(te, k1: int, kb: int, bug_compat: bool) -> int:
    """Merge orphans, least confident first, while more than one row is
    active and one is an orphan (the host path's ``count > 1`` guard: a
    lone orphan row stays).  Returns the merges made."""
    s = te["active"].shape[0]
    idx = torch.arange(s, device=te["active"].device)
    merges = 0
    while True:
        mask = _orphan_mask(te, k1, kb)
        if not bool((te["active"].sum() > 1) & mask.any()):
            return merges
        target = torch.argmin(torch.where(mask, te["mean"], _INF))
        prev = torch.where(te["active"] & (idx < target), idx, -1).max()
        nxt = torch.where(te["active"] & (idx > target), idx, s).min()
        longer = (te["length"][prev.clamp(min=0)]
                  > te["length"][nxt.clamp(max=s - 1)])
        neighbor = torch.where(prev < 0, nxt,
                               torch.where(nxt >= s, prev,
                                           torch.where(longer, prev, nxt)))
        _merge(te, target, neighbor, bug_compat)
        merges += 1


def _adjacent_loop(te, bug_compat: bool) -> int:
    """Merge the first pair of adjacent active rows of one type, left into
    right, until none is left.  Returns the merges made."""
    active = te["active"]
    s = active.shape[0]
    idx = torch.arange(s, device=active.device)
    tail = torch.full((1,), s, dtype=idx.dtype, device=active.device)
    merges = 0
    while True:
        # The next active row after each row (s if none): a reverse
        # running min of the active rows' indices, shifted by one.
        vals = torch.where(active, idx, s).flip(0)
        nxt = torch.cat([torch.cummin(vals, 0).values.flip(0)[1:], tail])
        pair = (active & (nxt < s)
                & (te["type"] == te["type"][nxt.clamp(max=s - 1)]))
        if not bool(pair.any()):
            return merges
        left = torch.argmax(pair.to(torch.uint8))
        _merge(te, left, nxt[left], bug_compat)
        merges += 1


def smooth_tables(conf, pred, real_threshold: int = 100,
                  blank_threshold: int = 10, *, max_segments: int = 8192,
                  bug_compat: bool = True) -> tuple[dict, int, dict]:
    """The whole smoother on the device of ``conf`` and ``pred``: returns
    the final table (``segmentation.rle.segment_tables``' keys),
    the initial segment count and the loops' iterations (``"sum"``,
    ``"glue"``, ``"adjacent"``).  A count above ``max_segments`` makes the
    table invalid (truncated) and skips the loops; the caller checks."""
    te, count, steps = segment_tables(torch.as_tensor(conf).float(),
                                      torch.as_tensor(pred), max_segments)
    loops = {"sum": steps, "glue": 0, "adjacent": 0}
    if count <= max_segments:
        loops["glue"] = _glue_loop(te, real_threshold, blank_threshold,
                                   bug_compat)
        loops["adjacent"] = _adjacent_loop(te, bug_compat)
    return te, count, loops


def device_smooth(conf, pred, real_threshold: int = 100,
                  blank_threshold: int = 10, *, max_segments: int = 8192,
                  bug_compat: bool = True):
    """Full smoother on the device: per-frame ``(conf, pred)`` ->
    ``(start_frames, frame_types, active, initial_count, score_means,
    end_frames)``, the tensors padded to ``max_segments`` rows on the
    inputs' device; rows with ``active`` False are padding (compact with
    ``start[active]``).  ``score_means`` are the post-merge means, with
    the reference's inflation under ``bug_compat`` as in the host table.
    ``initial_count`` (an int) is the raw segment count: above
    ``max_segments`` the result is invalid and callers must check
    (``smooth_logits`` raises)."""
    te, count, _ = smooth_tables(conf, pred, real_threshold,
                                 blank_threshold, max_segments=max_segments,
                                 bug_compat=bug_compat)
    return (te["start"], te["type"], te["active"], count, te["mean"],
            te["end"])


def smooth_logits(logits, real_threshold: int = 100,
                  blank_threshold: int = 10, *, max_segments: int = 8192):
    """``[N, C]`` logits -> the compacted ``(start_frames, labels)`` as
    numpy arrays; ``ValueError`` when the segments exceed
    ``max_segments``."""
    conf, pred = device_frame_scores(torch.as_tensor(logits))
    start, typ, active, count, _, _ = device_smooth(
        conf, pred, real_threshold, blank_threshold,
        max_segments=max_segments)
    if count > max_segments:
        raise ValueError(
            f"{count} initial segments exceed max_segments={max_segments}; "
            "raise the bound or use the host path")
    act = active.cpu().numpy()
    return start.cpu().numpy()[act], typ.cpu().numpy()[act]

