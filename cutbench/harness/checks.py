"""The numbers that decide ``correct``, each held to its limit.

Classify (every frame scored in the window against the reference's
logits of its pool frame):

- ``conf_gap``: the largest ``|conf - max(reference logits)|``;
- ``pred_gap``: the largest amount by which the reference's logit of the
  class the program picked lies below the reference's best.

Training (the first three steps, which set-up drives through the
window's own call):

- ``loss_gap``: the relative gap between the first step's losses (later
  steps' losses are not compared: Adam's first update is about
  ``lr * sign(grad)`` element by element, so elements whose gradient is
  at rounding level step a full ``lr`` either way, and the losses of
  steps 2 and 3 carry that; PERF.md gives the readings);
- ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient (the program's read back from its optimizer's first moment),
  over the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same gap for the change of every parameter and BN
  running statistic over the three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone and are left out of both leaf gaps.
"""

from __future__ import annotations

import torch

NEGLIGIBLE_GRAD = 1e-3


def _worst(values) -> float:
    """The largest value, a NaN counting as infinite."""
    return max(float("inf") if v != v else v for v in values)


def classify_gaps(conf, pred, ref_logits) -> dict[str, float]:
    """``conf`` f32 [n], ``pred`` int [n], ``ref_logits`` f32 [n, C]."""
    best, _ = ref_logits.max(dim=1)
    picked = ref_logits.gather(1, pred.long().clamp(
        0, ref_logits.shape[1] - 1)[:, None])[:, 0]
    bad_class = (pred < 0) | (pred >= ref_logits.shape[1])
    pred_gap = torch.where(bad_class, torch.full_like(best, float("inf")),
                           best - picked)
    return {"conf_gap": float((conf.float() - best).abs().max()),
            "pred_gap": float(pred_gap.max())}


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _worst_leaf(ours: dict, ref: dict, keys) -> float:
    a = _norms({k: ours[k] for k in keys})
    b = _norms({k: ref[k] for k in keys})
    median = float(torch.tensor([b[k] for k in keys]).median())
    return _worst(abs(a[k] - b[k]) / max(b[k], median, 1e-30) for k in keys)


def train_gaps(losses, ref_losses, grads, ref_grads, change, ref_change,
               stat_keys) -> dict[str, float]:
    """``grads``/``change``: leaf name -> tensor, the program's and the
    reference's; ``change`` also holds the BN statistics (``stat_keys``)."""
    loss_gap = abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]),
                                                    1e-30)
    g = _norms(ref_grads)
    median = float(torch.tensor(list(g.values())).median())
    moving = [k for k in ref_grads if g[k] >= NEGLIGIBLE_GRAD * median]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(grads, ref_grads, moving),
            "change_gap": _worst_leaf(change, ref_change,
                                      moving + list(stat_keys))}
