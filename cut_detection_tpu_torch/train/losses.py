"""Training losses.

Counterpart of ``cut_detection_tpu/train/losses.py``:

- ``cross_entropy_sum``: torch ``CrossEntropyLoss(reduction="sum")``
  (supervised_training.py:131), softmax cross entropy summed over the
  batch;
- ``ntxent_loss``: the SimCLR NT-Xent contrastive loss of the reference
  (frameID/metrics.py:8-47, after google-research/simclr).  The 2B rows
  are two augmented views concatenated; the intra-view logits get their
  diagonal masked with ``-BIG_NUMBER``; each view's positives are the
  aligned rows of the other view.

Both run in f32 whatever the input dtype: the f32 island of bf16 mixed
precision, where ``BIG_NUMBER`` alone would overflow bf16's headroom
after the temperature divide.
"""

from __future__ import annotations

import torch

BIG_NUMBER = 1e9  # frameID/metrics.py:5


def cross_entropy_sum(logits, labels) -> torch.Tensor:
    """Sum-reduced softmax cross entropy, reduced in f32."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(-1, labels.long()[:, None])[:, 0].sum()


def _ce_mean(logits, labels):
    logprobs = torch.log_softmax(logits, dim=-1)
    return -logprobs.gather(-1, labels[:, None])[:, 0].mean()


def ntxent_loss(x, *, temperature: float = 1.0, h_norm: bool = True):
    """NT-Xent over concatenated views ``x = [h1; h2]`` of shape [2B, D].

    Returns ``(loss, logits_ab, labels)`` like the reference module's
    forward: ``loss_a + loss_b``, each the mean cross entropy between a
    view's similarities to [other view | own view, diagonal masked] and
    the aligned-index labels.
    """
    x = x.float()
    if h_norm:
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    b = x.shape[0] // 2
    h1, h2 = x[:b], x[b:]
    masks = torch.eye(b, dtype=x.dtype, device=x.device)
    labels = torch.arange(b, device=x.device)

    logits_aa = h1 @ h1.T / temperature - masks * BIG_NUMBER
    logits_bb = h2 @ h2.T / temperature - masks * BIG_NUMBER
    logits_ab = h1 @ h2.T / temperature
    logits_ba = logits_ab.T

    loss_a = _ce_mean(torch.cat([logits_ab, logits_aa], dim=-1), labels)
    loss_b = _ce_mean(torch.cat([logits_ba, logits_bb], dim=-1), labels)
    return loss_a + loss_b, logits_ab, labels


class ContrastiveLoss:
    """Class facade over ``ntxent_loss`` (the frameID/metrics.py:8-47 API).

    The reference sizes its label and mask buffers to a fixed batch
    (metrics.py:20-21); here shapes come from the input, so ``batch_size``
    is only validated.
    """

    def __init__(self, batch_size: int = 32, h_norm: bool = True,
                 temperature: float = 1.0):
        self.batch_size = batch_size
        self.h_norm = h_norm
        self.temperature = temperature

    def __call__(self, x):
        if x.shape[0] != 2 * self.batch_size:
            raise ValueError(
                f"expected 2*batch_size={2 * self.batch_size} rows, got "
                f"{x.shape[0]} (the reference requires drop_last batches, "
                "learn_contrasts.py:59-61)")
        return ntxent_loss(x, temperature=self.temperature,
                           h_norm=self.h_norm)
