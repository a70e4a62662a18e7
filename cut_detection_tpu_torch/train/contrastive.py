"""SimCLR contrastive pretraining.

Counterpart of ``cut_detection_tpu/train/contrastive.py`` (reference
training_scripts/learn_contrasts.py): the conv backbone and a projection
head trained together with AdamW (:84-89), NT-Xent at temperature 1.0
with L2 normalization (frameID/metrics.py:13), two augmented views per
image concatenated along the batch (:105-107), ``drop_last`` batches
(:59-61: the loss is shaped by the batch size).  The backbone pools to
1x1 (:68-70).

The two views are made on the frames' device (``train/augment.py``)
from one uint8 upload, their parameters drawn from a CPU
``torch.Generator`` that the loop seeds once; ``fast_augment`` takes the
composed gather.

Under a ``torch.distributed`` group (``group``, one rank per card) every
rank reads the same seeded batches and takes its rows of each; it draws
the augmentation parameters of the whole global batch from the same
generator and keeps its rows', so its views are the single-device views'
rows.  BN runs over the global batch, NT-Xent over the projections
gathered from every rank (``parallel.distributed.all_gather_rows``),
each rank's loss summing only its own rows' terms, and the gradients are
SUM-all-reduced before the step (``supervised.optimizer_step``).
"""

from __future__ import annotations

import logging
from typing import Any

import torch
import torch.distributed as dist

from cut_detection_tpu_torch.config import ContrastiveConfig, ModelParams
from cut_detection_tpu_torch.train.augment import (
    fast_simclr_view,
    simclr_view,
    view_params,
)
from cut_detection_tpu_torch.train.losses import ntxent_loss
from cut_detection_tpu_torch.train.supervised import (
    TrainState,
    init_net,
    optimizer_step,
    rank_rows,
    train_precision,
)

logger = logging.getLogger(__name__)


def model_params(cfg: ContrastiveConfig) -> ModelParams:
    """The backbone at pool 1 (learn_contrasts.py:68-70) and the
    projection head."""
    return ModelParams(conv_layers=cfg.conv_layers,
                       conv_channels=cfg.conv_hidden_channels,
                       avg_pool_size=1,
                       linear_layers=cfg.linear_layers,
                       linear_size=cfg.linear_size,
                       linear_output_size=cfg.output_size)


def make_optimizer(cfg: ContrastiveConfig, params) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_contrastive_state(generator: torch.Generator,
                           cfg: ContrastiveConfig, device=None) -> TrainState:
    net = init_net(generator, model_params(cfg), train_precision(cfg),
                   device)
    return TrainState(net, make_optimizer(cfg, net.parameters()))


def make_contrastive_update(cfg: ContrastiveConfig, group=None):
    """``update(state, views) -> (state, metrics)``: one step on
    ready-made views ([2B, H, W, 3] f32, the two views concatenated):
    ``loss`` and ``align_acc``, the share of rows whose most similar row of
    the other view is their own.  Under ``group`` the views are this
    rank's rows of each global view, concatenated, and the metrics the
    global batch's."""
    train_precision(cfg)

    def update(state: TrainState, views):
        net = state.net
        net.train()
        net.set_process_group(group)
        proj = net(views)
        rows = None
        if group is not None:
            from cut_detection_tpu_torch.parallel.distributed import (
                all_gather_rows,
            )

            # [rank, view, row, D] -> [view, rank, row, D]: the global
            # [h1; h2] in the single-device row order.
            world = dist.get_world_size(group)
            b = proj.shape[0] // 2
            proj = all_gather_rows(proj, group).reshape(
                world, 2, b, -1).transpose(0, 1).reshape(2 * world * b, -1)
            rows = rank_rows(world * b, group)
        loss, logits_ab, labels = ntxent_loss(
            proj, temperature=cfg.temperature, rows=rows)
        optimizer_step(state, loss, group)
        correct = (logits_ab.detach().argmax(dim=1) == labels).sum()
        n = labels.shape[0]
        if group is not None:
            sums = torch.stack([loss.detach().double(), correct.double()])
            dist.all_reduce(sums, group=group)
            loss, correct = sums
            n *= dist.get_world_size(group)
        return state, {"loss": loss.detach().float(),
                       "align_acc": (correct / n).float()}

    return update


def two_views(cfg: ContrastiveConfig, gen: torch.Generator, x_u8,
              batch: int, rows: slice):
    """The two views of uint8 frames ``x_u8``, rows ``rows`` of a batch of
    ``batch``, concatenated ([2 len(rows), *VIEW_SIZE, 3]), by
    ``cfg.fast_augment``'s path; each view's parameters are drawn from
    ``gen`` for the whole batch (``simclr_two_views``'s draws)."""
    view = fast_simclr_view if cfg.fast_augment else simclr_view
    h, w = x_u8.shape[1:3]
    views = []
    for _ in range(2):
        params = view_params(gen, batch, h, w)
        views.append(view(x_u8, tuple(tuple(t[rows] for t in part)
                                      for part in params)))
    return torch.cat(views, dim=0)


def make_contrastive_step(cfg: ContrastiveConfig, group=None):
    """``step(state, gen, x_u8) -> (state, metrics)``: ``x_u8`` [B, H, W,
    3] uint8 RGB originals go to the net's device, the two views
    (``VIEW_SIZE``) are made there with parameters drawn from ``gen``, then
    ``update``.  Under ``group`` ``x_u8`` is this rank's rows of the
    global batch (``supervised.rank_rows``)."""
    update = make_contrastive_update(cfg, group)

    def step(state: TrainState, gen: torch.Generator, x_u8):
        x = torch.as_tensor(x_u8).to(state.net.device)
        batch = x.shape[0] * (1 if group is None
                              else dist.get_world_size(group))
        return update(state, two_views(cfg, gen, x, batch,
                                       rank_rows(batch, group)))

    return step


def train_contrastive(cfg: ContrastiveConfig, dataset, *, device=None,
                      num_workers: int = 4,
                      state: TrainState | None = None,
                      group=None) -> dict[str, Any]:
    """The pretraining loop over a ``ContrastiveFrameDataset``-like.  One
    generator, seeded with ``cfg.seed``, initialises the net (without
    ``state``, on ``device``: the CUDA device when ``None``, an error
    without one) and then draws every view's parameters.  ``group``: the
    data-parallel loop (module docstring); ``cfg.batch_size`` must divide
    over its ranks, and only rank 0 logs."""
    from cut_detection_tpu_torch.data.loader import (
        PrefetchLoader,
        iter_batches,
    )

    shard = None
    if group is not None:
        shard = (dist.get_rank(group), dist.get_world_size(group))
        rank_rows(cfg.batch_size, group)  # raises where it does not divide
    log = logger.info if shard is None or shard[0] == 0 \
        else (lambda *args: None)
    step = make_contrastive_step(cfg, group)
    gen = torch.Generator().manual_seed(cfg.seed)
    if state is None:
        state = init_contrastive_state(gen, cfg, device)

    history = []
    for epoch in range(cfg.epochs):
        log("Starting epoch %d of %d", epoch + 1, cfg.epochs)
        accum, n_obs = 0.0, 0
        batches = iter_batches(dataset, cfg.batch_size, shuffle=True,
                               seed=cfg.seed + epoch, drop_last=True,
                               num_workers=num_workers, shard=shard)
        for i, batch in enumerate(PrefetchLoader(batches)):
            state, metrics = step(state, gen, batch["x"])
            # The reference's metric (learn_contrasts.py:113-122): the
            # scalar batch loss over 2B rows.
            accum += float(metrics["loss"])
            n_obs += cfg.batch_size * 2
            if i % cfg.write_every_n == cfg.write_every_n - 1:
                log("Epoch %d | Batch %d | Loss: %.3f",
                    epoch + 1, i + 1, accum / max(n_obs, 1))
                accum, n_obs = 0.0, 0
        history.append({"epoch": epoch})
    return {"state": state, "history": history}
