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
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from cut_detection_tpu_torch.config import ContrastiveConfig, ModelParams
from cut_detection_tpu_torch.train.augment import (
    fast_simclr_two_views,
    simclr_two_views,
)
from cut_detection_tpu_torch.train.losses import ntxent_loss
from cut_detection_tpu_torch.train.supervised import (
    TrainState,
    init_net,
    optimizer_step,
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


def make_contrastive_update(cfg: ContrastiveConfig):
    """``update(state, views) -> (state, metrics)``: one step on
    ready-made views ([2B, H, W, 3] f32, the two views concatenated):
    ``loss`` and ``align_acc``, the share of rows whose most similar row of
    the other view is their own."""
    train_precision(cfg)

    def update(state: TrainState, views):
        net = state.net
        net.train()
        proj = net(views)
        loss, logits_ab, labels = ntxent_loss(proj,
                                              temperature=cfg.temperature)
        optimizer_step(state, loss)
        acc = (logits_ab.detach().argmax(dim=1) == labels).float().mean()
        return state, {"loss": loss.detach(), "align_acc": acc}

    return update


def make_contrastive_step(cfg: ContrastiveConfig):
    """``step(state, gen, x_u8) -> (state, metrics)``: ``x_u8`` [B, H, W,
    3] uint8 RGB originals go to the net's device, the two views
    (``VIEW_SIZE``) are made there with parameters drawn from ``gen``, then
    ``update``."""
    update = make_contrastive_update(cfg)
    two_views = (fast_simclr_two_views if cfg.fast_augment
                 else simclr_two_views)

    def step(state: TrainState, gen: torch.Generator, x_u8):
        x = torch.as_tensor(x_u8).to(state.net.device)
        return update(state, two_views(gen, x))

    return step


def train_contrastive(cfg: ContrastiveConfig, dataset, *, device=None,
                      num_workers: int = 4,
                      state: TrainState | None = None) -> dict[str, Any]:
    """The pretraining loop over a ``ContrastiveFrameDataset``-like.  One
    generator, seeded with ``cfg.seed``, initialises the net (without
    ``state``, on ``device``: the CUDA device when ``None``, an error
    without one) and then draws every view's parameters."""
    from cut_detection_tpu_torch.data.loader import (
        PrefetchLoader,
        iter_batches,
    )

    step = make_contrastive_step(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    if state is None:
        state = init_contrastive_state(gen, cfg, device)

    history = []
    for epoch in range(cfg.epochs):
        logger.info("Starting epoch %d of %d", epoch + 1, cfg.epochs)
        accum, n_obs = 0.0, 0
        batches = iter_batches(dataset, cfg.batch_size, shuffle=True,
                               seed=cfg.seed + epoch, drop_last=True,
                               num_workers=num_workers)
        for i, batch in enumerate(PrefetchLoader(batches)):
            state, metrics = step(state, gen, batch["x"])
            # The reference's metric (learn_contrasts.py:113-122): the
            # scalar batch loss over 2B rows.
            accum += float(metrics["loss"])
            n_obs += batch["x"].shape[0] * 2
            if i % cfg.write_every_n == cfg.write_every_n - 1:
                logger.info("Epoch %d | Batch %d | Loss: %.3f",
                            epoch + 1, i + 1, accum / max(n_obs, 1))
                accum, n_obs = 0.0, 0
        history.append({"epoch": epoch})
    return {"state": state, "history": history}
