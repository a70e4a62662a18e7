"""Supervised classifier training.

Counterpart of ``cut_detection_tpu/train/supervised.py`` (reference
training_scripts/supervised_training.py): AdamW over the conv and linear
parameters together (:125-130), ``CrossEntropyLoss(reduction="sum")``
(:131), the 75/25 permuted split (:70-76), the tail batch kept
(``drop_last=False``), windowed log lines (:161-168) and per-class
validation accuracy (:184-215).

The step is PyTorch autograd, as JAX's is XLA autodiff: the net's train
forward (``models.layers.ConvBlock.forward_train``) on f32 frames divided
by 255 on the device, then the optimizer, then the BN running statistics
that the forward recorded (``GluedNet.apply_bn_stats``).  The state is a
``TrainState`` whose net and optimizer the step updates in place.  The
eval step runs the net in eval mode, so on the card it launches the block
kernels, as JAX's eval step is its inference graph.

``compute_dtype="bfloat16"`` is JAX's mixed precision
(``supervised.py:39-60``): the net runs at ``bfloat16_full``'s per-op bf16
contract with f32 islands for BN and the loss; parameters, gradients and
optimizer state stay f32.  ``remat`` recomputes the conv forward during
the backward (``torch.utils.checkpoint``), which moves the BN statistics
once all the same.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cut_detection_tpu_torch.config import ModelParams, TrainConfig
from cut_detection_tpu_torch.models.assembly import GluedNet
from cut_detection_tpu_torch.ops.preprocess import to_unit
from cut_detection_tpu_torch.train.losses import cross_entropy_sum
from cut_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

OPTIMIZERS = ("adamw", "adam", "sgd")


@dataclasses.dataclass
class TrainState:
    """What a training step updates: the net (parameters and BN running
    statistics), its optimizer, and the count of steps taken."""

    net: GluedNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def train_precision(cfg) -> str:
    """The net's precision for a config's ``compute_dtype``: ``None`` ->
    ``"float32"``, ``"bfloat16"`` -> ``"bfloat16_full"`` (bf16 activations,
    f32 islands).  The inference label ``"bfloat16_full"`` is refused, so
    the two vocabularies stay apart, as in the JAX package."""
    cd = getattr(cfg, "compute_dtype", None)
    if cd not in (None, "bfloat16"):
        raise ValueError(
            f"training compute_dtype must be None or 'bfloat16', got {cd!r}")
    return "float32" if cd is None else "bfloat16_full"


def model_params(cfg: TrainConfig) -> ModelParams:
    return ModelParams(conv_layers=cfg.conv_layers,
                       conv_channels=cfg.conv_hidden_channels,
                       avg_pool_size=cfg.avg_pool_size,
                       linear_layers=cfg.linear_layers,
                       linear_size=cfg.linear_size,
                       linear_output_size=cfg.output_size)


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """``"adamw"``: torch's AdamW at the reference's values (lr 1e-3,
    betas 0.9 / 0.999, eps 1e-8, weight decay 0.01), which optax.adamw
    computes, with the decay on every parameter as optax applies it to
    every leaf.  ``"adam"`` and ``"sgd"``: optax's defaults (betas 0.9 /
    0.999, eps 1e-8; no momentum).  The JAX package takes any optax name;
    the others are not ported."""
    name = cfg.optimizer.lower()
    if name == "adamw":
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    raise ValueError(f"optimizer {cfg.optimizer!r} is not ported (ported: "
                     f"{', '.join(OPTIMIZERS)}); ROADMAP.md lists what is "
                     "left to port")


def init_net(generator: torch.Generator, mp: ModelParams, precision: str,
             device=None) -> GluedNet:
    """A trainable ``GluedNet``: the JAX package's initial values drawn
    from ``generator``, in train mode on ``device`` (the CUDA device when
    ``None``; an error without one)."""
    if device is None:
        device = resolve_device()
    net = GluedNet(mp, precision)
    net.init_weights(generator)
    return net.to(device).train().requires_grad_(True)


def init_train_state(generator: torch.Generator, cfg: TrainConfig,
                     device=None) -> TrainState:
    net = init_net(generator, model_params(cfg), train_precision(cfg),
                   device)
    return TrainState(net, make_optimizer(cfg, net.parameters()))


def _to(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def optimizer_step(state: TrainState, loss: torch.Tensor) -> None:
    """Backward, the optimizer, then the BN statistics the forward
    recorded (once, however often the forward ran)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.net.apply_bn_stats()
    state.step += 1


def make_train_step(cfg: TrainConfig):
    """``step(state, x_u8, y) -> (state, metrics)``; ``x_u8``: [B, H, W, 3]
    uint8 RGB frames (divided by 255 on the net's device), ``y``: [B]
    labels.  ``metrics``: the summed ``loss``, the ``correct`` count (both
    0-dim tensors on the device) and ``n``."""
    train_precision(cfg)

    def forward(net, x):
        if cfg.remat:
            feats = checkpoint(net.conv, x, use_reentrant=False)
        else:
            feats = net.conv(x)
        return net.linear(feats)

    def step(state: TrainState, x_u8, y):
        net = state.net
        net.train()
        x = to_unit(_to(x_u8, net.device))
        y = _to(y, net.device, torch.long)
        logits = forward(net, x)
        loss = cross_entropy_sum(logits, y)
        optimizer_step(state, loss)
        correct = (logits.detach().argmax(dim=1) == y).sum()
        return state, {"loss": loss.detach(), "correct": correct,
                       "n": int(y.shape[0])}

    return step


def make_eval_step(cfg: TrainConfig):
    """``step(state, x_u8, y) -> metrics``: the net in eval mode (the block
    kernels on the card), the summed ``loss``, and per class the
    ``correct`` and ``total`` counts ([output_size] tensors)."""
    train_precision(cfg)

    @torch.no_grad()
    def step(state: TrainState, x_u8, y):
        net = state.net
        net.eval()
        y = _to(y, net.device, torch.long)
        logits = net(to_unit(_to(x_u8, net.device)))
        loss = cross_entropy_sum(logits, y)
        pred = logits.argmax(dim=1)
        classes = torch.arange(cfg.output_size, device=y.device)
        is_class = y[None, :] == classes[:, None]           # [C, B]
        correct = (is_class & (pred == y)[None, :]).sum(dim=1)
        return {"loss": loss, "correct": correct, "total": is_class.sum(1)}

    return step


@dataclasses.dataclass
class EpochMetrics:
    loss: float = 0.0
    n: int = 0
    correct: int = 0


def train_supervised(cfg: TrainConfig, datasets, *, device=None,
                     num_workers: int = 4,
                     state: TrainState | None = None,
                     checkpoint_dir: str | None = None,
                     start_epoch: int = 0) -> dict[str, Any]:
    """The training loop over a list of ``SupervisedFrameDataset``-likes
    (``supervised.py:train_supervised``): returns ``{"state", "history"}``.
    Without ``state`` the net is initialised from
    ``torch.Generator().manual_seed(cfg.seed)`` on ``device`` (the CUDA
    device when ``None``; an error without one).  A resumed
    run passes ``start_epoch``, which continues the epoch numbering of the
    log and the snapshots."""
    from cut_detection_tpu_torch.data.frames import ConcatDataset
    from cut_detection_tpu_torch.data.loader import (
        PrefetchLoader,
        iter_batches,
    )

    ds = ConcatDataset(datasets)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(ds))
    split = int(np.floor(len(ds) * (1 - cfg.valid_fraction)))
    train_idx, valid_idx = perm[:split], perm[split:]
    logger.info("Training frames: %d | Validation frames: %d",
                len(train_idx), len(valid_idx))

    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    if state is None:
        state = init_train_state(torch.Generator().manual_seed(cfg.seed),
                                 cfg, device)

    history = []
    for epoch in range(start_epoch, cfg.epochs):
        logger.info("Starting epoch %d of %d", epoch + 1, cfg.epochs)
        m = EpochMetrics()
        wl, wn = 0.0, 0  # the windowed log line's sums, reset per line
        # The tail batch is kept (reference drop_last=False).
        batches = iter_batches(ds, cfg.batch_size, indices=train_idx,
                               shuffle=True, seed=cfg.seed + epoch,
                               drop_last=False, num_workers=num_workers)
        for i, batch in enumerate(PrefetchLoader(batches)):
            state, metrics = train_step(state, batch["x"], batch["y"])
            loss = float(metrics["loss"])
            m.loss += loss
            m.n += metrics["n"]
            m.correct += int(metrics["correct"])
            wl += loss
            wn += metrics["n"]
            if i % cfg.write_every_n == cfg.write_every_n - 1:
                logger.info("Epoch %d | Batch %d | Loss: %.3f",
                            epoch + 1, i + 1, wl / max(wn, 1))
                wl, wn = 0.0, 0
        history.append({"epoch": epoch,
                        "train_loss": m.loss / max(m.n, 1),
                        "train_acc": m.correct / max(m.n, 1)})

        correct = np.zeros(cfg.output_size)
        total = np.zeros(cfg.output_size)
        vloss, vn = 0.0, 0
        batches = iter_batches(ds, cfg.batch_size, indices=valid_idx,
                               drop_last=False, num_workers=num_workers)
        for batch in PrefetchLoader(batches):
            metrics = eval_step(state, batch["x"], batch["y"])
            correct += metrics["correct"].cpu().numpy()
            total += metrics["total"].cpu().numpy()
            vloss += float(metrics["loss"])
            vn += int(metrics["total"].sum())
        for c, name in enumerate(["A22", "EZ", "blank"][: cfg.output_size]):
            logger.info("Valid accuracy for %s: %.3f", name,
                        correct[c] / max(total[c], 1))
        history[-1].update({
            "valid_loss": vloss / max(vn, 1),
            "valid_acc_per_class": (correct / np.maximum(total, 1)).tolist(),
        })
        if (checkpoint_dir and cfg.checkpoint_every_n
                and (epoch + 1) % cfg.checkpoint_every_n == 0):
            from cut_detection_tpu_torch.train.checkpointing import (
                save_train_state,
            )

            save_train_state(checkpoint_dir, state, cfg, epoch)

    return {"state": state, "history": history}
