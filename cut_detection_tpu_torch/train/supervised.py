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

Under a ``torch.distributed`` group (``group``; one rank per card, see
``parallel.distributed``) the steps are JAX's sharded steps
(``jit_steps(cfg, mesh)``): every rank reads the same seeded batches and
takes its rows of each (``rank_rows``); the BN statistics are the global
batch's, each rank's summed loss flows through them, the gradients are
SUM-all-reduced, and every rank takes the same optimizer step.  The loop
then drops the tail train batch, as JAX's does under a mesh, computes an
indivisible validation tail whole on every rank and counts it once, and
leaves the logs and snapshots to rank 0.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
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


def rank_rows(n: int, group) -> slice:
    """This rank's rows of a global batch of ``n``: ``[r n / N, (r + 1) n
    / N)`` for rank r of N (all of them without a group).  Raises where
    ``n`` does not divide over the ranks."""
    if group is None:
        return slice(0, n)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"batch of {n} must divide over the data axis "
                         f"({world} ranks)")
    return slice(rank * n // world, (rank + 1) * n // world)


def optimizer_step(state: TrainState, loss: torch.Tensor,
                   group=None) -> None:
    """Backward, the gradients SUM-all-reduced over ``group``, the
    optimizer, then the BN statistics the forward recorded (once, however
    often the forward ran)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None:
        from cut_detection_tpu_torch.parallel.distributed import (
            all_reduce_grads,
        )

        all_reduce_grads(state.net.parameters(), group)
    state.optimizer.step()
    state.net.apply_bn_stats()
    state.step += 1


def make_train_step(cfg: TrainConfig, group=None):
    """``step(state, x_u8, y) -> (state, metrics)``; ``x_u8``: [B, H, W, 3]
    uint8 RGB frames (divided by 255 on the net's device), ``y``: [B]
    labels.  ``metrics``: the summed ``loss``, the ``correct`` count (both
    0-dim tensors on the device) and ``n``.  Under ``group`` the frames are
    this rank's rows of the global batch (``rank_rows``) and the metrics
    the global batch's."""
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
        net.set_process_group(group)
        x = to_unit(_to(x_u8, net.device))
        y = _to(y, net.device, torch.long)
        logits = forward(net, x)
        loss = cross_entropy_sum(logits, y)
        optimizer_step(state, loss, group)
        correct = (logits.detach().argmax(dim=1) == y).sum()
        n = int(y.shape[0])
        if group is None:
            return state, {"loss": loss.detach(), "correct": correct,
                           "n": n}
        sums = torch.stack([loss.detach().double(), correct.double()])
        dist.all_reduce(sums, group=group)
        return state, {"loss": sums[0].float(), "correct": sums[1].long(),
                       "n": n * dist.get_world_size(group)}

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
                     start_epoch: int = 0, group=None) -> dict[str, Any]:
    """The training loop over a list of ``SupervisedFrameDataset``-likes
    (``supervised.py:train_supervised``): returns ``{"state", "history"}``.
    Without ``state`` the net is initialised from
    ``torch.Generator().manual_seed(cfg.seed)`` on ``device`` (the CUDA
    device when ``None``; an error without one).  A resumed
    run passes ``start_epoch``, which continues the epoch numbering of the
    log and the snapshots.  ``group``: the data-parallel loop (module
    docstring); ``cfg.batch_size`` must divide over its ranks, and every
    rank returns the same history and an equal state."""
    from cut_detection_tpu_torch.data.frames import ConcatDataset
    from cut_detection_tpu_torch.data.loader import (
        PrefetchLoader,
        iter_batches,
    )

    shard = None
    if group is not None:
        shard = (dist.get_rank(group), dist.get_world_size(group))
        rank_rows(cfg.batch_size, group)  # raises where it does not divide
    lead = shard is None or shard[0] == 0  # logs and writes snapshots
    log = logger.info if lead else (lambda *args: None)

    ds = ConcatDataset(datasets)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(ds))
    split = int(np.floor(len(ds) * (1 - cfg.valid_fraction)))
    train_idx, valid_idx = perm[:split], perm[split:]
    log("Training frames: %d | Validation frames: %d",
        len(train_idx), len(valid_idx))
    # Under a group the validation batches shard like the train batches,
    # but for a tail that does not divide over the ranks: every rank
    # computes that one whole, and it is counted once.
    tail = len(valid_idx) % cfg.batch_size
    whole = tail if shard is not None and tail % shard[1] else 0
    valid_sharded = valid_idx[:len(valid_idx) - whole]
    valid_whole = valid_idx[len(valid_idx) - whole:]

    train_step = make_train_step(cfg, group)
    eval_step = make_eval_step(cfg)
    if state is None:
        state = init_train_state(torch.Generator().manual_seed(cfg.seed),
                                 cfg, device)

    history = []
    for epoch in range(start_epoch, cfg.epochs):
        log("Starting epoch %d of %d", epoch + 1, cfg.epochs)
        m = EpochMetrics()
        wl, wn = 0.0, 0  # the windowed log line's sums, reset per line
        # The tail batch is kept (reference drop_last=False), but under a
        # group, as JAX drops it under a mesh: padding would pollute the
        # BN statistics.
        batches = iter_batches(ds, cfg.batch_size, indices=train_idx,
                               shuffle=True, seed=cfg.seed + epoch,
                               drop_last=shard is not None,
                               num_workers=num_workers, shard=shard)
        for i, batch in enumerate(PrefetchLoader(batches)):
            state, metrics = train_step(state, batch["x"], batch["y"])
            loss = float(metrics["loss"])
            m.loss += loss
            m.n += metrics["n"]
            m.correct += int(metrics["correct"])
            wl += loss
            wn += metrics["n"]
            if i % cfg.write_every_n == cfg.write_every_n - 1:
                log("Epoch %d | Batch %d | Loss: %.3f",
                    epoch + 1, i + 1, wl / max(wn, 1))
                wl, wn = 0.0, 0
        history.append({"epoch": epoch,
                        "train_loss": m.loss / max(m.n, 1),
                        "train_acc": m.correct / max(m.n, 1)})

        # Per class: loss, correct, total; the sharded part summed over
        # the ranks in one collective, then the whole tail added once.
        sums = [torch.zeros(2 * cfg.output_size + 1, dtype=torch.float64)
                for _ in range(2)]
        for part, (idx, part_shard) in enumerate(
                ((valid_sharded, shard), (valid_whole, None))):
            batches = iter_batches(ds, cfg.batch_size, indices=idx,
                                   drop_last=False, num_workers=num_workers,
                                   shard=part_shard)
            for batch in PrefetchLoader(batches):
                metrics = eval_step(state, batch["x"], batch["y"])
                sums[part] += torch.cat([
                    metrics["loss"].reshape(1).double(),
                    metrics["correct"].double(),
                    metrics["total"].double()]).cpu()
        if shard is not None:
            reduced = sums[0].to(state.net.device)
            dist.all_reduce(reduced, group=group)
            sums[0] = reduced.cpu()
        total_sums = (sums[0] + sums[1]).numpy()
        vloss = total_sums[0]
        correct = total_sums[1:1 + cfg.output_size]
        total = total_sums[1 + cfg.output_size:]
        vn = int(total.sum())
        for c, name in enumerate(["A22", "EZ", "blank"][: cfg.output_size]):
            log("Valid accuracy for %s: %.3f", name,
                correct[c] / max(total[c], 1))
        history[-1].update({
            "valid_loss": float(vloss / max(vn, 1)),
            "valid_acc_per_class": (correct / np.maximum(total, 1)).tolist(),
        })
        if (lead and checkpoint_dir and cfg.checkpoint_every_n
                and (epoch + 1) % cfg.checkpoint_every_n == 0):
            from cut_detection_tpu_torch.train.checkpointing import (
                save_train_state,
            )

            save_train_state(checkpoint_dir, state, cfg, epoch)

    return {"state": state, "history": history}
