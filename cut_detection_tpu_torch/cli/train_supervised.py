"""Supervised training CLI on PyTorch + CUDA.

Same flags and defaults as ``cut_detection_tpu/cli/train_supervised.py``
(reference training_scripts/supervised_training.py's constants, or an
``@argfile``).  Training runs on the CUDA device, or on the CPU with
``--cpu``; without a CUDA device and without ``--cpu`` it stops with an
error.  ``--resume`` restores the latest ``train_state_*.npz`` in
``--model-dir`` and continues its epoch numbering; ``--load-conv-net``
warm-starts the backbone from a contrastive ``{name}_conv.npz``;
``--export-torch`` also writes the reference's ``.pt`` state dicts.
``--data-parallel`` follows the JAX CLI's rule: with one visible device
it trains unsharded; over several it trains one rank per card in a
``torch.distributed`` group (``train.supervised``'s data-parallel loop),
started here (``parallel.distributed.spawn``), or joined where torchrun
started this process as one rank; rank 0 writes the outputs.

    python -m cut_detection_tpu_torch.cli.train_supervised \\
        --data-dirs FRAMES_DIR [...] [--precision {float32,bfloat16}] \\
        [--model-dir DIR] [--model-name NAME] [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from cut_detection_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Train the frame classifier.",
                                fromfile_prefix_chars="@")
    p.add_argument("--data-dirs", nargs="+", required=True,
                   help="Frame directories (each with a labels CSV).")
    p.add_argument("--labs-file", type=str, default="frames.csv")
    p.add_argument("--conv-layers", type=int, default=3)
    p.add_argument("--conv-hidden-channels", type=int, default=48)
    p.add_argument("--avg-pool-size", type=int, default=4)
    p.add_argument("--linear-layers", type=int, default=2)
    p.add_argument("--linear-size", type=int, default=32)
    p.add_argument("--output-size", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--write-every-n", type=int, default=1000)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-2)
    p.add_argument("--data-size", type=int, default=None,
                   help="Optional per-dataset size cap.")
    p.add_argument("--model-dir", type=str, default="./models")
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--load-conv-net", action="store_true",
                   help="Warm-start the conv net from "
                        "{model_dir}/{model_name}_conv.npz "
                        "(supervised_training.py:105-110 analog).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 = mixed precision: bf16 activations "
                        "with f32 islands for BN stats and the loss; "
                        "params/grads/optimizer stay f32.")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--checkpoint-every-n", type=int, default=1,
                   help="Save a resumable full-state snapshot every N "
                        "epochs (0 disables; reference saves only at end).")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest snapshot in model-dir.")
    p.add_argument("--export-torch", action="store_true",
                   help="Also write torch .pt state dicts for the "
                        "reference implementation.")
    p.add_argument("--data-parallel", action="store_true",
                   help="Shard batches over all local devices (one rank "
                        "a card; one device: unsharded).")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def launch(parser, ns, train) -> None:
    """``train(ns, device, group)``: once per rank under
    ``--data-parallel`` over several devices
    (``parallel.distributed.run_ranks``; each rank sets up its own logging
    and float32), else once here, on the device ``--cpu`` asks for (an
    error without a card unless ``--cpu``), unsharded, as the JAX CLIs
    train on one device."""
    if ns.data_parallel:
        from cut_detection_tpu_torch.parallel.distributed import run_ranks

        if run_ranks(train, ns, cpu=ns.cpu):
            return
    from cut_detection_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(cpu=ns.cpu)
    except RuntimeError as e:
        parser.error(str(e))
    train(ns, device, None)


def start_rank(device, group) -> bool:
    """A rank's set-up: logging, float32 kept out of TF32; returns
    whether this process writes the outputs (rank 0, or no group)."""
    import torch.distributed as dist

    from cut_detection_tpu_torch.utils.device import strict_fp32

    setup_logging()
    strict_fp32()
    logging.info("Using %s%s", device, "" if group is None else
                 f" (rank {dist.get_rank(group)} of "
                 f"{dist.get_world_size(group)})")
    return group is None or dist.get_rank(group) == 0


def load_conv_net(net, path: str) -> None:
    """The backbone of ``net`` from a contrastive ``{name}_conv.npz``."""
    from cut_detection_tpu_torch.checkpoint.convert import params_from_jax
    from cut_detection_tpu_torch.checkpoint.io import load_bundle

    sd = params_from_jax({"conv": load_bundle(path),
                          "linear": {"params": [], "state": []}})
    missing, unexpected = net.load_state_dict(sd, strict=False)
    if unexpected or any(not k.startswith("linear.") for k in missing):
        raise ValueError(f"{path} does not fit this conv net: missing "
                         f"{missing}, unexpected {unexpected}")


def main(args=None) -> None:
    parser = build_parser()
    launch(parser, parser.parse_args(args), train)


def train(ns, device, group) -> None:
    """The CLI's work on ``device``, as one rank of ``group`` or alone."""
    lead = start_rank(device, group)

    import torch

    from cut_detection_tpu_torch.config import TrainConfig
    from cut_detection_tpu_torch.data.frames import SupervisedFrameDataset
    from cut_detection_tpu_torch.train.checkpointing import (
        latest_checkpoint,
        load_train_state,
        save_model_triplet,
    )
    from cut_detection_tpu_torch.train.supervised import (
        init_train_state,
        train_supervised,
    )

    cfg = TrainConfig(
        conv_layers=ns.conv_layers,
        conv_hidden_channels=ns.conv_hidden_channels,
        avg_pool_size=ns.avg_pool_size,
        linear_layers=ns.linear_layers,
        linear_size=ns.linear_size,
        output_size=ns.output_size,
        batch_size=ns.batch_size,
        epochs=ns.epochs,
        write_every_n=ns.write_every_n,
        learning_rate=ns.learning_rate,
        weight_decay=ns.weight_decay,
        data_size=ns.data_size,
        model_dir=ns.model_dir,
        model_name=ns.model_name,
        load_conv_net=ns.load_conv_net,
        seed=ns.seed,
        checkpoint_every_n=ns.checkpoint_every_n,
        compute_dtype=None if ns.precision == "float32" else ns.precision,
    )

    datasets = [
        SupervisedFrameDataset(d, ns.labs_file, ext=".jpg", size=ns.data_size)
        for d in ns.data_dirs
    ]

    state = None
    start_epoch = 0
    if ns.load_conv_net or ns.resume:
        state = init_train_state(torch.Generator().manual_seed(cfg.seed),
                                 cfg, device)
    if ns.resume:
        ckpt = latest_checkpoint(cfg.model_dir)
        if ckpt:
            logging.info("Resuming from %s", ckpt)
            state = load_train_state(ckpt, state)
            # Continue the epoch numbering: a resumed run that restarted
            # at epoch 0 would write train_state_0000.npz below the
            # earlier snapshots, and the next resume would take the stale
            # latest one.
            m_ep = re.search(r"train_state_(\d+)\.npz$", ckpt)
            if m_ep:
                start_epoch = int(m_ep.group(1)) + 1
                if start_epoch >= cfg.epochs:
                    logging.info(
                        "Snapshot is from the final epoch (%d of %d); "
                        "nothing left to train.", start_epoch, cfg.epochs)
    elif ns.load_conv_net:
        path = os.path.join(cfg.model_dir, f"{cfg.model_name}_conv.npz")
        logging.info("Loading pre-trained conv net from: %s", path)
        load_conv_net(state.net, path)

    result = train_supervised(cfg, datasets, device=device,
                              num_workers=ns.num_workers, state=state,
                              checkpoint_dir=cfg.model_dir,
                              start_epoch=start_epoch, group=group)

    if lead:
        save_model_triplet(cfg.model_dir, cfg.model_name, result["state"],
                           cfg, export_torch=ns.export_torch)
        logging.info("Saved model triplet to %s", cfg.model_dir)


if __name__ == "__main__":
    main()
