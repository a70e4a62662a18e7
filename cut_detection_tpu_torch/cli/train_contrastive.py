"""Contrastive (SimCLR) pretraining CLI on PyTorch + CUDA.

Same flags and defaults as ``cut_detection_tpu/cli/train_contrastive.py``
(reference training_scripts/learn_contrasts.py).  Training runs on the
CUDA device, or on the CPU with ``--cpu``; without a CUDA device and
without ``--cpu`` it stops with an error.  It writes
``{name}_conv.npz`` (which ``train_supervised --load-conv-net`` reads),
``{name}_linear.npz`` (the projection head) and
``{name}_embed_params.json``.  ``--data-parallel``: as in
``train_supervised``.

    python -m cut_detection_tpu_torch.cli.train_contrastive \\
        --data-dir FRAMES_DIR [--fast-augment] \\
        [--precision {float32,bfloat16}] [--model-dir DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from cut_detection_tpu_torch.cli.train_supervised import (
    refuse_data_parallel,
    start,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SimCLR pretraining of the conv backbone.",
                                fromfile_prefix_chars="@")
    p.add_argument("--data-dir", type=str, required=True,
                   help="Directory of frames (learn_contrasts.py:58).")
    p.add_argument("--conv-layers", type=int, default=3)
    p.add_argument("--conv-hidden-channels", type=int, default=32)
    p.add_argument("--linear-layers", type=int, default=3)
    p.add_argument("--linear-size", type=int, default=32)
    p.add_argument("--output-size", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--write-every-n", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--model-dir", type=str, default="./models")
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 = mixed precision (bf16 activations, "
                        "f32 params/optimizer; NT-Xent and BN stats stay "
                        "f32).")
    p.add_argument("--fast-augment", action="store_true",
                   help="Composed affine+crop gather (spatially exact; "
                        "color-jitter divergences documented in "
                        "train/augment.py).")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--data-parallel", action="store_true",
                   help="Shard batches over all local devices (one "
                        "device: unsharded; several: not ported yet).")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def main(args=None) -> None:
    parser = build_parser()
    ns = parser.parse_args(args)
    refuse_data_parallel(parser, ns)
    device = start(parser, ns)

    from cut_detection_tpu_torch.checkpoint.io import save_bundle
    from cut_detection_tpu_torch.config import ContrastiveConfig
    from cut_detection_tpu_torch.data.frames import ContrastiveFrameDataset
    from cut_detection_tpu_torch.train.contrastive import train_contrastive

    cfg = ContrastiveConfig(
        conv_layers=ns.conv_layers,
        conv_hidden_channels=ns.conv_hidden_channels,
        linear_layers=ns.linear_layers,
        linear_size=ns.linear_size,
        output_size=ns.output_size,
        batch_size=ns.batch_size,
        epochs=ns.epochs,
        write_every_n=ns.write_every_n,
        learning_rate=ns.learning_rate,
        temperature=ns.temperature,
        model_dir=ns.model_dir,
        model_name=ns.model_name,
        seed=ns.seed,
        compute_dtype=None if ns.precision == "float32" else ns.precision,
        fast_augment=ns.fast_augment,
    )
    ds = ContrastiveFrameDataset(ns.data_dir, ext=".jpg")
    logging.info("Dataset size: %d frames", len(ds))

    result = train_contrastive(cfg, ds, device=device,
                               num_workers=ns.num_workers)

    # The conv net and the projection head (learn_contrasts.py:131-132),
    # and the sidecar that makes the pair loadable as an embedding net.
    os.makedirs(cfg.model_dir, exist_ok=True)
    bundle = result["state"].net.bundle()
    save_bundle(os.path.join(cfg.model_dir, f"{cfg.model_name}_conv.npz"),
                bundle["conv"])
    save_bundle(os.path.join(cfg.model_dir, f"{cfg.model_name}_linear.npz"),
                bundle["linear"])
    with open(os.path.join(cfg.model_dir,
                           f"{cfg.model_name}_embed_params.json"), "w") as f:
        json.dump({
            "conv_layers": cfg.conv_layers,
            "conv_channels": cfg.conv_hidden_channels,
            "avg_pool_size": 1,          # learn_contrasts.py:68-70
            "linear_layers": cfg.linear_layers,
            "linear_size": cfg.linear_size,
            "linear_output_size": cfg.output_size,
        }, f)
    logging.info("Saved conv + projection head to %s", cfg.model_dir)


if __name__ == "__main__":
    main()
