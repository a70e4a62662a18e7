"""``embed_frames``: a contrastive model's embeddings of a video or frames.

Counterpart of ``cut_detection_tpu/cli/embed_frames.py`` (``:21-109``),
with the JAX parser's flags and defaults.  It runs a contrastive (conv +
projection head) pair, ``models.assembly.load_embedding_net``, over a
video (``VideoFrameSource`` at ``--resize``) or a directory of
``frame_*.jpg`` (``ContrastiveFrameDataset``, flipped back to BGR), in
batches of ``--batch-size`` (the last one zero-padded): each batch is
uploaded as uint8, normalized on the device (``ops.preprocess.
normalize_frames``) and embedded, and only the valid rows are kept.  The
embeddings are written as ``np.savez(output, embeddings=[N, D])``.  The
net runs on the CUDA device (the ``conv_block`` kernel on every layer of
float frames), or on the CPU with ``--cpu``; without a CUDA device and
without ``--cpu`` it stops with an error.

    python -m cut_detection_tpu_torch.cli.embed_frames INPUT \\
        --model-dir DIR [--model-name NAME] [--output OUT.npz] \\
        [--batch-size N] [--resize N] [--frame-limit N] \\
        [--precision P] [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from cut_detection_tpu_torch.config import PRECISION_CHOICES
from cut_detection_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Embed frames with a contrastive model.",
                                fromfile_prefix_chars="@")
    p.add_argument("input_path", type=str,
                   help="Video file or directory of frames.")
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", type=str, default="init_model")
    p.add_argument("--output", type=str, default=None,
                   help="Output .npz (default: input stem + "
                        "_embeddings.npz).")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--frame-limit", type=int, default=None)
    p.add_argument("--precision",
                   choices=list(PRECISION_CHOICES),
                   default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (otherwise a CUDA device is "
                        "required).")
    return p


def main(args=None) -> str:
    parser = build_parser()
    ns = parser.parse_args(args)
    setup_logging()

    import torch

    from cut_detection_tpu_torch.data.video import batch_frames
    from cut_detection_tpu_torch.models.assembly import load_embedding_net
    from cut_detection_tpu_torch.ops.preprocess import normalize_frames
    from cut_detection_tpu_torch.utils.device import (
        resolve_device,
        strict_fp32,
    )

    try:
        device = resolve_device(cpu=ns.cpu)
    except RuntimeError as e:
        parser.error(str(e))
    strict_fp32()
    logging.info("Using %s", device)

    net, params = load_embedding_net(ns.model_dir, ns.model_name, device,
                                     ns.precision)
    logging.info("Embedding model: %s", params)

    if os.path.isdir(ns.input_path):
        from cut_detection_tpu_torch.data.frames import (
            ContrastiveFrameDataset,
        )

        ds = ContrastiveFrameDataset(ns.input_path, ext=".jpg")

        def frames():
            # --frame-limit 0 means zero frames, as in the video branch.
            limit = ns.frame_limit if ns.frame_limit is not None else len(ds)
            for i in range(min(limit, len(ds))):
                # The dataset yields RGB; normalize_frames takes BGR.
                yield ds[i]["x"][..., ::-1]
    else:
        from cut_detection_tpu_torch.data.video import VideoFrameSource

        def frames():
            src = VideoFrameSource(ns.input_path, resize=ns.resize)
            for i, f in enumerate(src):
                if ns.frame_limit is not None and i >= ns.frame_limit:
                    break
                yield f

    embs = []
    count = 0
    with torch.inference_mode():
        for batch, valid in batch_frames(frames(), ns.batch_size):
            x = normalize_frames(torch.from_numpy(batch).to(device))
            embs.append(net(x)[:valid].cpu().numpy())
            count += valid
    out = np.concatenate(embs) if embs else np.zeros((0,), np.float32)

    output = ns.output or os.path.splitext(ns.input_path.rstrip("/"))[0] \
        + "_embeddings.npz"
    np.savez(output, embeddings=out)
    logging.info("Wrote %d embeddings (dim %d) to %s", count,
                 out.shape[-1] if out.ndim == 2 else 0, output)
    return output


if __name__ == "__main__":
    main()
