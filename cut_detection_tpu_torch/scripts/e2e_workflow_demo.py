"""The reference's whole training workflow, end to end, in one command.

Port of ``scripts/e2e_workflow_demo.py``: every stage a user runs in
production order, each through the port's own command line:

  1. synthesize a labelled "game" clip and a held-out clip
     (naturalistic 1/f-textured content, ``make_eval_corpus.write_clip``)
  2. ``cli.split_video``         -> frame JPEGs
  3. ``frames.csv`` from the designed blocks (what a labelling session
     produces; the labels are known by construction)
  4. ``cli.train_contrastive``   -> a SimCLR-pretrained conv backbone
  5. ``cli.train_supervised --load-conv-net`` -> a warm-started triplet
  6. ``cli.segment_video --model-dir`` -> the held-out clip's CSV
  7. ``cli.evaluate``            -> frame accuracy and boundary P/R
     against the designed truth

It prints one JSON line with each stage's wall time and the scores, with
the JAX script's keys.  Every stage runs on the card unless ``--cpu``
is given, which every stage then takes; without a card and without
``--cpu`` it stops before the first stage.

    python -m cut_detection_tpu_torch.scripts.e2e_workflow_demo \\
        [--workdir DIR] [--cpu] [--small] [--contrastive-epochs N] \\
        [--supervised-epochs N]

The model is the reference's prod shape (3 conv layers of 48 channels,
pool 4, FC 768->32->3) unless ``--small`` (8 channels x 2, pool 2, FC 8).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
import tempfile
import time

from cut_detection_tpu_torch.scripts.make_eval_corpus import (
    write_clip,
    write_truth,
)

# The JAX script's palette and blocks: colours with wide logit margins,
# block lengths a fixed point of the smoother's default thresholds.
TRAIN_BLOCKS = [
    ("a22", 150, (60, 60, 140)), ("b", 20, (10, 10, 10)),
    ("ez", 150, (160, 160, 30)), ("a22", 140, (0, 60, 120)),
    ("b", 20, (40, 120, 40)), ("ez", 130, (160, 160, 30)),
    ("a22", 140, (80, 140, 200)),
]
EVAL_BLOCKS = [
    ("ez", 140, (160, 160, 30)), ("a22", 150, (0, 60, 120)),
    ("b", 25, (10, 10, 10)), ("a22", 130, (60, 60, 140)),
    ("ez", 140, (160, 160, 30)), ("b", 20, (40, 120, 40)),
    ("a22", 150, (80, 140, 200)),
]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="Working directory (default: a fresh tempdir).")
    ap.add_argument("--cpu", action="store_true",
                    help="Run every stage on the CPU.")
    ap.add_argument("--small", action="store_true",
                    help="Tiny model (8ch x 2) for a fast smoke run.")
    ap.add_argument("--contrastive-epochs", type=int, default=1)
    # The reference's 3-epoch default assumes ~150k training frames; this
    # corpus is 750, so more passes reach a comparable step count.
    ap.add_argument("--supervised-epochs", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    from cut_detection_tpu_torch.utils.device import card_info, resolve_device

    device = resolve_device(cpu=ns.cpu)
    backend = "cpu" if device.type == "cpu" else card_info()

    work = ns.workdir or tempfile.mkdtemp(prefix="cutdet_workflow_")
    os.makedirs(work, exist_ok=True)
    frames_dir = os.path.join(work, "frames")
    model_dir = os.path.join(work, "models")
    cpu = ["--cpu"] if ns.cpu else []
    if ns.small:
        conv = ["--conv-hidden-channels", "8", "--conv-layers", "2"]
        sup_shape = conv + ["--avg-pool-size", "2", "--linear-size", "8"]
    else:  # the reference's prod config
        conv = ["--conv-hidden-channels", "48", "--conv-layers", "3"]
        sup_shape = conv + ["--avg-pool-size", "4", "--linear-size", "32"]

    stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(name: str):
        t0 = time.perf_counter()
        yield
        stages[name] = round(time.perf_counter() - t0, 2)
        print(f"[workflow] {name}: {stages[name]}s", file=sys.stderr,
              flush=True)

    # 1. Data: a labelled training "game" and a held-out clip.
    with stage("synthesize"):
        train_clip = os.path.join(work, "train_game.mp4")
        eval_clip = os.path.join(work, "eval_game.mp4")
        train_truth = write_clip(train_clip, TRAIN_BLOCKS, seed=11,
                                 natural=True)
        eval_truth_rows = write_clip(eval_clip, EVAL_BLOCKS, seed=23,
                                     natural=True)
        truth_csv = os.path.join(work, "eval_truth.csv")
        write_truth(truth_csv, eval_truth_rows)

    # 2. Frame extraction (frame_%07d.jpg).
    with stage("split_video"):
        from cut_detection_tpu_torch.cli.split_video import main as split_main

        split_main([train_clip, frames_dir, "--resize", "256"])

    # 3. Labels: frames.csv range starts from the designed blocks.
    with open(os.path.join(frames_dir, "frames.csv"), "w", newline="") as f:
        w = csv.writer(f)
        for start, label in train_truth:
            w.writerow([start, label])

    # 4. SimCLR pretraining of the conv backbone.
    with stage("contrastive_pretrain"):
        from cut_detection_tpu_torch.cli.train_contrastive import (
            main as tc_main,
        )

        tc_main(cpu + conv + [
            "--data-dir", frames_dir, "--model-dir", model_dir,
            "--model-name", "demo", "--batch-size", "32",
            "--epochs", str(ns.contrastive_epochs), "--fast-augment",
            "--precision", "bfloat16", "--num-workers", "0",
            "--write-every-n", "10",
        ])

    # 5. Supervised training, warm-started from the pretrained conv.
    with stage("supervised_train"):
        from cut_detection_tpu_torch.cli.train_supervised import (
            main as ts_main,
        )

        ts_main(cpu + sup_shape + [
            "--data-dirs", frames_dir, "--model-dir", model_dir,
            "--model-name", "demo", "--load-conv-net",
            "--batch-size", "128", "--epochs", str(ns.supervised_epochs),
            "--precision", "bfloat16", "--num-workers", "0",
            "--checkpoint-every-n", "0", "--write-every-n", "5",
        ])

    # 6. Inference on the held-out clip with the new model.
    with stage("segment_video"):
        from cut_detection_tpu_torch.cli import segment_video

        out_csv = os.path.join(work, "eval_segments.csv")
        segment_video.main(cpu + [eval_clip, "--output_path", out_csv,
                                  "--model-dir", model_dir,
                                  "--model-name", "demo",
                                  "--print-every", "0"])

    # 7. Score against the designed truth.
    with stage("evaluate"):
        from cut_detection_tpu_torch.cli.evaluate import evaluate

        n_frames = sum(b[1] for b in EVAL_BLOCKS)
        scores = evaluate(out_csv, truth_csv, num_frames=n_frames,
                          tolerance=15)

    record = {
        "workflow": "split -> label -> contrastive -> supervised(warm) "
                    "-> segment -> evaluate",
        "backend": backend,
        "model": "small" if ns.small else "prod-shape",
        "train_frames": sum(b[1] for b in TRAIN_BLOCKS),
        "eval_frames": n_frames,
        "stages_s": stages,
        "total_s": round(sum(stages.values()), 2),
        "scores": {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in scores.items()},
        "workdir": work,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
