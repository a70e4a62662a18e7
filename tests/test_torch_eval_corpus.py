"""The port's bf16 and quantized rungs on the labelled eval corpus, on
the CPU, held to the JAX package's own gates
(``tests/test_eval_corpus.py``):

- ``corpus_a``: frame accuracy >= 0.99, boundary precision and recall
  >= 0.90 (30-frame tolerance);
- ``corpus_adv``: frame accuracy >= 0.96 — its two 9-frame blocks sit
  on a class boundary (logit margins 0.021 and 0.029) and may glue
  either way;
- ``corpus_nat``: frame accuracy 1.0 at ``bfloat16_full``,
  ``uint8_pool`` and ``uint8_chain``, the default gate at ``bfloat16``.

``bfloat16`` and ``bfloat16_full`` have the JAX rungs' numerics up to
summation order (``bfloat16_full`` XLA's, as the compiled JAX step
computes it), so on ``corpus_adv``, the clip with the smallest margins,
their CSVs are also the JAX CLI's byte for byte.
"""

import os

import pytest

from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.cli.evaluate import evaluate

CORPUS = os.path.join(os.path.dirname(__file__), "eval_corpus")
FRAMES = {"corpus_a": 590, "corpus_adv": 593, "corpus_nat": 590}


def _segment(tmp_path, name, precision):
    out = str(tmp_path / f"{name}_{precision}.csv")
    cli.main([os.path.join(CORPUS, f"{name}.mp4"), "--cpu", "--transfer",
              "bgr", "--precision", precision, "--output_path", out,
              "--print-every", "0"])
    return out


def _gate(out, name, frame_min, boundary_min=0.90):
    res = evaluate(out, os.path.join(CORPUS, f"{name}_truth.csv"),
                   FRAMES[name], tolerance=30)
    assert res["frame_accuracy"] >= frame_min, (name, res)
    assert res["boundary_precision"] >= boundary_min, (name, res)
    assert res["boundary_recall"] >= boundary_min, (name, res)
    return res


@pytest.mark.parametrize("name,frame_min", [
    ("corpus_a", 0.99), ("corpus_adv", 0.96), ("corpus_nat", 0.99)])
@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_full",
                                       "uint8_pool", "uint8_chain"])
def test_bf16_rungs_hold_the_corpus_gates(tmp_path, precision, name,
                                          frame_min):
    res = _gate(_segment(tmp_path, name, precision), name, frame_min)
    if name == "corpus_nat" and precision != "bfloat16":
        assert res["frame_accuracy"] == 1.0, res


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_full"])
def test_bfloat16_matches_jax_csv_on_adversarial_clip(tmp_path, precision):
    ours = _segment(tmp_path, "corpus_adv", precision)
    theirs = str(tmp_path / "jax.csv")
    jax_segment(os.path.join(CORPUS, "corpus_adv.mp4"), theirs,
                print_every=0, precision=precision, transfer="bgr")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
