"""The port's CLI at ``--precision bfloat16`` and ``bfloat16_full`` on
the committed golden clips, on the CPU.

Both rungs give ``tests/golden/ref_segments.csv`` and
``ref_segments_odd.csv`` byte for byte with the resize on the host and
with ``--device-resize``.  That is a pin of measured behaviour, as
``tests/test_golden.py`` pins ``uint8_pool``: the rungs promise accuracy
(the eval-corpus gates of ``tests/test_torch_eval_corpus.py``), not
bytes.  ``--device-resize --pallas-preprocess`` (a float bilinear resize,
not cv2's) is held to the reference segments by frame accuracy; its CSVs
were byte-identical too when this was written.
"""

import os

import pytest

from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.cli.evaluate import evaluate

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIPS = [("clip.mp4", "ref_segments.csv", 220),
         ("clip_odd.mp4", "ref_segments_odd.csv", 200)]


def _run(tmp_path, clip, precision, flags):
    out = str(tmp_path / "out.csv")
    cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "bgr",
              "--precision", precision, "--output_path", out,
              "--print-every", "0", *flags])
    with open(out, "rb") as f:
        return out, f.read()


@pytest.mark.parametrize("flags", [[], ["--device-resize"]])
@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_full"])
@pytest.mark.parametrize("clip,ref,n", CLIPS)
def test_cli_bf16_rungs_match_golden_csv(tmp_path, clip, ref, n, precision,
                                         flags):
    _, got = _run(tmp_path, clip, precision, flags)
    with open(os.path.join(GOLDEN, ref), "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("precision", ["bfloat16", "bfloat16_full"])
@pytest.mark.parametrize("clip,ref,n", CLIPS)
def test_cli_bf16_rungs_with_pallas_preprocess(tmp_path, clip, ref, n,
                                               precision):
    out, _ = _run(tmp_path, clip, precision,
                  ["--device-resize", "--pallas-preprocess"])
    res = evaluate(out, os.path.join(GOLDEN, ref), n)
    assert res["frame_accuracy"] >= 0.99, res
