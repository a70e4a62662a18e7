"""The port's CLI at ``--precision uint8_pool`` and ``uint8_chain`` on the
committed golden clips, on the CPU.

With the default flags each rung's CSV is the JAX CLI's at the same rung
byte for byte, and both are ``tests/golden/ref_segments.csv`` and
``ref_segments_odd.csv`` (``tests/test_golden.py:22-38`` pins
``uint8_pool`` on the first).  With ``--device-resize`` (cv2's resize on
the device, bit-exact) the bytes are the same.  ``--device-resize
--pallas-preprocess`` (a float bilinear resize into the unfolded net) is
held to the reference segments by frame accuracy, as at the bf16 rungs.
"""

import os

import pytest

from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.cli.evaluate import evaluate

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIPS = [("clip.mp4", "ref_segments.csv", 220),
         ("clip_odd.mp4", "ref_segments_odd.csv", 200)]
RUNGS = ["uint8_pool", "uint8_chain"]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _run(tmp_path, clip, precision, flags=()):
    out = str(tmp_path / "out.csv")
    cli.main([os.path.join(GOLDEN, clip), "--cpu", "--transfer", "bgr",
              "--precision", precision, "--output_path", out,
              "--print-every", "0", *flags])
    return out


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("clip,ref,n", CLIPS)
def test_cli_quantized_rungs_match_jax_cli(tmp_path, clip, ref, n,
                                           precision):
    ours = _read(_run(tmp_path, clip, precision))
    theirs = str(tmp_path / "jax.csv")
    jax_segment(os.path.join(GOLDEN, clip), theirs, print_every=0,
                precision=precision, transfer="bgr")
    assert ours == _read(theirs) == _read(os.path.join(GOLDEN, ref))


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("clip,ref,n", CLIPS)
def test_cli_quantized_rungs_with_device_resize(tmp_path, clip, ref, n,
                                                precision):
    out = _run(tmp_path, clip, precision, ["--device-resize"])
    assert _read(out) == _read(os.path.join(GOLDEN, ref))


@pytest.mark.parametrize("precision", RUNGS)
def test_cli_quantized_rungs_with_pallas_preprocess(tmp_path, precision):
    clip, ref, n = CLIPS[0]
    out = _run(tmp_path, clip, precision,
               ["--device-resize", "--pallas-preprocess"])
    res = evaluate(out, os.path.join(GOLDEN, ref), n)
    assert res["frame_accuracy"] >= 0.99, res
