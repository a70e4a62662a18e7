"""The port's ``bench_fused_conv1`` entry point on the CPU, at batch 2 and
one step, every stage: the JSON keys of ``scripts/bench_fused_conv1.py``
are there, the graphs agree where the JAX script compares them, and the
timing keys are those of the stage.  On the CPU the graphs run the
kernels' plain versions and the times are the host's, so the JSON names
the device ``"cpu"``; the card's numbers come from ``chip_smoke.py``.
"""

import json

import pytest
import torch

from cut_detection_tpu_torch.scripts import bench_fused_conv1 as bench

PARITY_KEYS = {"l1_max_diff", "l1_frac_gt_1e3", "l1_p999_diff",
               "argmax_flips"}
BLOCK_KEYS = {"full_argmax_flips", "full_max_logit_diff"}
MID_KEYS = {"mid_argmax_flips", "mid_max_logit_diff"}


@pytest.mark.parametrize("stage", list(bench.STAGES))
def test_every_stage_on_the_cpu(stage):
    out = bench.run(batch=2, steps=1, stage=stage, device="cpu")
    want = {"batch", "stage", "steps", "device"}
    want |= {f"{g}_fps" for g in bench.STAGES[stage]}
    if stage in ("all", "parity"):
        want |= PARITY_KEYS
    if stage in ("all", "block"):
        want |= BLOCK_KEYS
    if stage == "mid":
        want |= MID_KEYS
    assert set(out) == want
    assert out["device"] == "cpu" and out["batch"] == 2
    for g in bench.STAGES[stage]:
        assert out[f"{g}_fps"] > 0
    if stage in ("all", "parity"):
        # The shipped layer 1 runs XLA's numerics, K1 the Pallas kernel's:
        # they differ (0.3125 at most, in 45% of the elements, when
        # written), and the classes hold.
        assert 0.0 < out["l1_max_diff"] < 1.0 and out["argmax_flips"] == 0
    if stage in ("all", "block"):
        assert out["full_argmax_flips"] == 0
        assert out["full_max_logit_diff"] < 0.05
    if stage == "mid":
        assert out["mid_argmax_flips"] == 0
        assert out["mid_max_logit_diff"] < 0.1


def test_main_prints_the_json_line(capsys):
    out = bench.main(["2", "1", "parity", "--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and printed["stage"] == "parity"
    with pytest.raises(ValueError, match="unknown stage"):
        bench.run(batch=2, steps=1, stage="nope", device="cpu")


def test_block_stage_chains_at_batch_16():
    """The block stage's comparison at batch 16: K1 -> K4 -> K4
    (``e2e_allfused``) equals the all-Pallas chain K1 -> K3 -> K3
    (``e2e_k3``) exactly, and holds the shipped ``bfloat16_full`` net
    (XLA's numerics) within 0.05 with no class flip (0.0266 when
    written); ``chip_smoke.py`` holds the card to the same bars."""
    graphs = bench.build_graphs(torch.device("cpu"))
    x = bench.seeded_frames(16, "cpu")
    with torch.inference_mode():
        k4 = graphs["e2e_allfused"](x)
        assert torch.equal(k4, graphs["e2e_k3"](x))
        ref = graphs["e2e_xla"](x)
    assert torch.equal(k4.argmax(1), ref.argmax(1))
    assert (k4 - ref).abs().max().item() < 0.05
