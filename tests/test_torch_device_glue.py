"""The port's on-device smoother and device run-length table against the
JAX package's and the port's host glue, and the profiler hook, on the
CPU.

``device_smooth`` equals JAX's (``cut_detection_tpu/segmentation/
device_glue.py``) on every seed and threshold of
``tests/test_device_glue.py``: start, type, active, end and count equal,
the means bit for bit (the segment sums add left to right as JAX's scan
does, and a merge rounds as the compiled program, which fuses one
multiply-add).  Against the host glue, the rows are equal with
``bug_compat`` both ways; the host rounds that product on its own, so
the means are held within 1e-5 relative there, the bar of the JAX test.
"""

import logging
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from cut_detection_tpu.segmentation.device_glue import (
    device_smooth as jax_device_smooth,
)
from cut_detection_tpu_torch.cli import segment_video as cli
from cut_detection_tpu_torch.segmentation import device_glue
from cut_detection_tpu_torch.segmentation.device_glue import (
    device_smooth,
    smooth_logits,
    smooth_tables,
)
from cut_detection_tpu_torch.segmentation.rle import (
    Segmentation,
    device_frame_scores,
    device_segment_reduce,
    device_segment_reduce_unchecked,
)
from cut_detection_tpu_torch.utils import profiling

T = torch.from_numpy
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_device_glue.py's cases: (seed, frames, k1, kb).
JAX_CASES = [(0, 2000, 100, 10), (1, 5000, 100, 10), (2, 1200, 50, 5),
             (3, 8000, 100, 10), (4, 600, 20, 20), (5, 3000, 150, 30)]


def _random_scores(rng, n, segment_scale=60):
    """``tests/test_device_glue.py:_random_scores``: runs of one class
    with noisy logits."""
    labels = []
    while sum(len(s) for s in labels) < n:
        labels.append(np.full(int(rng.integers(1, segment_scale)),
                              rng.integers(0, 3)))
    lab = np.concatenate(labels)[:n]
    scores = rng.normal(0, 1, size=(n, 3)).astype(np.float32)
    scores[np.arange(n), lab] += rng.uniform(1, 6, size=n).astype(np.float32)
    return scores


def _vectors(scores):
    return (scores.max(1).astype(np.float32),
            scores.argmax(1).astype(np.int32))


def _host_table(scores, k1, kb, bug_compat=True):
    seg = Segmentation(scores)
    seg.glue_orphans(k1, kb, bug_compat=bug_compat, backend="python")
    seg.combine_adjacent_segments(bug_compat=bug_compat, backend="python")
    return seg.te


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("seed,n,k1,kb", JAX_CASES)
def test_device_smooth_matches_jax(seed, n, k1, kb, bug_compat):
    scores = _random_scores(np.random.default_rng(seed), n,
                            segment_scale=120)
    conf, pred = _vectors(scores)
    want = [np.asarray(a) for a in jax_device_smooth(
        conf, pred, k1, kb, max_segments=4096, bug_compat=bug_compat)]
    start, typ, active, count, mean, end = device_smooth(
        T(conf), T(pred), k1, kb, max_segments=4096, bug_compat=bug_compat)
    assert count == int(want[3]) <= 4096
    for got, ref in ((start, want[0]), (typ, want[1]), (active, want[2]),
                     (end, want[5])):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert mean.dtype == torch.float32
    np.testing.assert_array_equal(mean.numpy().view(np.int32),
                                  want[4].view(np.int32))


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_device_smooth_matches_host_glue(seed, bug_compat):
    """The JAX test's stress sweep (sizes, segment scales, thresholds)
    against the port's host loops: the same rows; the means within 1e-5
    relative."""
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(300, 6000))
    scale = int(rng.integers(5, 180))
    k1, kb = int(rng.integers(10, 150)), int(rng.integers(2, 40))
    scores = _random_scores(rng, n, segment_scale=scale)
    ref = _host_table(scores, k1, kb, bug_compat)
    conf, pred = _vectors(scores)
    start, typ, active, count, mean, end = device_smooth(
        conf, pred, k1, kb, max_segments=8192, bug_compat=bug_compat)
    act = active.numpy()
    np.testing.assert_array_equal(start.numpy()[act], ref["start_frames"])
    np.testing.assert_array_equal(typ.numpy()[act], ref["frame_types"])
    np.testing.assert_array_equal(end.numpy()[act], ref["end_frames"])
    np.testing.assert_allclose(mean.numpy()[act], ref["score_means"],
                               rtol=1e-5, atol=1e-5)


def test_device_smooth_single_segment():
    scores = np.zeros((400, 3), np.float32)
    scores[:, 0] = 4.0
    conf, pred = _vectors(scores)
    start, typ, active, count, mean, _ = device_smooth(conf, pred,
                                                       max_segments=64)
    act = active.numpy()
    assert count == 1 and act.sum() == 1
    assert start.numpy()[act][0] == 0 and typ.numpy()[act][0] == 0
    assert mean.numpy()[act][0] == 4.0


def test_device_smooth_all_orphans_stops():
    """One short segment of each class: every row is an orphan, and the
    loop stops with one row left (the host path's ``count > 1``)."""
    pred = np.repeat([0, 1, 2], 5).astype(np.int32)
    conf = np.linspace(1, 2, 15).astype(np.float32)
    te, count, loops = smooth_tables(conf, pred, 100, 10, max_segments=16)
    assert count == 3 and loops["glue"] == 2
    assert te["active"].sum().item() == 1
    want = [np.asarray(a) for a in jax_device_smooth(conf, pred, 100, 10,
                                                     max_segments=16)]
    np.testing.assert_array_equal(te["active"].numpy(), want[2])
    np.testing.assert_array_equal(te["start"].numpy(), want[0])


def test_smooth_logits_matches_host():
    scores = _random_scores(np.random.default_rng(9), 1500,
                            segment_scale=150)
    ref = _host_table(scores, 100, 10)
    start, typ = smooth_logits(T(scores))
    np.testing.assert_array_equal(start, ref["start_frames"])
    np.testing.assert_array_equal(typ, ref["frame_types"])


def test_smooth_logits_raises_on_overflow():
    scores = np.zeros((16, 3), np.float32)
    scores[np.arange(16), np.arange(16) % 2] = 1.0  # 16 segments
    with pytest.raises(ValueError, match="exceed max_segments=8"):
        smooth_logits(T(scores), max_segments=8)


def test_device_frame_scores_matches_host():
    scores = np.random.default_rng(6).normal(size=(300, 3)).astype(
        np.float32)
    scores[0] = [1.0, 1.0, 0.0]  # a tie goes to the first index
    conf, pred = device_frame_scores(T(scores))
    np.testing.assert_array_equal(conf.numpy(), scores.max(1))
    np.testing.assert_array_equal(pred.numpy(), scores.argmax(1))
    assert pred.dtype == torch.int32


def test_device_segment_reduce_matches_table():
    """The run-length table against the host table (means within 1e-6:
    the host's ``np.add.reduceat`` does not always add left to right),
    and its means bit for bit against a left-to-right f32 sum."""
    scores = _random_scores(np.random.default_rng(7), 700)
    seg = Segmentation(scores)
    conf, pred = _vectors(scores)
    nseg, starts, ends, types, lengths, means = device_segment_reduce(
        T(conf), T(pred), max_segments=1024)
    k = nseg
    assert k == len(seg) and starts.shape == (1024,)
    np.testing.assert_array_equal(starts[:k].numpy(), seg.te["start_frames"])
    np.testing.assert_array_equal(ends[:k].numpy(), seg.te["end_frames"])
    np.testing.assert_array_equal(types[:k].numpy(), seg.te["frame_types"])
    np.testing.assert_array_equal(lengths[:k].numpy(), seg.te["run_lengths"])
    assert lengths.dtype == torch.int64
    np.testing.assert_allclose(means[:k].numpy(), seg.te["score_means"],
                               rtol=1e-6, atol=1e-6)
    sums = [np.float32(0)] * k
    for i in range(k):  # left to right, in f32
        s = np.float32(0)
        for v in conf[seg.te["start_frames"][i]:seg.te["end_frames"][i] + 1]:
            s = np.float32(s + v)
        sums[i] = s / np.float32(seg.te["run_lengths"][i])
    np.testing.assert_array_equal(means[:k].numpy(),
                                  np.array(sums, np.float32))


def test_device_segment_reduce_overflow_raises():
    """The checked table raises on overflow; the unchecked one returns
    the count and the truncated rows (``tests/test_segmentation.py``'s
    case)."""
    pred = torch.arange(16, dtype=torch.int32) % 2
    conf = torch.ones(16)
    with pytest.raises(ValueError, match="overflow"):
        device_segment_reduce(conf, pred, max_segments=8)
    nseg, starts, *_ = device_segment_reduce_unchecked(conf, pred,
                                                       max_segments=8)
    assert nseg == 16 and starts.shape[0] == 8


def _f32_round(x: Fraction) -> np.float32:
    """The f32 nearest ``x``, ties to even, exactly."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    best = min(abs(Fraction(float(v)) - x) for v in cands)
    near = [v for v in cands if abs(Fraction(float(v)) - x) == best]
    return min(near, key=lambda v: int(np.array(v).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """``a * b + c`` rounded once to f32: on seeded triples, and on the
    case that a rounding through f64 gets wrong (``a * b`` exactly
    halfway between two f32 values and ``c`` too small for an f64 sum to
    keep)."""
    rng = np.random.default_rng(2)
    a = rng.uniform(-8, 8, 500).astype(np.float32)
    b = rng.integers(1, 5000, 500).astype(np.float32)
    c = (rng.normal(0, 1, 500) * 10.0 ** rng.integers(-12, 6, 500)).astype(
        np.float32)
    a = np.append(a, [3.0, 3.0]).astype(np.float32)
    b = np.append(b, [1 + 2.0 ** -23] * 2).astype(np.float32)
    c = np.append(c, [-(2.0 ** -60), 2.0 ** -60]).astype(np.float32)
    got = device_glue._fma32(T(a), T(b), T(c)).numpy()
    want = np.array([_f32_round(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-2] == np.float32(3 + 2.0 ** -22)
    assert got[-1] == np.float32(3 + 2.0 ** -21)


def test_maybe_trace_off_is_a_no_op(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(""):
        pass
    assert not os.listdir(tmp_path)


def test_maybe_trace_writes_a_trace(tmp_path):
    out = tmp_path / "trace"
    with profiling.maybe_trace(str(out)):
        torch.ones(64).sum().item()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    assert (out / files[0]).stat().st_size > 0


def test_profiler_that_fails_to_start_warns_and_the_run_goes_on(
        tmp_path, monkeypatch, caplog):
    """A profiler that raises at start logs a warning; the CLI's CSV is
    the reference's all the same and no trace is written."""
    import torch.profiler

    class Broken:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    out, trace = str(tmp_path / "out.csv"), tmp_path / "trace"
    with caplog.at_level(logging.WARNING):
        cli.main([os.path.join(GOLDEN, "clip.mp4"), "--cpu", "--transfer",
                  "bgr", "--output_path", out, "--print-every", "0",
                  "--profile", str(trace)])
    assert any("profiler unavailable" in r.message for r in caplog.records)
    with open(out, "rb") as f, open(os.path.join(GOLDEN,
                                                 "ref_segments.csv"),
                                    "rb") as g:
        assert f.read() == g.read()
    assert not trace.exists() or not os.listdir(trace)
