"""The port's batch path: ``pipeline.segment_many``, the decode-ahead
handle (``start_decode_ahead`` / ``PreloadedDecode``, taken by
``classify_video(preloaded=...)``) and ``cli/segment_videos.py``, held to
the JAX package's ``segment_many`` and the golden CSVs at float32 /
``transfer="bgr"``, byte for byte.  A decode-ahead handle is closed on
every path (its ``on_close`` fires once), and the batch CLI refuses the
unported ``--data-parallel`` and ``--multi-host`` at parse time.
"""

import os
import shutil

import pytest
import torch

from cut_detection_tpu.pipeline import segment_many as jax_segment_many
from cut_detection_tpu_torch import pipeline
from cut_detection_tpu_torch.cli import segment_videos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CPU = torch.device("cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_csv(synthetic_video, tmp_path_factory):
    """The JAX ``segment_many``'s CSV bytes of the synthetic clip."""
    out = str(tmp_path_factory.mktemp("jax") / "jax.csv")
    (_, _, _), = jax_segment_many([synthetic_video], [out], print_every=0,
                                  transfer="bgr", decode_process=False)
    return _read(out)


@pytest.fixture
def clips(synthetic_video, jax_csv, tmp_path):
    """The two golden clips and the synthetic clip, copied side by side
    (the CSVs are written next to them), and each one's expected CSV:
    the golden reference's, and the JAX ``segment_many``'s for the
    synthetic clip."""
    paths = [shutil.copy(os.path.join(GOLDEN, c), str(tmp_path / c))
             for c in ("clip.mp4", "clip_odd.mp4")]
    paths.append(shutil.copy(synthetic_video, str(tmp_path / "synth.mp4")))
    want = [_read(os.path.join(GOLDEN, r))
            for r in ("ref_segments.csv", "ref_segments_odd.csv")]
    return paths, want + [jax_csv]


@pytest.fixture
def handles(monkeypatch):
    """Every decode-ahead handle started, with a count of its closes."""
    started = []
    real = pipeline.start_decode_ahead

    def spy(path, **kw):
        closes = []
        kw["on_close"] = lambda: closes.append(1)
        h = real(path, **kw)
        started.append((path, closes))
        return h

    monkeypatch.setattr(pipeline, "start_decode_ahead", spy)
    return started


@pytest.mark.parametrize("pipeline_decode", [True, False])
def test_segment_many_equals_the_references(clips, handles, tmp_path,
                                            pipeline_decode):
    """Three videos on one net: each CSV equals its reference; with
    decode-ahead, videos 2 and 3 decode ahead (one handle each, closed
    once), without it none does."""
    paths, want = clips
    outs = [str(tmp_path / f"o{i}.csv") for i in range(3)]
    results = pipeline.segment_many(paths, outs, device=CPU, print_every=0,
                                    transfer="bgr",
                                    pipeline_decode=pipeline_decode)
    assert [r[0] for r in results] == outs
    for out, w in zip(outs, want):
        assert _read(out) == w
    assert [p for p, _ in handles] == (paths[1:] if pipeline_decode else [])
    assert all(c == [1] for _, c in handles)
    assert [r[2].frames for r in results] == [220, 200, 240]


def test_segment_many_decodes_ahead_only_on_the_host_resize_bgr_path(
        clips, handles):
    """``transfer="auto"`` resolves once (bgr on the CPU) and decodes
    ahead; an on-device resize needs raw frames, so nothing decodes
    ahead there, and its CSVs keep the reference's bytes."""
    paths, want = clips
    pipeline.segment_many(paths[:2], device=CPU, print_every=0,
                          device_resize=True)
    assert handles == []
    assert _read(paths[0][:-4] + "_segments.csv") == want[0]
    pipeline.segment_many(paths[:2], device=CPU, print_every=0)
    assert [p for p, _ in handles] == paths[1:2]


def test_segment_many_closes_the_handles_on_error(clips, handles):
    """A missing video stops the batch with the reference's error, and
    the handle already started for the next video is closed."""
    paths, _ = clips
    with pytest.raises(ValueError, match="does not exist"):
        pipeline.segment_many([paths[0], "/no/such.mp4", paths[1]],
                              device=CPU, print_every=0)
    assert [p for p, _ in handles] == [paths[1]]
    assert handles[0][1] == [1]
    with pytest.raises(ValueError, match="must match"):
        pipeline.segment_many(paths, ["a.csv"], device=CPU)
    with pytest.raises(ValueError, match="needs a net or a device"):
        pipeline.segment_many(paths)


def test_preloaded_handle_is_checked_and_closed(clips, tmp_path):
    """``classify_video`` refuses a handle built at another batch size,
    a bare (source, loader) pair, an on-device preprocess and yuv420,
    closing the handle each time; a score cache hit closes it too; a
    frame-limited run closes it at its early break."""
    path = clips[0][0]

    def handle(batch_size=32):
        closes = []
        h = pipeline.start_decode_ahead(path, batch_size=batch_size,
                                        on_close=lambda: closes.append(1))
        return h, closes

    for bad, kw, err in [
            (handle(64), {}, ValueError),
            (handle(), {"device_resize": True}, ValueError),
            (handle(), {"transfer": "yuv420"}, (ValueError, RuntimeError))]:
        (h, closes) = bad
        with pytest.raises(err):
            pipeline.classify_video(path, device=CPU, batch_size=32,
                                    print_every=0, preloaded=h, **kw)
        assert closes == [1]
    h, closes = handle()
    with pytest.raises(TypeError, match="PreloadedDecode"):
        pipeline.classify_video(path, device=CPU, batch_size=32,
                                preloaded=(h.source, h.loader))
    assert closes == [1]
    h, closes = handle()
    conf, pred, stats = pipeline.classify_video(
        path, device=CPU, batch_size=32, frame_limit=40, print_every=0,
        preloaded=h)
    assert closes == [1] and stats.frames == conf.shape[0] == 64
    cache = str(tmp_path / "scores.npz")
    pipeline.classify_video(path, device=CPU, batch_size=32, print_every=0,
                            cache_path=cache)
    h, closes = handle()
    conf2, _, _ = pipeline.classify_video(path, device=CPU, batch_size=32,
                                          cache_path=cache, preloaded=h)
    assert closes == [1] and conf2.shape[0] == 220
    h, closes = handle()
    with pytest.raises(ValueError, match="does not exist"):
        pipeline.segment_video_file("/no/such.mp4", device=CPU, preloaded=h)
    assert closes == [1]


def test_segment_videos_cli(clips):
    """The batch CLI on the three clips at ``--transfer bgr``: CSVs next
    to the inputs, each its reference's bytes."""
    paths, want = clips
    outs = segment_videos.main([*paths, "--cpu", "--transfer", "bgr"])
    assert outs == [p[:-4] + "_segments.csv" for p in paths]
    for out, w in zip(outs, want):
        assert _read(out) == w


@pytest.mark.parametrize("flags,message", [
    (["--data-parallel"], "--data-parallel: not yet ported"),
    (["--multi-host"], "--multi-host: not yet ported"),
    (["--data-parallel", "--multi-host"],
     "--data-parallel, --multi-host: not yet ported"),
    (["--transfer", "yuv420", "--device-resize"], "cannot combine"),
])
def test_segment_videos_refuses_at_parse_time(capsys, flags, message):
    with pytest.raises(SystemExit) as e:
        segment_videos.main(["a.mp4", "--cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert message in err
    if "ported" in message:
        assert "ROADMAP.md Queue 1 item 5" in err


def test_segment_videos_needs_a_device_unless_asked_for_the_cpu(
        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        segment_videos.main(["a.mp4"])
    assert "--cpu" in capsys.readouterr().err
